"""mysteryann_tpu — a JAX cross-modal approximate nearest neighbor framework.

A ground-up JAX/XLA re-design of the capabilities of the reference
RoarGraph codebase (matchyc/mysteryann): building projected-bipartite-graph
indices from cross-modal data and serving high-recall top-k search.

Where the reference (C++/OpenMP/AVX-512, /root/reference) is single-node
pointer-chasing with per-node mutexes and one-query-at-a-time best-first
traversal, this framework is dense / batched / fixed-shape:

- distances are tiled matmuls (`mysteryann_tpu.ops.distances`),
- exact kNN is a sharded matmul + running top-k merge (`ops.knn`),
- the graph is a padded ``int32 [N, M]`` adjacency tensor in device memory
  (`graph.adjacency`),
- search is batched lockstep beam search with bitmask visited sets
  (`search.beam`),
- index construction (projection, occlusion pruning, reverse edges,
  connectivity enhancement) is batched prune scans + segmented scatter
  passes (`graph.roargraph`),
- multi-chip scaling is `jax.sharding` over a device mesh (`parallel`).
"""

__version__ = "0.1.0"

from mysteryann_tpu.utils.params import BuildConfig, SearchConfig, Parameters  # noqa: F401
from mysteryann_tpu.ops.distances import Metric  # noqa: F401
from mysteryann_tpu.index import index_kinds, get_index_cls, register_index  # noqa: F401
