"""Coarse-scan entry-point seeding — a flat stand-in for HNSW's hierarchy.

CPU graph indexes reach the target neighborhood through upper hierarchy
levels (HNSW) or a fixed medoid walk (the reference, RoarGraph
src/index_bipartite.cpp:2322-2353). Here the same job is one tiled bf16
matmul scan over a strided sample of the base, returning per-query
seeds that land the beam inside the target neighborhood. At equal
recall the seeded walk needs far fewer hops than the medoid walk
(BASELINE.md records the recall); its time on H100 is not measured
here.

The sample holds ~1/r of each query's true top-k, so the scan alone is
no answer — the graph walk does the precision work; seeds only replace
the navigation prefix of the walk.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.ops.distances import Metric
from mysteryann_tpu.ops.knn import scan_min_k


def make_seed_sample(base_dev: jax.Array, rate: int
                     ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Strided 1-in-`rate` sample of the (metric-prepared, device-resident)
    base, kept in bf16: (sample [S, d] bf16, row norms [S] f32, ids [S])."""
    n = base_dev.shape[0]
    ids = np.arange(0, n, rate, dtype=np.int32)
    # strided slice: a contiguous copy, no index gather
    samp = jax.lax.slice(base_dev, (0, 0), (n, base_dev.shape[1]),
                         (rate, 1))
    return (samp.astype(jnp.bfloat16), jnp.sum(samp * samp, axis=1),
            jnp.asarray(ids))


@partial(jax.jit, static_argnames=("n_seeds", "metric", "tile"))
def seed_scan(samp, samp_sq, samp_ids, q, n_seeds: int, metric: Metric,
              tile: int = 131072):
    """Top-`n_seeds` sample members per query: (ids [B, S], dists [B, S]).

    Scans the sample in ``tile``-row blocks (`ops.knn.scan_min_k`), so
    the [B, tile] score block, not [B, S], bounds device memory."""
    metric = Metric.parse(metric)
    q_bf = q.astype(jnp.bfloat16)
    if metric == Metric.L2:
        q_sq = jnp.sum(q * q, axis=1, keepdims=True)

    def block(lo, size):
        ip = jnp.einsum("bd,sd->bs", q_bf,
                        jax.lax.dynamic_slice_in_dim(samp, lo, size, 0),
                        preferred_element_type=jnp.float32)
        if metric in (Metric.IP, Metric.COSINE):
            return -ip
        # clamp: the bf16 ip can push ||q-s||² ulp-negative for a query
        # equal to a sampled point
        return jnp.maximum(
            q_sq - 2.0 * ip
            + jax.lax.dynamic_slice_in_dim(samp_sq, lo, size, 0), 0.0)

    vals, idx = scan_min_k(block, samp.shape[0], n_seeds, tile, q.shape[0])
    # NOTE: vals carry bf16-matmul error. The fused engine ignores this
    # (its final f32 rerank rescores everything); the classic engine
    # passes seed_d=None so beam_search rescores seeds in f32.
    return jnp.take(samp_ids, idx), vals
