"""Sharded exact kNN — the multi-device ground-truth / build-input kernel.

SURVEY §5 equivalence: the reference's exact Q→B kNN is computed *outside*
the repo on one CPU (DiskANN utils). Here it is a 2-D-sharded device
computation: queries sharded over ``dp``, base sharded over ``mp``; each
device computes its [Q_shard × B_shard] distance tiles and keeps a local
top-k; per-query candidates are all-gathered over ``mp`` and merged into
the global top-k. This is the brute-force kNN decomposition of PAPERS.md
laid over a mesh.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mysteryann_tpu.ops.distances import Metric
from mysteryann_tpu.ops.knn import exact_knn_device


def sharded_exact_knn(
    mesh: Mesh,
    queries: jax.Array,   # [Q, d] — will be sharded over "dp"
    base: jax.Array,      # [N, d] — will be sharded over "mp"
    k: int,
    metric: Metric = Metric.IP,
    tile: int = 8192,
    precision: str = "default",
) -> Tuple[jax.Array, jax.Array]:
    """Returns (dists [Q, k], ids [Q, k]) with global base ids."""
    metric = Metric.parse(metric)
    n = base.shape[0]
    mp = mesh.shape["mp"]
    if n % mp or queries.shape[0] % mesh.shape["dp"]:
        raise ValueError("dp must divide Q and mp must divide N "
                         f"(got Q={queries.shape[0]}, N={n}, mesh={dict(mesh.shape)})")
    shard_n = n // mp
    fn = _sharded_knn_fn(mesh, k, metric, tile, shard_n, precision)
    q = jax.device_put(queries, NamedSharding(mesh, P("dp", None)))
    b = jax.device_put(base, NamedSharding(mesh, P("mp", None)))
    return fn(q, b)


@functools.lru_cache(maxsize=64)
def _sharded_knn_fn(mesh: Mesh, k: int, metric: Metric, tile: int,
                    shard_n: int, precision: str):
    """Compiled shard_map'd kNN, cached per static config — callers loop
    over many same-shape chunks (e.g. the phase-E stranded-node repair)
    and must not re-trace every call."""

    def local(q_shard, b_shard):
        # local top-k against this device's base shard
        d_loc, i_loc = exact_knn_device(
            q_shard, b_shard, k=min(k, shard_n), metric=metric,
            tile=min(tile, shard_n), precision=precision)
        my = jax.lax.axis_index("mp")
        i_loc = i_loc + my * shard_n               # globalize ids
        # gather all shards' candidates and merge
        d_all = jax.lax.all_gather(d_loc, "mp", axis=1, tiled=True)
        i_all = jax.lax.all_gather(i_loc, "mp", axis=1, tiled=True)
        neg, pos = jax.lax.top_k(-d_all, k)
        return -neg, jnp.take_along_axis(i_all, pos, axis=1)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("dp", None), P("mp", None)),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False,
    ))
