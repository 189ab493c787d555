"""mp-sharded IVF: cluster blocks row-sharded over the device mesh.

Past some hundreds of millions of rows even int8 cluster blocks exceed
one device's memory (100M x 128d s8 blocks ≈ 17 GB with capacity
padding — SURVEY §2's T2I-100M regime; the reference has no sharded story at all, its OMP
loops stop at one host). Sharding plan, scaling-book style:

- CLUSTER axis over ``mp``: each device owns nc/mp clusters' blocks +
  ids. Centroids are tiny and replicated, so every mp peer computes
  the SAME global top-``nprobe`` probe list; each keeps the probes it
  owns (off-shard probes map to the sentinel cluster and are dropped
  by `_ivf_group`), scans them with the unchanged single-chip
  cluster-major kernel, and merges its local candidates.
- One `all_gather` of [B, k] ids+scores per batch over ``mp`` (KBs)
  finishes the global top-k. Vectors never leave their shard.
- Queries shard over ``dp`` (pure throughput scaling, no comm).

int8 note: per-query scales make raw s32 scores comparable ACROSS
mp peers for the same query (one global base scale), so the gathered
merge needs no rescaling — the same invariant the single-chip grouped
scan relies on (ivf.py `_ivf_scan_grouped_i8`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mysteryann_tpu.ivf import (IVFIndex, _ivf_group, _ivf_merge,
                                _ivf_scan_grouped, _ivf_scan_grouped_i8)
from mysteryann_tpu.ops.knn import min_k
from mysteryann_tpu.ops.distances import (Metric, pairwise_dist,
                                          prepare_vectors)


class ShardedIVF:
    """Shard an `IVFIndex`'s cluster blocks over the mesh's ``mp`` axis.

    The cluster count is padded to a multiple of ``mp`` with empty
    clusters (zero blocks, sentinel ids, masked centroids) so every
    shard is identical in shape.
    """

    def __init__(self, mesh: Mesh, idx: IVFIndex):
        self.mesh = mesh
        self.metric = idx.metric
        self.store = idx.store
        self.gscale = idx.gscale
        self.n_base = idx.n_base
        self.cap = idx.cap
        self.dim = idx.dim
        mp = mesh.shape["mp"]
        nc = idx.n_clusters
        self.nc_real = nc
        pad = (-nc) % mp
        self.n_clusters = nc + pad
        blocks, bids, cents = idx.blocks, idx.block_ids, idx.centroids
        if pad:
            blocks = jnp.concatenate(
                [blocks, jnp.zeros((pad,) + blocks.shape[1:], blocks.dtype)])
            bids = jnp.concatenate(
                [bids, jnp.full((pad, self.cap), self.n_base, jnp.int32)])
            # padded centroids are masked in the probe selection, their
            # value never matters
            cents = jnp.concatenate(
                [cents, jnp.zeros((pad, self.dim), cents.dtype)])
        self.blocks = jax.device_put(
            blocks, NamedSharding(mesh, P("mp", None, None)))
        self.block_ids = jax.device_put(
            bids, NamedSharding(mesh, P("mp", None)))
        self.centroids = jax.device_put(cents, NamedSharding(mesh, P()))

    def search(self, queries, k: int, nprobe: int,
               device_out: bool = False):
        """Global top-k over all shards; queries shard over ``dp``."""
        if nprobe > self.nc_real:
            raise ValueError(f"nprobe {nprobe} > clusters {self.nc_real}")
        if not isinstance(queries, jax.Array):
            queries = jnp.asarray(np.asarray(queries, np.float32))
        queries = prepare_vectors(queries, self.metric)  # cosine: normalize
        B = queries.shape[0]
        dp = self.mesh.shape["dp"]
        if B % dp:
            raise ValueError(f"B ({B}) must divide dp ({dp})")
        q = jax.device_put(queries, NamedSharding(self.mesh, P("dp", None)))
        fn = _sharded_ivf_fn(self.mesh, k, nprobe, self.metric, self.store,
                             self.cap, self.dim, self.n_base,
                             self.nc_real, self.n_clusters, B // dp,
                             self.gscale)
        ids, vals = fn(q, self.centroids, self.blocks, self.block_ids)
        if device_out:
            return ids, vals
        return np.asarray(ids).astype(np.int32), np.asarray(vals)


def _sharded_ivf_fn(mesh, k, nprobe, metric, store, cap, dim, n_base,
                    nc_real, nc_pad, b_local, gscale):
    """Build the shard_map'd search fn (cached per static config)."""
    key = (mesh, k, nprobe, metric, store, cap, dim, n_base, nc_real,
           nc_pad, b_local, gscale)  # gscale is baked into the closure
    fn = _FN_CACHE.get(key)
    if fn is not None:
        return fn

    mp = mesh.shape["mp"]
    nc_local = nc_pad // mp
    # every probe picks one of the GLOBAL nc_pad clusters, so a local
    # cluster's expected load is b_local*nprobe/nc_pad (dividing by
    # nc_local would oversize qmax — and the grouped scan's matmul work —
    # by a factor of mp)
    avg_load = max(1, b_local * nprobe // max(1, nc_pad))
    qmax = 1 << int(np.ceil(np.log2(4 * avg_load)))  # see _search_grouped

    def local(q, cents, blocks_l, bids_l):
        # identical on every mp peer: global probe list over REAL clusters
        cd = pairwise_dist(q, cents, metric=metric)
        mask = jnp.arange(cd.shape[1]) >= nc_real
        cd = jnp.where(mask[None, :], jnp.inf, cd)
        _, top_c = min_k(cd, nprobe)
        # keep only probes this shard owns; others -> sentinel (dropped)
        lo = jax.lax.axis_index("mp").astype(jnp.int32) * nc_local
        in_shard = (top_c >= lo) & (top_c < lo + nc_local)
        tl = jnp.where(in_shard, top_c - lo, nc_local)
        qmap, slots, valid = _ivf_group(tl, nc_local, qmax)
        if store == "int8":
            qs = 127.0 / jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1e-30)
            q_i8 = jnp.clip(jnp.rint(q * qs[:, None]),
                            -127, 127).astype(jnp.int8)
            ci, cv = _ivf_scan_grouped_i8(q_i8, qmap, blocks_l, bids_l,
                                          k=k, cap=cap, dim=dim,
                                          n_base=n_base)
            ids, vals = _ivf_merge(ci, cv, slots, valid, k=k)
            vals = vals / (qs[:, None] * gscale)
        else:
            ci, cv = _ivf_scan_grouped(q, qmap, blocks_l, bids_l, k=k,
                                       metric=metric, cap=cap, dim=dim,
                                       n_base=n_base)
            ids, vals = _ivf_merge(ci, cv, slots, valid, k=k)
        # tiny cross-shard merge: [mp, Bl, k] ids+scores
        gi = jax.lax.all_gather(ids, "mp")
        gv = jax.lax.all_gather(vals, "mp")
        ci2 = jnp.moveaxis(gi, 0, 1).reshape(ids.shape[0], mp * k)
        cv2 = jnp.moveaxis(gv, 0, 1).reshape(ids.shape[0], mp * k)
        neg, pos = jax.lax.top_k(-cv2, k)
        return jnp.take_along_axis(ci2, pos, axis=1), -neg

    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("dp", None), P(), P("mp", None, None), P("mp", None)),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False))  # post-all_gather merge is mp-replicated
    _FN_CACHE[key] = fn
    return fn


_FN_CACHE: dict = {}
