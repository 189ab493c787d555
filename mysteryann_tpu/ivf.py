"""IVF (inverted-file) index — sublinear exact-distance search.

The middle ground between the flat scan (`flat.py`, O(N) per query) and
the graph engine (`graph/`, O(log N) hops of random row gathers):
partition the corpus with k-means, store each cluster's vectors
CONTIGUOUSLY, and per query scan only the top-`nprobe` clusters. Cluster
blocks are whole rows of a [nc, cap, d] table (hundreds of KB each), so
the gather is bulk, and the per-cluster distance computation is one
batched matmul — the ScaNN/SOAR decomposition (PAPERS.md) without the
quantization stage (distances stay exact f32; selection is exact).

Capability note: the reference has no IVF; this is surface area beyond
it. The recall records at 10M and 50M are in BASELINE.md (at 50M IVF
reached recall .69-.83 only). Its speed against flat and graph serving
on H100 is not measured; until it is, flat (corpus fits device memory)
and the seeded fused graph are the recommended modes.

Build: Lloyd iterations fully on device (assignment = tiled matmul
argmin; update = segment means), then a capacity-bounded reassignment so
the padded [nc, cap, d] layout wastes bounded HBM (overflow points move
to their next-nearest cluster with room).
"""

from __future__ import annotations

import sys
import time
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.ops.distances import Metric, pairwise_dist, prepare_vectors
from mysteryann_tpu.ops.knn import min_k
from mysteryann_tpu.index import register_index


@partial(jax.jit, static_argnames=("metric",))
def _assign(x, centroids, metric):
    d = pairwise_dist(x, centroids, metric=metric)
    return jnp.argmin(d, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("nprobe", "metric"))
def _ivf_topc(q, centroids, nprobe: int, metric: Metric):
    cd = pairwise_dist(q, centroids, metric=metric)
    _, top_c = min_k(cd, nprobe)
    return top_c


@partial(jax.jit, static_argnames=("nc", "qmax"))
def _ivf_group(top_c, nc: int, qmax: int):
    """Cluster-major query map ON DEVICE: top_c [B, p] -> (qmap [nc, qmax],
    slots [B, p, 2], valid [B, p]).

    The host version of this grouping (argsort + bincount) cost a
    ~20 MB/batch host round trip. Same semantics: probes beyond a cluster's qmax slot budget are
    dropped (valid=False, masked at the merge). Entries with
    ``top_c >= nc`` are dropped too — the mp-sharded search maps
    off-shard probes to the sentinel ``nc`` (parallel/sharded_ivf.py).
    """
    B, p = top_c.shape
    flat_c = top_c.reshape(-1)
    arrival = jnp.arange(B * p, dtype=jnp.int32)          # q-major order
    cs, ar = jax.lax.sort((flat_c, arrival), dimension=-1, num_keys=2)
    is_start = jnp.concatenate([jnp.ones((1,), jnp.bool_), cs[1:] != cs[:-1]])
    pos = jnp.arange(B * p, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
    rank = pos - seg_start
    keep = (rank < qmax) & (cs < nc)
    qs = ar // p
    qmap = jnp.full((nc, qmax), B, jnp.int32)
    qmap = qmap.at[jnp.where(keep, cs, nc),   # nc = out of bounds -> drop
                   jnp.where(keep, rank, 0)].set(
        jnp.where(keep, qs, B), mode="drop")
    # scatter (cluster, rank) back to (query, probe) order via arrival
    slots = jnp.zeros((B * p, 2), jnp.int32)
    slots = slots.at[ar, 0].set(jnp.where(keep, cs, 0))
    slots = slots.at[ar, 1].set(jnp.where(keep, rank, 0))
    valid = jnp.zeros((B * p,), jnp.bool_).at[ar].set(keep)
    return qmap, slots.reshape(B, p, 2), valid.reshape(B, p)


def _grouped_scan_core(q, qmap, blocks, block_ids, k: int, cap: int,
                       n_base: int, dist_fn):
    """Shared chunked cluster-major scan (see the public wrappers below).

    Scans CHUNKS of clusters; each step fetches its chunk's blocks with
    one row gather (`jnp.take`) and runs ONE batched matmul over every
    (cluster, probe-slot) pair in the chunk. Whether XLA keeps the
    gathered table in place inside the loop at 50M (an earlier
    scan-xs design made it copy the FULL table into the loop buffer) is
    not checked on H100 (ROADMAP S3).
    """

    B, qmax = q.shape[0], qmap.shape[1]
    nc = blocks.shape[0]
    kk = min(k, cap)
    # chunk size: bound the [C, qmax, cap] s32 score block to ~150-300 MB
    C = max(1, min(nc, 64, 8192 // max(1, qmax)))
    ncp = -(-nc // C) * C
    cidx = jnp.minimum(jnp.arange(ncp, dtype=jnp.int32),
                       nc - 1).reshape(-1, C)

    def step(_, cs):                                     # cs [C]
        blk = jnp.take(blocks, cs, axis=0)               # [C, cap, d]
        bids = jnp.take(block_ids, cs, axis=0)           # [C, cap]
        qrow = jnp.take(qmap, cs, axis=0)                # [C, qmax]
        qv = jnp.take(q, jnp.minimum(qrow, B - 1).reshape(-1),
                      axis=0).reshape(C, qmax, -1)       # [C, qmax, d]
        dist = dist_fn(qv, blk)                          # [C, qmax, cap]
        dist = jnp.where(bids[:, None, :] < n_base, dist, jnp.inf)
        vals, pos = min_k(dist.reshape(C * qmax, cap), kk)
        bexp = jnp.broadcast_to(bids[:, None, :], (C, qmax, cap))
        ids = jnp.take_along_axis(bexp.reshape(C * qmax, cap), pos, axis=1)
        return None, (ids.reshape(C, qmax, kk), vals.reshape(C, qmax, kk))

    _, (ids, vals) = jax.lax.scan(step, None, cidx)
    ids = ids.reshape(ncp, qmax, kk)[:nc]
    vals = vals.reshape(ncp, qmax, kk)[:nc]
    if k > cap:  # degenerate tiny clusters
        padw = k - cap
        vals = jnp.pad(vals, ((0, 0), (0, 0), (0, padw)),
                       constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, 0), (0, padw)),
                      constant_values=n_base)
    return ids, vals                                     # [nc, Qmax, k]


@partial(jax.jit, static_argnames=("k", "metric", "cap", "dim", "n_base"))
def _ivf_scan_grouped(q, qmap, blocks, block_ids, k: int, metric: Metric,
                      cap: int, dim: int, n_base: int):
    """Cluster-major scan: batched matmuls over the queries that
    probe each cluster (`qmap` [nc, Qmax], sentinel = B). Work is
    compute-shared — no per-query private gathers; each cluster block is
    read once per batch. Returns per-(cluster, slot) candidates:
    ids/dists [nc, Qmax, k]."""
    def dist_fn(qv, blk):
        ip = jax.lax.dot_general(qv, blk, (((2,), (2,)), ((0,), (0,))),
                                 preferred_element_type=jnp.float32)
        if metric in (Metric.IP, Metric.COSINE):
            return -ip
        qn = jnp.sum(qv * qv, axis=2, keepdims=True)
        bn = jnp.sum(blk * blk, axis=2)
        return qn - 2.0 * ip + bn[:, None, :]

    return _grouped_scan_core(q, qmap, blocks, block_ids, k, cap, n_base,
                              dist_fn)


@partial(jax.jit, static_argnames=("k", "cap", "dim", "n_base"))
def _ivf_scan_grouped_i8(q_i8, qmap, blocks, block_ids, k: int,
                         cap: int, dim: int, n_base: int):
    """int8 twin of `_ivf_scan_grouped` (IP/cosine only): one global base
    scale + per-row query scales keep raw s8xs8->s32 scores
    order-preserving per query, so ranking needs no dequantization. The
    returned "distances" are raw -s32 in each query's own scale — valid
    for per-query merging, NOT comparable across queries; callers rerank
    (or rescale by q_scale * g_scale) for reportable distances."""
    def dist_fn(qv, blk):
        s32 = jax.lax.dot_general(qv, blk, (((2,), (2,)), ((0,), (0,))),
                                  preferred_element_type=jnp.int32)
        return -s32.astype(jnp.float32)

    return _grouped_scan_core(q_i8, qmap, blocks, block_ids, k, cap,
                              n_base, dist_fn)


@partial(jax.jit, static_argnames=("k",))
def _ivf_merge(cand_ids, cand_d, slots, valid, k: int):
    """Per-query merge: gather each query's p×k candidates and top-k.

    `slots` [B, p, 2] = (cluster, slot-within-cluster) of the query's
    probes in the scan output; `valid` [B, p] masks dropped probes.
    """
    B = slots.shape[0]
    ci = cand_ids[slots[:, :, 0], slots[:, :, 1]]          # [B, p, k]
    cd = cand_d[slots[:, :, 0], slots[:, :, 1]]
    cd = jnp.where(valid[:, :, None], cd, jnp.inf)
    ci = ci.reshape(B, -1)
    cd = cd.reshape(B, -1)
    neg, pos = jax.lax.top_k(-cd, k)
    return jnp.take_along_axis(ci, pos, axis=1), -neg


@partial(jax.jit, static_argnames=("k", "metric", "n_base"))
def _ivf_rerank(q, ids, vals, base_f32, k: int, metric: Metric, n_base: int):
    """Exact-f32 rerank of merged candidates: gather each candidate's
    f32 row and recompute the true distance (invalid slots keep inf)."""
    rows = jnp.take(base_f32, jnp.minimum(ids, n_base - 1), axis=0)
    ip = jnp.einsum("bd,brd->br", q, rows,
                    preferred_element_type=jnp.float32)
    if metric in (Metric.IP, Metric.COSINE):
        dist = -ip
    else:
        qn = jnp.sum(q * q, axis=1, keepdims=True)
        bn = jnp.sum(rows * rows, axis=2)
        dist = qn - 2.0 * ip + bn
    dist = jnp.where(jnp.isfinite(vals), dist, jnp.inf)
    neg, pos = jax.lax.top_k(-dist, k)
    return jnp.take_along_axis(ids, pos, axis=1), -neg


@partial(jax.jit,
         static_argnames=("k", "nprobe", "metric", "cap", "dim", "n_base"))
def _ivf_search(q, centroids, blocks, block_ids, k: int, nprobe: int,
                metric: Metric, cap: int, dim: int, n_base: int):
    """Top-`nprobe` cluster scan. Arrays are jit ARGUMENTS — closing over
    the block tensor would bake ~GBs of constants into the HLO."""
    B = q.shape[0]
    cd = pairwise_dist(q, centroids, metric=metric)
    _, top_c = min_k(cd, nprobe)                            # [B, p]

    def probe(carry, j):
        best_d, best_i = carry
        cid = top_c[:, j]                                   # [B]
        block = jnp.take(blocks, cid, axis=0)               # [B, cap, dim]
        bids = jnp.take(block_ids, cid, axis=0)             # [B, cap]
        ip = jnp.einsum("bd,bcd->bc", q, block,
                        preferred_element_type=jnp.float32)
        if metric in (Metric.IP, Metric.COSINE):
            dist = -ip
        else:
            qn = jnp.sum(q * q, axis=1, keepdims=True)
            bn = jnp.sum(block * block, axis=2)
            dist = qn - 2.0 * ip + bn
        dist = jnp.where(bids < n_base, dist, jnp.inf)
        cat_d = jnp.concatenate([best_d, dist], axis=1)
        cat_i = jnp.concatenate([best_i, bids], axis=1)
        neg, pos = jax.lax.top_k(-cat_d, k)
        return (-neg, jnp.take_along_axis(cat_i, pos, axis=1)), None

    init = (jnp.full((B, k), jnp.inf, jnp.float32),
            jnp.full((B, k), n_base, jnp.int32))
    (bd, bi), _ = jax.lax.scan(probe, init,
                               jnp.arange(nprobe, dtype=jnp.int32))
    return bi, bd


def _capacity_place(cand: np.ndarray, nc: int, cap: int):
    """Capacity-bounded greedy placement on the host.

    `cand` [N, kk] ranks each point's nearest clusters; points go to
    their best-ranked cluster with room (vectorized pass per rank),
    leftovers spill into any cluster with room (cap grows if ALL are
    full). Returns (slot_cluster [N], slot_pos [N], tight cap).
    """
    n, kk = cand.shape
    fill = np.zeros(nc, np.int64)
    slot_cluster = np.full(n, -1, np.int32)
    slot_pos = np.zeros(n, np.int64)
    unplaced = np.arange(n)
    for j in range(kk):  # vectorized greedy pass per candidate rank
        if unplaced.size == 0:
            break
        c = cand[unplaced, j].astype(np.int64)
        order = np.argsort(c, kind="stable")
        cs, us = c[order], unplaced[order]
        offs = np.zeros(nc + 1, np.int64)
        np.cumsum(np.bincount(cs, minlength=nc), out=offs[1:])
        rank = np.arange(cs.size) - offs[cs]
        accept = rank < (cap - fill[cs])
        slot_cluster[us[accept]] = cs[accept].astype(np.int32)
        slot_pos[us[accept]] = fill[cs[accept]] + rank[accept]
        np.add.at(fill, cs[accept], 1)
        unplaced = us[~accept]
    if unplaced.size:  # spill leftovers into clusters with room
        room = cap - fill
        free_cluster = np.repeat(np.arange(nc), room)
        if free_cluster.size < unplaced.size:  # grow cap as needed
            extra = unplaced.size - free_cluster.size
            grow = -(-extra // nc)
            cap += grow
            free_cluster = np.concatenate(
                [free_cluster, np.tile(np.arange(nc), grow)])
        take = free_cluster[: unplaced.size]
        order = np.argsort(take, kind="stable")
        ts, us = take[order], unplaced[order]
        offs = np.zeros(nc + 1, np.int64)
        np.cumsum(np.bincount(ts, minlength=nc), out=offs[1:])
        rank = np.arange(ts.size) - offs[ts]
        slot_cluster[us] = ts.astype(np.int32)
        slot_pos[us] = fill[ts] + rank
        np.add.at(fill, ts, 1)
    return slot_cluster, slot_pos, int(fill.max())


def _kmeans(x_dev, n_clusters: int, metric: Metric, iters: int,
            seed: int, chunk: int = 131072) -> np.ndarray:
    n, d = x_dev.shape
    rng = np.random.default_rng(seed)
    centroids = np.array(x_dev[rng.choice(n, n_clusters, replace=False)],
                         copy=True)
    @partial(jax.jit, static_argnames=("nc",), donate_argnums=(2, 3))
    def _accum(x, assign, sums, counts, nc):
        # accumulate ON DEVICE: one download per iter instead of
        # ~7 MB of partial sums per chunk
        sums = sums + jax.ops.segment_sum(x, assign, num_segments=nc)
        counts = counts + jax.ops.segment_sum(
            jnp.ones((x.shape[0],), jnp.float32), assign, num_segments=nc)
        return sums, counts

    for _ in range(iters):
        c_dev = jnp.asarray(centroids)
        sums_d = jnp.zeros((n_clusters, d), jnp.float32)
        counts_d = jnp.zeros((n_clusters,), jnp.float32)
        for ci, s in enumerate(range(0, n, chunk)):
            e = min(s + chunk, n)
            a = _assign(x_dev[s:e], c_dev, metric)
            sums_d, counts_d = _accum(x_dev[s:e], a, sums_d, counts_d,
                                      n_clusters)
            # sync per chunk: each materializes a [chunk, nc] distance
            # block (7.4 GB at nc=14k); two queued chunks need twice that
            jax.block_until_ready(counts_d)
        sums = np.asarray(sums_d, np.float64)
        counts = np.asarray(counts_d, np.float64)
        nonempty = counts > 0
        centroids[nonempty] = (sums[nonempty]
                               / counts[nonempty, None]).astype(np.float32)
        # respawn empty clusters on random points
        n_empty = int((~nonempty).sum())
        if n_empty:
            centroids[~nonempty] = np.asarray(
                x_dev[rng.choice(n, n_empty, replace=False)])
    return centroids


@register_index("ivf")
class IVFIndex:
    """IVF over contiguous cluster blocks; optional int8 storage.

    ``store="int8"`` (IP/cosine only) quantizes cluster blocks to int8
    with ONE global symmetric scale; queries get per-row scales at
    search time, so the raw s8xs8->s32 scores are order-preserving per
    query and ranking needs no dequantization (merged distances are
    rescaled once for reporting). This quarters the resident set —
    the regime that matters: a 50M x 128d corpus is 25.6 GB in f32
    (cannot fit a 16 GB chip even as a flat scan) but 6.4 GB in int8
    cluster blocks. ``keep_f32=True`` (fits-in-HBM scales only)
    retains the f32 rows for exact rerank of the merged top
    candidates (``search(..., rerank=R)``).
    """

    def __init__(self, base: np.ndarray, metric: Metric | str = Metric.IP,
                 n_clusters: int = 0, cap_factor: float = 1.6,
                 kmeans_iters: int = 10, seed: int = 0, verbose: bool = False,
                 store: str = "f32", keep_f32: bool = False):
        self.metric = Metric.parse(metric)
        base_dev = prepare_vectors(np.asarray(base, np.float32), self.metric)
        n, dim = base_dev.shape
        nc = n_clusters or max(16, int(np.sqrt(n) * 2))
        t0 = time.perf_counter()
        centroids = _kmeans(base_dev, nc, self.metric, kmeans_iters, seed)
        cap = int(np.ceil(n / nc * cap_factor))

        # capacity-bounded assignment: overflow moves to next-nearest
        # cluster with room (ranked device pass, resolved on host)
        kk = min(8, nc)
        from mysteryann_tpu.ops.knn import exact_knn_device
        cand = np.empty((n, kk), np.int32)
        c_dev = jnp.asarray(centroids)
        for s in range(0, n, 131072):
            e = min(s + 131072, n)
            _, ii = exact_knn_device(base_dev[s:e], c_dev, k=kk,
                                     metric=self.metric, tile=nc)
            cand[s:e] = np.asarray(ii)
        slot_cluster, slot_pos, cap = _capacity_place(cand, nc, cap)
        cap = -(-cap // 32) * 32  # round rows to a multiple of 32

        base_np = np.asarray(base_dev)
        blocks = np.zeros((nc, cap, dim), np.float32)
        ids = np.full((nc, cap), n, np.int32)
        blocks[slot_cluster, slot_pos] = base_np
        ids[slot_cluster, slot_pos] = np.arange(n, dtype=np.int32)

        self.n_base = n
        self.n_clusters = nc
        self.cap = cap
        self.centroids = jnp.asarray(centroids)
        self.store = store
        if store == "int8":
            if self.metric not in (Metric.IP, Metric.COSINE):
                raise ValueError("store='int8' supports IP/cosine only")
            self.gscale = float(127.0 / max(np.abs(blocks).max(), 1e-30))
            self.blocks = jnp.asarray(
                np.clip(np.rint(blocks * self.gscale), -127, 127)
                .astype(np.int8))
        elif store == "f32":
            self.gscale = 1.0
            self.blocks = jnp.asarray(blocks)
        else:
            raise ValueError(f"unknown store={store!r}")
        self.block_ids = jnp.asarray(ids)
        self.base_f32 = jnp.asarray(base_np) if keep_f32 else None
        self.dim = dim
        if verbose:
            print(f"IVF: {nc} clusters cap {cap} "
                  f"(waste {nc * cap / n:.2f}x, store {store}) built in "
                  f"{time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)

    @classmethod
    def from_parts(cls, centroids, blocks, block_ids, n_base: int,
                   metric: Metric | str = Metric.IP, gscale: float = 1.0):
        """Assemble an index from device-resident parts.

        The 50M-scale path: the corpus never exists as one host array —
        shards are generated/loaded, assigned, quantized, and scattered
        into `blocks` ON DEVICE (scripts/bench_50m.py), then handed
        here. `blocks` is [nc, cap, dim] (int8 or f32), `block_ids`
        [nc, cap] with sentinel >= n_base in padding slots, `gscale`
        the global quantization scale (int8 blocks = gscale * f32 rows).
        """
        self = cls.__new__(cls)
        self.metric = Metric.parse(metric)
        blocks = jnp.asarray(blocks)
        block_ids = jnp.asarray(block_ids)
        nc, cap, dim = blocks.shape
        assert dim == centroids.shape[1]
        self.n_base = int(n_base)
        self.n_clusters = nc
        self.cap = cap
        self.centroids = jnp.asarray(centroids)
        self.store = "int8" if blocks.dtype == jnp.int8 else "f32"
        if self.store == "int8" and self.metric not in (Metric.IP,
                                                        Metric.COSINE):
            raise ValueError("store='int8' supports IP/cosine only")
        self.gscale = float(gscale)
        self.blocks = blocks
        self.block_ids = block_ids
        self.base_f32 = None
        self.dim = dim
        return self

    def save(self, path: str) -> None:
        """Persist the index (uncompressed npz: centroids, blocks,
        block_ids, scalars). Unlike the graph formats (byte-identical to
        the reference's, `graph/roargraph.py`), IVF is surface beyond the
        reference, so the container is our own. The block table is
        downloaded from device — on a production host that is a PCIe
        copy; `keep_f32` rerank rows are NOT persisted (they are the
        corpus itself — reattach via ``load(..., base=...)``)."""
        np.savez(path,
                 version=np.int32(1),
                 centroids=np.asarray(self.centroids),
                 blocks=np.asarray(self.blocks),
                 block_ids=np.asarray(self.block_ids),
                 n_base=np.int64(self.n_base),
                 metric=np.bytes_(self.metric.name.encode()),
                 gscale=np.float64(self.gscale))

    @classmethod
    def load(cls, path: str, base: np.ndarray | None = None) -> "IVFIndex":
        """Load a saved index; optional `base` re-enables exact-f32
        rerank (``search(..., rerank=R)``)."""
        with np.load(path) as z:
            if int(z["version"]) != 1:
                raise ValueError(f"unknown IVF index version {z['version']}")
            metric = Metric.parse(bytes(z["metric"]).decode().lower())
            self = cls.from_parts(
                jnp.asarray(z["centroids"]), z["blocks"], z["block_ids"],
                n_base=int(z["n_base"]), metric=metric,
                gscale=float(z["gscale"]))
        if base is not None:
            self.base_f32 = jnp.asarray(
                prepare_vectors(np.asarray(base, np.float32), self.metric))
        return self

    def _search_device(self, q, k: int, nprobe: int):
        return _ivf_search(q, self.centroids, self.blocks, self.block_ids,
                           k=k, nprobe=nprobe, metric=self.metric,
                           cap=self.cap, dim=self.dim, n_base=self.n_base)

    def _search_grouped(self, q, k: int, nprobe: int, rerank: int = 0,
                        slot_budget: int = 4):
        """Cluster-major (query-grouped) probe — the compute-shared path.

        The cluster→queries map (`qmap`, width bucketed to a power of
        two for compile reuse) is built ON DEVICE (`_ivf_group`) —
        the earlier host version cost a ~20 MB/batch round trip. Probes beyond a cluster's slot budget
        are dropped (masked at the merge). ``slot_budget`` multiplies
        the average per-cluster load into the padded slot width: scan
        compute is PROPORTIONAL to it, while the drop tail shrinks
        with it (50M, nprobe=64, budget 4: drops cost ~0.3pt recall vs
        budget 8 at ~2x the QPS).
        """
        B = q.shape[0]
        avg_load = max(1, B * nprobe // self.n_clusters)
        qmax = 1 << int(np.ceil(np.log2(slot_budget * avg_load)))
        top_c = _ivf_topc(q, self.centroids, nprobe, self.metric)
        qmap, slots, valid = _ivf_group(top_c, self.n_clusters, qmax)
        kk = max(k, rerank)
        if self.store == "int8":
            qs = 127.0 / jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1e-30)
            q_i8 = jnp.clip(jnp.rint(q * qs[:, None]),
                            -127, 127).astype(jnp.int8)
            cand_ids, cand_d = _ivf_scan_grouped_i8(
                q_i8, qmap, self.blocks, self.block_ids, k=kk,
                cap=self.cap, dim=self.dim, n_base=self.n_base)
            ids, vals = _ivf_merge(cand_ids, cand_d, slots, valid, k=kk)
            # raw -s32 -> approximate f32 -IP for reporting
            vals = vals / (qs[:, None] * self.gscale)
        else:
            cand_ids, cand_d = _ivf_scan_grouped(
                q, qmap, self.blocks, self.block_ids, k=kk,
                metric=self.metric, cap=self.cap, dim=self.dim,
                n_base=self.n_base)
            ids, vals = _ivf_merge(cand_ids, cand_d, slots, valid, k=kk)
        if rerank:
            if self.base_f32 is None:
                raise ValueError("rerank needs keep_f32=True at build")
            ids, vals = _ivf_rerank(q, ids, vals, self.base_f32, k=k,
                                    metric=self.metric,
                                    n_base=self.n_base)
        elif kk != k:
            ids, vals = ids[:, :k], vals[:, :k]
        return ids, vals

    def search(self, queries: np.ndarray, k: int, nprobe: int = 16,
               query_batch: int = 2048, grouped: bool = True,
               device_out: bool = False, rerank: int = 0,
               ) -> Tuple[np.ndarray, np.ndarray]:
        if not isinstance(queries, jax.Array):
            queries = np.asarray(queries, np.float32)
        q = prepare_vectors(queries, self.metric)
        nq, d = q.shape
        qb = min(query_batch, nq)
        pad = (-nq) % qb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, d), jnp.float32)])
        if self.store == "int8" and not grouped:
            raise ValueError("store='int8' serves via the grouped path")
        if grouped:
            impl = partial(self._search_grouped, rerank=rerank)
        else:
            impl = self._search_device
        outs = []
        for s in range(0, nq + pad, qb):
            outs.append(impl(jax.lax.dynamic_slice_in_dim(q, s, qb),
                             k, nprobe))
        if device_out:
            if len(outs) == 1:
                return outs[0][0][:nq], outs[0][1][:nq]
            return (jnp.concatenate([o[0] for o in outs])[:nq],
                    jnp.concatenate([o[1] for o in outs])[:nq])
        ids = np.concatenate([np.asarray(o[0]) for o in outs])[:nq]
        dists = np.concatenate([np.asarray(o[1]) for o in outs])[:nq]
        return ids.astype(np.int32), dists

    def free(self):
        """Release device buffers (the 50M-scale scripts build several
        near-HBM-sized structures sequentially)."""
        for name in ("blocks", "block_ids", "centroids", "base_f32"):
            buf = getattr(self, name, None)
            if isinstance(buf, jax.Array):
                buf.delete()
            setattr(self, name, None)

    def benchmark(self, queries: np.ndarray, k: int, nprobe: int = 16,
                  query_batch: int = 2048, warmup: int = 1,
                  rerank: int = 0) -> dict:
        # device-timed like FlatIndex.benchmark: the final result
        # download stays out of the timed region; the probe-map grouping
        # is on-device, so the timed region is pure device work.
        q = prepare_vectors(np.asarray(queries, np.float32), self.metric)
        qb = min(query_batch, q.shape[0])
        for _ in range(warmup):  # the timed call itself (see FlatIndex)
            jax.block_until_ready(self.search(
                q, k, nprobe=nprobe, query_batch=qb, device_out=True,
                rerank=rerank))
        t0 = time.perf_counter()
        out = self.search(q, k, nprobe=nprobe, query_batch=qb,
                          device_out=True, rerank=rerank)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        ids, dists = (np.asarray(o) for o in out)
        ids = ids.astype(np.int32)
        return {
            "qps": q.shape[0] / dt,
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "avg_cmps": float(nprobe * self.cap + self.n_clusters),
            "avg_hops": float(nprobe),
            "nprobe": nprobe,
            "ids": ids, "dists": dists,
        }

@partial(jax.jit, donate_argnums=(0,))
def _quantize_scatter(tbl, cl, pos, rows, gscale):
    # fused quantize + row-granular scatter into the 3D block table.
    # Donated and unique-indexed, but XLA may still lower this scatter
    # with a full-table HLO temp (an earlier backend did: 7.75G temp next
    # to the 8.3G argument at 50M) — so this path is only for tables
    # under half of device memory; the 50M regime uses the stripe fill.
    q8 = jnp.clip(jnp.rint(rows * gscale), -127, 127).astype(jnp.int8)
    return tbl.at[cl, pos].set(q8, mode="drop", unique_indices=True)


@partial(jax.jit, donate_argnums=(0,), static_argnames=("cs", "cap", "dim"))
def _quantize_stripe(tbl, rows, gscale, c0, cs: int, cap: int, dim: int):
    # quantize a stripe of `cs` whole clusters and store it with a
    # dynamic-update-slice: XLA updates the donated table IN PLACE (no
    # full-table temp, unlike scatter — see _quantize_scatter)
    q8 = jnp.clip(jnp.rint(rows * gscale), -127, 127).astype(jnp.int8)
    return jax.lax.dynamic_update_slice_in_dim(
        tbl, q8.reshape(cs, cap, dim), c0, axis=0)


def build_ivf_streaming(tile_fn, n: int, dim: int, *,
                        metric: Metric | str = Metric.IP,
                        n_clusters: int = 0, cap_factor: float = 1.3,
                        kmeans_iters: int = 8,
                        kmeans_sample: int = 2_000_000,
                        tile: int = 1 << 20, seed: int = 0,
                        rows_fn=None, assign_cache: str | None = None,
                        verbose: bool = False) -> "IVFIndex":
    """Build an int8 IVF index WITHOUT a host or f32-resident corpus.

    ``tile_fn(start, size) -> f32 [size, dim] device rows`` is the only
    view of the data — a `CrossModalDeviceSpec.base_tile`, a device
    loader, or any deterministic shard source. The corpus is streamed
    three times (k-means sample, assignment, int8 fill); nothing bigger
    than one tile plus the int8 blocks ever lives in device memory:
    50M x 128d is 25.6 GB f32 but ~8 GB as capacity-padded int8 cluster
    blocks.

    Tiles are read with clamped full-width windows (one compiled shape);
    `tile_fn` must be deterministic per (start,size) — overlapping rows
    are recomputed, and re-stored values must agree.

    ``rows_fn(ids int32 [T]) -> f32 [T, dim]`` (random access by id —
    `CrossModalDeviceSpec.rows`, an mmap'd fbin gather, ...) enables the
    destination-ordered stripe fill, REQUIRED once the block table
    exceeds about half of device memory: the slot scatter's XLA lowering
    may need a full-table
    temp, while the stripe fill's dynamic-update-slice runs in place.
    """
    metric = Metric.parse(metric)
    if metric not in (Metric.IP, Metric.COSINE):
        raise ValueError("build_ivf_streaming is int8-only (IP/cosine)")
    if metric == Metric.COSINE:
        # normalize at the stream boundary so k-means, assignment,
        # quantization, and rerank all see unit rows — the streamed
        # twin of IVFIndex.__init__'s prepare_vectors(base) (queries
        # are normalized at search time; scores are then true cosine)
        raw_tile_fn = tile_fn
        tile_fn = lambda s, w: prepare_vectors(raw_tile_fn(s, w), metric)
        if rows_fn is not None:
            raw_rows_fn = rows_fn
            rows_fn = lambda ids: prepare_vectors(raw_rows_fn(ids), metric)
    t0 = time.perf_counter()
    nc = n_clusters or max(16, int(np.sqrt(n) * 2))
    tile = min(tile, n)

    import os
    ck = None
    if assign_cache:
        # every parameter the cached placement/centroids depend on must
        # be in the key, or a changed build silently reuses stale state
        ck = (f"{assign_cache}.ivfassign_{n}_{dim}_{nc}_{kmeans_iters}_"
              f"{seed}_{metric.name.lower()}_{cap_factor:g}_"
              f"{min(kmeans_sample, n)}.npz")
    if ck and os.path.exists(ck):
        # k-means + assignment are the bulk of a 50M build (device sweeps
        # + candidate downloads); both are pure functions of (data,
        # config) — cache the host-side outcome
        with np.load(ck) as z:
            centroids, slot_cluster, slot_pos, gmax = (
                z["centroids"], z["slot_cluster"], z["slot_pos"],
                float(z["gmax"]))
        cap = int(slot_pos.max()) + 1
        c_dev = jnp.asarray(centroids)
        if verbose:
            print(f"ivf-streaming: assignment cache hit ({ck})",
                  file=sys.stderr, flush=True)
    else:
        samp = tile_fn(0, min(kmeans_sample, n))  # rows i.i.d. by design
        centroids = _kmeans(samp, nc, metric, kmeans_iters, seed)
        del samp
        if verbose:
            print(f"ivf-streaming: kmeans {nc} clusters in "
                  f"{time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)

        from mysteryann_tpu.ops.knn import exact_knn_device
        kk = min(8, nc)
        c_dev = jnp.asarray(centroids)
        cand = np.empty((n, kk), np.int32)
        gmax = 0.0
        # the [rows, nc] f32 distance block must stay well under HBM
        # (nc ~ 14k at 50M -> a full 1M tile would be 59 GB): sub-chunk
        # the assignment to a power-of-two row count bounded by ~3 GB
        sub = 1 << max(13, int(np.log2(max(1, (3 << 30) // (4 * nc)))))
        sub = min(sub, tile)
        for s in range(0, n, tile):
            st = min(s, n - tile)
            rows = tile_fn(st, tile)
            for ss in range(0, tile, sub):
                w = min(sub, tile - ss)
                _, ii = exact_knn_device(
                    jax.lax.dynamic_slice_in_dim(rows, ss, w, 0),
                    c_dev, k=kk, metric=metric, tile=nc)
                if nc < 2 ** 15:  # halve the download
                    ii = ii.astype(jnp.int16)
                cand[st + ss: st + ss + w] = np.asarray(ii)
            gmax = max(gmax, float(jnp.max(jnp.abs(rows))))
        cap0 = int(np.ceil(n / nc * cap_factor))
        slot_cluster, slot_pos, cap = _capacity_place(cand, nc, cap0)
        del cand
        if ck:
            np.savez(ck, centroids=centroids, slot_cluster=slot_cluster,
                     slot_pos=slot_pos, gmax=gmax)
    cap = -(-cap // 32) * 32  # round rows to a multiple of 32
    gscale = 127.0 / max(gmax, 1e-30)
    if verbose:
        print(f"ivf-streaming: assigned, cap {cap} "
              f"(waste {nc * cap / n:.2f}x) at "
              f"{time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    slot_pos32 = slot_pos.astype(np.int32)
    tbl = jnp.zeros((nc, cap, dim), jnp.int8)
    block_ids = np.full((nc, cap), n, np.int32)
    block_ids[slot_cluster, slot_pos32] = np.arange(n, dtype=np.int32)
    if rows_fn is not None:
        # destination-ordered stripe fill: walk clusters in contiguous
        # stripes, generate each stripe's member rows BY ID, store with
        # an in-place dynamic-update-slice. Sentinel (empty) slots get a
        # clamped row — block_ids >= n masks them at search.
        fill_ids = np.minimum(block_ids, n - 1).astype(np.int32)
        cs = min(nc, max(1, tile // cap))
        for it, c in enumerate(range(0, nc, cs)):
            c0 = min(c, nc - cs) if nc >= cs else 0   # one compiled shape
            ids_dev = jnp.asarray(fill_ids[c0: c0 + cs].reshape(-1))
            tbl = _quantize_stripe(tbl, rows_fn(ids_dev), gscale,
                                   jnp.asarray(c0, jnp.int32),
                                   cs=cs, cap=cap, dim=dim)
            if it % 4 == 3:
                # bound in-flight stripes: queued 0.6 GB generate+store
                # iterations next to the ~8 GB table exhaust memory
                jax.block_until_ready(tbl)
    else:
        for it, s in enumerate(range(0, n, tile)):
            st = min(s, n - tile)
            rows = tile_fn(st, tile)
            tbl = _quantize_scatter(tbl,
                                    jnp.asarray(slot_cluster[st: st + tile]),
                                    jnp.asarray(slot_pos32[st: st + tile]),
                                    rows, gscale)
            if it % 4 == 3:
                np.asarray(tbl[0, 0, 0])
    idx = IVFIndex.from_parts(c_dev, tbl, jnp.asarray(block_ids),
                              n_base=n, metric=metric, gscale=gscale)
    if verbose:
        print(f"ivf-streaming: built in {time.perf_counter() - t0:.1f}s",
              flush=True)
    return idx
