"""Multi-device RoarGraph build — every heavy phase sharded over the mesh.

The reference's build is its biggest compute: two OpenMP hot loops over
shared memory (src/index_bipartite.cpp:1059-1097 phase A over training
queries, :1192-1220 phase D over base nodes). This module is the
mesh-parallel equivalent, shaped so a corpus larger than one device's
memory can be *built*, not just served:

- big tensors are ``mp``-row-sharded: base vectors ``[N/mp, d]`` and the
  live supply adjacency ``[N/mp, 2M]``;
- work items (phase-A queries, phase-D node batches) are ``dp``-sharded;
- vectors never leave their owner shard: every distance is computed from
  owner-masked partials combined with ``psum`` over ``mp`` (each id has
  exactly one owner, so the psum adds zeros to the owner's value);
- per-row fold updates are computed replicated (they are chunk-sized,
  small) and applied ownership-masked on each shard.

Agreement with the one-device build: `sharded_build_roargraph(mesh, ...)`
runs the same algorithm as `graph.build_roargraph` **with
``connectivity_engine="classic"``**, at every ``connectivity_expand``
(the distributed beam mirrors the single-chip multi-pop selection), at
the same precision (f32 at HIGHEST) and the same prune batch shapes.
The occlusion keep-scan is the single-device kernel
(graph.prune.batched_occlusion_prune) with only the vector gather
swapped (`gather_fn`). On the CPU the two adjacencies are identical
(pinned by tests/test_sharded_build.py). On GPUs they are not: at
mp=4 the sharded programs round some f32 distances differently from
the one-device ones, and each such near-tie can flip a traversal or a
prune decision. The likely cause is that XLA compiles a contraction
that feeds an all-reduce into another fusion, with another summation
order. Measured at 1M x 128 on 4x H100 with the bench recipe: every
phase-D search row of a batch carries some distance that differs from
one card, yet 98.9% of the pools are identical, and 99.976% of phase-A
prune rows; the final adjacency has 99.726% of rows identical, recall@10
.9611 vs .9612. On one H100 at mp=1, where no all-reduce remains, those
primitives are identical and 999,999 of 1,000,000 rows are.
`chip_smoke.py --four-cards` holds the build to >= 99.5% of rows and
recall within 0.002.

Phase D here always searches through the distributed classic engine;
the fused byte-row engine is a single-chip accelerator (its int8 search
visits different nodes, so a fused single-device build is a different —
equally valid — graph). ``connectivity_engine="fused"`` is rejected;
``"auto"`` resolves to classic (unlike single-device auto, which may
pick fused).

Scale note (single host): ``mp`` shards device memory across one host's
cards, joined all to all by NVLink. The multi-host extension is a
mesh-construction concern, not an algorithm change — see
docs/ARCHITECTURE.md "Multi-host meshes".
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mysteryann_tpu.graph.adjacency import PaddedGraph
from mysteryann_tpu.graph.prune import batched_occlusion_prune, dists_to_src
from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.parallel.sharded_search import distributed_beam_search
from mysteryann_tpu.utils.params import BuildConfig

_INF = jnp.float32(jnp.inf)


# --------------------------------------------------------------------------
# sharded primitives
# --------------------------------------------------------------------------


def _owner_gather(flat_ids, b_shard, n, shard_n):
    """vecs for global ids from an mp-row-sharded base — exact (see module
    docstring). Runs inside shard_map."""
    my = jax.lax.axis_index("mp")
    off = my * shard_n
    owned = (flat_ids >= off) & (flat_ids < off + shard_n)
    loc = jnp.take(b_shard, jnp.clip(flat_ids - off, 0, shard_n - 1), axis=0)
    return jax.lax.psum(jnp.where(owned[:, None], loc, 0.0), "mp")


@functools.lru_cache(maxsize=64)
def _take_rows_fn(mesh: Mesh, shard_n: int):
    def local(a_shard, ids_r):
        my = jax.lax.axis_index("mp")
        off = my * shard_n
        owned = (ids_r >= off) & (ids_r < off + shard_n)
        loc = jnp.take(a_shard, jnp.clip(ids_r - off, 0, shard_n - 1), axis=0)
        zero = jnp.zeros_like(loc)
        return jax.lax.psum(jnp.where(owned[:, None], loc, zero), "mp")

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P("mp", None), P()),
                             out_specs=P(), check_vma=False))


def take_rows_sharded(mesh: Mesh, arr, ids: np.ndarray) -> jax.Array:
    """Gather rows of an mp-row-sharded 2-D array by global ids
    (replicated result)."""
    shard_n = arr.shape[0] // mesh.shape["mp"]
    return _take_rows_fn(mesh, shard_n)(arr, jnp.asarray(ids, jnp.int32))


@functools.lru_cache(maxsize=64)
def _scatter_rows_fn(mesh: Mesh, shard_n: int):
    def local(a_shard, ids_r, rows_r):
        my = jax.lax.axis_index("mp")
        off = my * shard_n
        owned = (ids_r >= off) & (ids_r < off + shard_n)
        loc_ids = jnp.where(owned, ids_r - off, shard_n)  # OOB → dropped
        return a_shard.at[loc_ids].set(rows_r, mode="drop")

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P("mp", None), P(), P()),
                             out_specs=P("mp", None), check_vma=False),
                   donate_argnums=(0,))


def scatter_rows_sharded(mesh: Mesh, arr, ids: np.ndarray, rows) -> jax.Array:
    """Overwrite rows of an mp-row-sharded 2-D array by global ids."""
    shard_n = arr.shape[0] // mesh.shape["mp"]
    return _scatter_rows_fn(mesh, shard_n)(
        arr, jnp.asarray(ids, jnp.int32), rows)


@functools.lru_cache(maxsize=64)
def _prune_rows_fn(mesh: Mesh, shard_n: int, n: int, cap: int,
                   metric: Metric, fill: bool):
    def local(b_shard, ids_b, cand_b, ns_b):
        gather = partial(_owner_gather, b_shard=b_shard, n=n,
                         shard_n=shard_n)
        src_vecs = gather(ids_b)
        # return_vecs: the owner-masked psum gather is the expensive
        # step here — reuse its rows in the prune
        cd, cv = dists_to_src(src_vecs, cand_b, None, metric,
                              gather_fn=gather, n_base=n,
                              return_vecs=True)
        pruned, _ = batched_occlusion_prune(
            src_vecs, ids_b, cand_b, cd, None, cap=cap, metric=metric,
            fill=fill, not_seedable=ns_b, gather_fn=gather, n_base=n,
            cand_vecs=cv)
        return pruned

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("mp", None), P("dp"), P("dp", None), P("dp", None)),
        out_specs=P("dp", None), check_vma=False))


def sharded_prune_rows(
    mesh: Mesh,
    base_sh,                      # [N/mp, d] per shard (mp-sharded)
    node_ids: np.ndarray,         # [K] global row ids
    cand,                         # [K, C] host or replicated device
    cap: int,
    metric: Metric,
    batch: int,
    fill: bool,
    not_seedable=None,
    n: int | None = None,
) -> jax.Array:
    """Occlusion-prune row batches with vectors fetched from the sharded
    base: the exact keep-scan of `_batched_prune_rows`, rows dp-sharded,
    gathers owner-masked over mp. Returns a replicated [K, cap] array."""
    n = n if n is not None else base_sh.shape[0]
    mp = mesh.shape["mp"]
    dp = mesh.shape["dp"]
    shard_n = n // mp
    K = node_ids.shape[0]
    C = cand.shape[1]
    batch = max(dp, min(batch, K))
    batch = -(-batch // dp) * dp  # divisible by dp
    fn = _prune_rows_fn(mesh, shard_n, n, cap, metric, fill)

    outs = []
    xp = jnp if isinstance(cand, jax.Array) else np
    for s in range(0, K, batch):
        e = min(s + batch, K)
        ids_b, cand_b = node_ids[s:e], cand[s:e]
        ns_b = not_seedable[s:e] if not_seedable is not None else None
        if e - s < batch:
            pad = batch - (e - s)
            ids_b = xp.concatenate([ids_b, xp.zeros(pad, ids_b.dtype)])
            cand_b = xp.concatenate(
                [cand_b, xp.full((pad, C), n, cand_b.dtype)])
            if ns_b is not None:
                ns_b = xp.concatenate([ns_b, xp.zeros((pad, C), bool)])
        if ns_b is None:
            ns_b = xp.zeros((batch, C), bool)
        out = fn(base_sh, jnp.asarray(ids_b, jnp.int32),
                 jnp.asarray(cand_b, jnp.int32), jnp.asarray(ns_b))
        outs.append(out[: e - s])
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs)


def _fold_round_sharded(mesh: Mesh, supply_sh, chunk_lists, r0: int, n: int):
    """`_fold_round_device` with the supply mp-row-sharded.

    The chunk's reverse aggregation is replicated compute (chunk-sized,
    small); each shard applies own-row overwrites and reverse merges for
    the rows it owns. Returns (supply' [mp], rev [mp], fit [mp])."""
    shard_n = n // mesh.shape["mp"]
    return _fold_round_fn(mesh, shard_n, n)(
        supply_sh, chunk_lists, jnp.int32(r0))


@functools.lru_cache(maxsize=16)
def _fold_round_fn(mesh: Mesh, shard_n: int, n: int):
    def local(supply_l, chunk_l, r0):
        W = supply_l.shape[1]
        c, M = chunk_l.shape
        my = jax.lax.axis_index("mp")
        off = my * shard_n
        row_ids = r0 + jnp.arange(c, dtype=jnp.int32)
        ok_row = row_ids < n
        chunk_l = jnp.where(ok_row[:, None], chunk_l, n)
        own_new = jnp.concatenate(
            [chunk_l, jnp.full((c, W - M), n, jnp.int32)], axis=1)
        owned_r = ok_row & (row_ids >= off) & (row_ids < off + shard_n)
        loc_rows = jnp.where(owned_r, row_ids - off, shard_n)
        supply_l = supply_l.at[loc_rows].set(own_new, mode="drop")

        # arrival-order reverse aggregation (replicated compute), then
        # scatter only owned destinations into the local rev shard
        src = jnp.repeat(row_ids, M)
        dst = chunk_l.reshape(-1)
        dstk = jnp.where(dst < n, dst, jnp.int32(n))
        arrival = jnp.arange(c * M, dtype=jnp.int32)
        ds, _, ss = jax.lax.sort((dstk, arrival, src), dimension=-1,
                                 num_keys=2)
        is_start = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), ds[1:] != ds[:-1]])
        seg_start = jax.lax.cummax(jnp.where(is_start, arrival, 0))
        rank = arrival - seg_start
        owned_d = (ds >= off) & (ds < off + shard_n)
        keep = (ds < n) & (rank < W) & owned_d
        rev_l = jnp.full((shard_n + 1, W), n, jnp.int32)
        rev_l = rev_l.at[jnp.where(keep, ds - off, shard_n),
                         jnp.where(keep, rank, 0)].set(
            jnp.where(keep, ss, n), mode="drop")[:shard_n]

        deg_own = jnp.sum(supply_l < n, axis=1, dtype=jnp.int32)
        deg_rev = jnp.sum(rev_l < n, axis=1, dtype=jnp.int32)
        fit_l = (deg_own + deg_rev) <= W

        # fit rows: append rev into free slots, dup-free vs own (the
        # single-device `blk` body, applied to the local shard)
        dup = (rev_l[:, :, None] == supply_l[:, None, :]).any(axis=2)
        posw = jax.lax.broadcasted_iota(jnp.int32, supply_l.shape, 1)
        own_key = jnp.where(supply_l < n, posw, 3 * W + posw)
        rev_key = jnp.where((rev_l < n) & ~dup, W + posw, 4 * W + posw)
        keys = jnp.concatenate([own_key, rev_key], axis=1)
        vals = jnp.concatenate([supply_l, rev_l], axis=1)
        k_s, v_s = jax.lax.sort((keys, vals), dimension=-1, num_keys=1)
        packed = jnp.where(k_s[:, :W] < 2 * W, v_s[:, :W], jnp.int32(n))
        supply_l = jnp.where(fit_l[:, None], packed, supply_l)
        return supply_l, rev_l, fit_l

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("mp", None), P(), P()),
        out_specs=(P("mp", None), P("mp", None), P("mp")),
        check_vma=False), donate_argnums=(0,))


@partial(jax.jit, static_argnames=("cap", "n"))
def _compact_truncate(rows, cap: int, n: int):
    K, W = rows.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    key = jnp.where(rows < n, pos, W + pos)
    k_s, v_s = jax.lax.sort((key, rows), dimension=-1, num_keys=1)
    return jnp.where(k_s[:, :cap] < W, v_s[:, :cap], jnp.int32(n))


# --------------------------------------------------------------------------
# the sharded build
# --------------------------------------------------------------------------


def sharded_build_roargraph(
    mesh: Mesh,
    base: np.ndarray,
    train_queries: np.ndarray,
    learn_base_knn: np.ndarray,
    cfg: BuildConfig = BuildConfig(),
    verbose: bool = False,
):
    """Mesh-parallel `build_roargraph`; returns the same RoarGraphIndex.

    N must divide the ``mp`` axis size. See the module docstring for the
    sharding layout and the exactness contract.
    """
    from mysteryann_tpu.graph.roargraph import (
        RoarGraphIndex, _aggregate_reverse, _append_novel, _left_compact,
        _refill_rows_device, compute_medoid)

    metric = Metric.parse(cfg.metric)
    M = cfg.M_pjbp
    n = base.shape[0]
    mp = mesh.shape["mp"]
    if n % mp:
        raise ValueError(f"N ({n}) must divide mp ({mp})")
    if cfg.connectivity_engine == "fused":
        raise ValueError(
            "sharded build searches phase D via the distributed classic "
            "engine; use connectivity_engine='classic' (or 'auto', which "
            "resolves to classic here). The fused byte-row engine is a "
            "single-chip accelerator — see the module docstring.")
    log = (functools.partial(print, file=sys.stderr, flush=True)
           if verbose else (lambda *a, **k: None))

    base_prep = prepare_vectors(base, metric)
    base_sh = jax.device_put(base_prep, NamedSharding(mesh, P("mp", None)))
    # medoid on the replicated array reproduces single-device arithmetic
    # exactly; past one device's memory pass a precomputed ep via cfg
    ep = compute_medoid(base_prep)
    del base_prep
    knn = np.asarray(learn_base_knn[:, : cfg.M_sq], np.int64)
    nq = knn.shape[0]

    # ---- phase A: projection prune, queries sharded over dp x mp ---------
    tgt_all32 = knn[:, 0].astype(np.int32)
    cand = knn.astype(np.int32)
    cand = np.where(cand == tgt_all32[:, None], n, cand)
    pruned_all = np.asarray(sharded_prune_rows(
        mesh, base_sh, tgt_all32, cand, M, metric, cfg.query_batch,
        fill=True, n=n))
    tgt_all = knn[:, 0]
    winners_tgt, first_idx = np.unique(tgt_all, return_index=True)
    forward = np.full((n, M), n, np.int32)
    forward[winners_tgt] = pruned_all[first_idx]
    log(f"sharded phase A: {winners_tgt.size}/{nq} targets")

    # ---- phase B+C: reverse edges + merge prune --------------------------
    pv = pruned_all < n
    e_src = np.repeat(tgt_all, M)[pv.ravel()]
    e_dst = pruned_all.ravel().astype(np.int64)[pv.ravel()]
    key = e_dst * np.int64(n) + e_src
    _, uniq = np.unique(key, return_index=True)
    e_src, e_dst = e_src[uniq], e_dst[uniq]
    e_dist = _edge_dists_sharded(mesh, base_sh, e_src, e_dst, metric)
    rev = _aggregate_reverse(e_src, e_dst, e_dist, n, r_max=3 * M)
    projection = _merge_forward_reverse_sharded(
        mesh, base_sh, forward, rev, cap=M, metric=metric,
        batch=cfg.query_batch, n=n)
    del forward, pruned_all
    log("sharded phase B/C done")

    # ---- phase D: connectivity, supply mp-sharded ------------------------
    final = projection
    for p_i in range(max(1, cfg.connectivity_passes)):
        supply = _connectivity_pass_sharded(
            mesh, base_sh, final, ep, cfg, metric, log, pass_i=p_i)
        final = _append_novel(final, supply, cap_add=2 * M, n=n)
        if final.shape[1] > 2 * M:
            final = _cap_degree_sharded(mesh, base_sh, final, 2 * M,
                                        metric, cfg.query_batch, n)

    # ---- phase E: reachability (host BFS + sharded kNN attach) -----------
    final = _ensure_reachability_sharded(mesh, final, ep, base_sh, metric,
                                         log)
    g = PaddedGraph(neighbors=final, ep=ep)
    return RoarGraphIndex(graph=g, metric=metric, dim=base.shape[1])


def _cap_degree_sharded(mesh, base_sh, rows, cap, metric, batch, n):
    """`graph.roargraph._cap_degree` with the prune routed through the
    mesh: rows over the cap go through the occlusion prune; rows within
    it are copied (left-compacted, so width truncation is lossless).
    Pruning ALL rows instead is NOT equivalent — the occlusion keep-scan
    can reorder/drop edges of under-cap rows too (caught by
    tests/test_sharded_build.py::test_sharded_build_two_pass_...)."""
    deg = (rows < n).sum(axis=1)
    out = np.full((rows.shape[0], cap), n, np.int32)
    ok = deg <= cap
    out[ok] = rows[ok][:, :cap]
    over = np.nonzero(~ok)[0]
    if over.size:
        # prune at the one-card shape: below 4M nodes `_cap_degree` pads
        # its blocks to 32768 rows, so its batch never shrinks to fewer
        # rows (pad rows prune row 0 and are dropped)
        k = over.size
        if n < 4_000_000:
            k = max(k, min(batch, 1 << 15))
        ids = np.zeros(k, np.int32)
        ids[: over.size] = over
        out[over] = np.asarray(sharded_prune_rows(
            mesh, base_sh, ids, rows[ids], cap, metric, batch, fill=True,
            n=n))[: over.size]
    return out


def _edge_dists_sharded(mesh, base_sh, e_src, e_dst, metric,
                        chunk: int = 1 << 19):
    out = np.empty(e_src.size, np.float32)
    for s in range(0, e_src.size, chunk):
        e = min(s + chunk, e_src.size)
        a = take_rows_sharded(mesh, base_sh, e_src[s:e].astype(np.int32))
        b = take_rows_sharded(mesh, base_sh, e_dst[s:e].astype(np.int32))
        ip = jnp.sum(a * b, axis=-1)
        if metric in (Metric.IP, Metric.COSINE):
            d = -ip
        else:
            d = jnp.sum((a - b) ** 2, axis=-1)
        out[s:e] = np.asarray(d)
    return out


def _merge_forward_reverse_sharded(mesh, base_sh, own, rev, cap, metric,
                                   batch, n):
    """`_merge_forward_reverse` with the prune routed through the mesh."""
    rev = rev.copy()
    chunk = max(1, (1 << 27) // max(1, rev.shape[1] * own.shape[1]))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dup = (rev[s:e, :, None] == own[s:e, None, :]).any(axis=2)
        rev[s:e][dup] = n
    cand = np.concatenate([own, rev], axis=1)
    total = (cand < n).sum(axis=1)
    out = np.full((n, cap), n, np.int32)
    easy = total <= cap
    if easy.any():
        rows = np.nonzero(easy)[0]
        c = cand[rows]
        order = np.argsort(c == n, axis=1, kind="stable")
        out[rows] = np.take_along_axis(c, order, axis=1)[:, :cap]
    hard = np.nonzero(~easy)[0]
    OB = 1 << 15  # the one-card merge's block: the same prune shapes
    for s in range(0, hard.size, OB):
        rows = hard[s: s + OB]
        out[rows] = np.asarray(sharded_prune_rows(
            mesh, base_sh, rows.astype(np.int32), cand[rows], cap, metric,
            batch, fill=True, n=n))
    return out


def _connectivity_pass_sharded(mesh, base_sh, projection, ep, cfg, metric,
                               log, pass_i=0):
    """Phase D with supply mp-sharded and node batches dp-sharded.

    Mirrors `graph.roargraph._connectivity_pass` (classic engine) —
    incremental rounds, arrival-order fold, overflow prune+refill — with
    every device step swapped for its sharded twin (incl. the
    pass-dependent round schedule `_rounds_for_pass`, so multi-pass
    sharded builds agree with single-device ones; see the module
    docstring)."""
    from mysteryann_tpu.graph.roargraph import _refill_rows_device

    n, d = base_sh.shape
    M = cfg.M_pjbp
    L = cfg.L_pjpq
    dp = mesh.shape["dp"]
    sb = max(dp, min(cfg.search_batch, n))
    sb = -(-sb // dp) * dp
    eps_j = jnp.asarray([ep], jnp.int32)
    H = cfg.history_mult * L
    from mysteryann_tpu.graph.roargraph import _prune_batch, _rounds_for_pass
    rounds = _rounds_for_pass(cfg, pass_i)
    pb = -(-max(dp, _prune_batch(cfg, n)) // dp) * dp
    chunks = [-(-n // rounds)] * rounds
    W = 2 * M

    supply0 = np.full((n, W), n, np.int32)
    supply0[:, : projection.shape[1]] = projection[:, : W]
    supply_sh = jax.device_put(jnp.asarray(supply0),
                               NamedSharding(mesh, P("mp", None)))
    del supply0
    # projection stays HOST-resident; each batch uploads only its [sb, M]
    # slice for the ns membership mask (a replicated [n, M] device copy
    # is 1.28 GB at 10M — the margin the single-device build's
    # proj_on_host branch exists to reclaim)

    r0 = 0
    for chunk in chunks:
        r1 = min(r0 + chunk, n)
        chunk_dev = jnp.full((chunk + 1, M), n, jnp.int32)
        for s in range(r0, r1, sb):
            sl = max(0, min(s, n - sb))
            q = take_rows_sharded(
                mesh, base_sh, np.arange(sl, sl + sb, dtype=np.int32))
            r = distributed_beam_search(
                mesh, base_sh, supply_sh, eps_j, q, k=1, L=L,
                metric=metric, visited_mode="pool", collect_expanded=H,
                expand=cfg.connectivity_expand)
            pool = r.hist_ids                                    # [sb, H]
            node_ids = np.arange(sl, sl + sb, dtype=np.int32)
            proj_rows = jnp.asarray(projection[sl: sl + sb])
            ns = (pool[:, :, None] == proj_rows[:, None, :]).any(
                axis=2) & (pool < n)
            pruned = sharded_prune_rows(
                mesh, base_sh, node_ids, pool, M, metric,
                pb, fill=False,
                not_seedable=ns, n=n)
            slot = jnp.arange(sl - r0, sl - r0 + sb, dtype=jnp.int32)
            slot = jnp.where((slot >= 0) & (slot < chunk), slot, chunk)
            chunk_dev = chunk_dev.at[slot].set(pruned)
        supply_sh, rev_sh, fit_sh = _fold_round_sharded(
            mesh, supply_sh, chunk_dev[:chunk], r0, n)
        fit = np.asarray(fit_sh)
        over = np.nonzero(~fit)[0]
        if over.size:
            K = max(1024, 1 << (int(over.size) - 1).bit_length())
            over_ids = np.zeros(K, np.int32)
            over_ids[: over.size] = over
            own_rows = take_rows_sharded(mesh, supply_sh, over_ids)
            rev_rows = take_rows_sharded(mesh, rev_sh, over_ids)
            cand = jnp.concatenate([own_rows, rev_rows], axis=1)
            pruned = sharded_prune_rows(
                mesh, base_sh, over_ids, cand, M, metric,
                pb, fill=False, n=n)
            merged = _refill_rows_device(pruned, cand, n)
            scat = np.full(K, n, np.int32)
            scat[: over.size] = over
            supply_sh = scatter_rows_sharded(mesh, supply_sh, scat, merged)
        log(f"\rsharded connectivity round {min(r1, n)}/{n}", end="")
        r0 = r1
    log("")

    # overflow re-prune + compact-truncate to M (per-row ops, mp-local).
    # The compact runs in row slabs — a one-shot [n, 2M] re-upload plus
    # its sort scratch is the exact pattern the single-device epilogue
    # slabbed after OOMing at 10M (graph/roargraph.py memory note)
    supply = np.asarray(supply_sh)
    deg = (supply < n).sum(axis=1)
    final = np.empty((n, M), np.int32)
    SLAB = min(n, 1 << 20)
    for s in range(0, n, SLAB):
        st = min(s, n - SLAB)  # clamped window; overlap recomputed
        final[st: st + SLAB] = np.asarray(_compact_truncate(
            jnp.asarray(supply[st: st + SLAB]), cap=M, n=n))
    over = np.nonzero(deg > M)[0]
    if over.size:
        # at least one prune batch: the one-card epilogue prunes padded
        # blocks at `pb` rows, and a shorter batch compiles other shapes
        K = max(pb, 1 << (int(over.size) - 1).bit_length())
        over_ids = np.zeros(K, np.int32)
        over_ids[: over.size] = over
        cand = supply[over_ids]
        proj_rows = projection[over_ids]
        ns = (cand[:, :, None] == proj_rows[:, None, :]).any(
            axis=2) & (cand < n)
        pruned = np.asarray(sharded_prune_rows(
            mesh, base_sh, over_ids, cand, M, metric,
            pb, fill=False,
            not_seedable=ns, n=n))
        final[over] = pruned[: over.size]
    return final


def _ensure_reachability_sharded(mesh, final, ep, base_sh, metric, log):
    """Host BFS + nearest-reachable attach, kNN through the sharded mesh.

    Mirrors `graph.roargraph._ensure_reachability`; uses the sharded
    exact kNN so no device ever needs the whole base."""
    from mysteryann_tpu.parallel.sharded_knn import sharded_exact_knn

    n, width = final.shape
    for it in range(8):
        reachable = np.zeros(n, bool)
        reachable[ep] = True
        frontier = np.array([ep], np.int64)
        while frontier.size:
            nxt = final[frontier]
            nxt = np.unique(nxt[nxt < n])
            nxt = nxt[~reachable[nxt]]
            reachable[nxt] = True
            frontier = nxt
        stranded = np.nonzero(~reachable)[0]
        if stranded.size == 0:
            if it:
                log(f"sharded phase E: repaired in {it} rounds")
            return final
        log(f"sharded phase E round {it}: {stranded.size} unreachable")
        kk = 32
        dp = mesh.shape["dp"]
        # chunk the stranded-node kNN: an unchunked B = stranded.size
        # holds a [B/dp, tile] distance block per step — the OOM the
        # single-device repair's qb loop was added for (100k+ strands
        # happen at 10M)
        QB = 8192
        cand = np.empty((stranded.size, kk), np.int32)
        for s in range(0, int(stranded.size), QB):
            blk = stranded[s: s + QB]
            bs = -(-max(dp, 1 << max(5, (int(blk.size) - 1).bit_length()))
                   // dp) * dp
            pad_ids = np.zeros(bs, np.int32)
            pad_ids[: blk.size] = blk
            q = take_rows_sharded(mesh, base_sh, pad_ids)
            _, cc = sharded_exact_knn(mesh, q, base_sh, k=kk,
                                      metric=metric, tile=131072,
                                      precision="highest")
            cand[s: s + blk.size] = np.asarray(cc)[: blk.size]
        A = 3
        n_found = np.zeros(stranded.size, np.int64)
        attach_src, attach_dst = [], []
        for j in range(kk):
            c = cand[:, j].astype(np.int64)
            good = (n_found < A) & reachable[c] & (c != stranded)
            attach_src.append(stranded[good])
            attach_dst.append(c[good])
            n_found += good
        u_all = np.concatenate(attach_src)
        v_all = np.concatenate(attach_dst)
        none_found = n_found == 0
        if none_found.any():
            u_all = np.concatenate([u_all, stranded[none_found]])
            v_all = np.concatenate(
                [v_all, np.full(none_found.sum(), ep, np.int64)])
        order = np.argsort(v_all, kind="stable")
        at_s, u_s = v_all[order], u_all[order]
        counts = np.bincount(at_s, minlength=n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        rank = np.arange(at_s.size) - offs[at_s]
        free0 = (final[at_s] < n).sum(axis=1)
        slot = np.minimum(free0 + rank, width - 1)
        final[at_s, slot] = u_s.astype(np.int32)
    log("sharded phase E: WARNING — did not converge in 8 rounds")
    return final
