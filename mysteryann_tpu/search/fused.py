"""Fused neighbor-block search — one gathered row per hop.

The classic traversal (`search.beam`) gathers M neighbor VECTORS per
expansion, M scattered rows. This engine stores each node's neighbor
vectors INLINE, int8-quantized, together with their scales and ids in
ONE byte row — ``[M*d int8 | M f32 scales | M i32 ids]`` — so an
expansion is a single contiguous row fetch (`jnp.take` on the
``[N+1, R/128, 128]`` u8 table). The DiskANN trick of inline-PQ
traversal + exact rerank. Its gather rate and speed on the H100 are in
PERF.md and ROADMAP S3.

Traversal distances are int8-approximate; the final top-k is re-ranked
with exact f32 distances (small gather of k·oversample rows/query), so
reported dists are exact and recall loss from quantization is confined
to pool-boundary candidates.

Memory: ~N·M·(d+8) bytes — e.g. 8.7 GB for 1M nodes at width 64, d=128.
This is a serving accelerator for indexes that fit; the plain `Searcher`
remains the general path.
"""

from __future__ import annotations

import time
from functools import partial
from typing import TYPE_CHECKING, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.search.beam import _INF, _scatter_or_bits
from mysteryann_tpu.search.seeding import make_seed_sample, seed_scan

if TYPE_CHECKING:
    from mysteryann_tpu.graph.roargraph import RoarGraphIndex


def _row_bytes(M: int, d: int, bits: int = 8) -> int:
    r = M * d * bits // 8 + 8 * M
    # rows padded to whole KB: the [N, R/128, 128] table layout (kept
    # as is; whether the padding still pays is ROADMAP S3)
    return -(-r // 1024) * 1024


@partial(jax.jit, static_argnames=("n_base", "M", "d", "bits"))
def _pack_chunk(base, rows, n_base: int, M: int, d: int, bits: int = 8):
    """Quantize + byte-pack one chunk of neighbor blocks on device.

    rows int32 [c, M] (sentinel >= n_base) → u8 [c, R]: per-neighbor
    symmetric int8 (or two-per-byte int4 when ``bits=4``) quant of the
    neighbor's vector, its f32 scale, and its id (sentinel ids remapped
    to n_base+1 = "invalid").
    """
    c = rows.shape[0]
    valid = rows < n_base
    v = jnp.take(base, jnp.minimum(rows, n_base - 1).reshape(-1),
                 axis=0).reshape(c, M, d)                    # [c, M, d]
    amax = jnp.max(jnp.abs(v), axis=2)
    qmax = 127.0 if bits == 8 else 7.0
    sc = jnp.where(valid, amax / qmax, 0.0)
    qv = jnp.where(sc[..., None] > 0, v / jnp.maximum(sc, 1e-30)[..., None],
                   0.0)
    qv = jnp.clip(jnp.rint(qv), -qmax, qmax).astype(jnp.int8)
    ids = jnp.where(valid, rows, n_base + 1).astype(jnp.int32)

    if bits == 4:
        # nibble-pack in SPLIT-HALVES layout: byte j holds element j in
        # its low nibble and element j + d/2 in its high nibble. The
        # unpack then needs no per-element interleave — the two shifted
        # int8 arrays feed two half-width einsums directly (an
        # interleaving stack/reshape forced a full [B, F, d] relayout
        # per hop, which cost more than the gather savings; and XLA's
        # native int4 bitcast widens to f32 before reshape — 51 GB).
        qu = jax.lax.bitcast_convert_type(qv, jnp.uint8)
        qv_b = ((qu[..., d // 2:] & 0xF) << 4 | (qu[..., :d // 2] & 0xF)
                ).reshape(c, M * d // 2)
    else:
        qv_b = jax.lax.bitcast_convert_type(qv, jnp.uint8).reshape(c, M * d)
    sc_b = jax.lax.bitcast_convert_type(
        sc.astype(jnp.float32), jnp.uint8).reshape(c, 4 * M)
    id_b = jax.lax.bitcast_convert_type(ids, jnp.uint8).reshape(c, 4 * M)
    row = jnp.concatenate([qv_b, sc_b, id_b], axis=1)
    R = _row_bytes(M, d, bits)
    if row.shape[1] < R:
        row = jnp.pad(row, ((0, 0), (0, R - row.shape[1])))
    return row.reshape(c, R // 128, 128)


def _bitonic_merge_triple(d, i, e, L: int):
    """Merge a sorted pool with M sorted new entries into a sorted pool.

    Inputs are [B, P] with P a power of two laid out bitonically:
    ascending pool run, then +inf padding, then the new entries in
    DESCENDING order (ascending-then-nonincreasing = bitonic). A single
    bitonic merge cascade — log2(P) compare-exchange stages of pure
    vector selects — replaces a full `lax.sort`'s ~log² passes over the
    [B, P] state, which dominates per-hop cost at large L. Order key is
    lexicographic (dist, id), matching `lax.sort(num_keys=2)`. Returns
    the first L columns, sorted.
    """
    B, P = d.shape
    assert P & (P - 1) == 0
    s = P // 2
    while s >= 1:
        dr = d.reshape(B, P // (2 * s), 2, s)
        ir = i.reshape(B, P // (2 * s), 2, s)
        er = e.reshape(B, P // (2 * s), 2, s)
        lo_d, hi_d = dr[:, :, 0], dr[:, :, 1]
        lo_i, hi_i = ir[:, :, 0], ir[:, :, 1]
        lo_e, hi_e = er[:, :, 0], er[:, :, 1]
        swap = (hi_d < lo_d) | ((hi_d == lo_d) & (hi_i < lo_i))
        nlo_d = jnp.where(swap, hi_d, lo_d)
        nhi_d = jnp.where(swap, lo_d, hi_d)
        nlo_i = jnp.where(swap, hi_i, lo_i)
        nhi_i = jnp.where(swap, lo_i, hi_i)
        nlo_e = jnp.where(swap, hi_e, lo_e)
        nhi_e = jnp.where(swap, lo_e, hi_e)
        d = jnp.stack([nlo_d, nhi_d], axis=2).reshape(B, P)
        i = jnp.stack([nlo_i, nhi_i], axis=2).reshape(B, P)
        e = jnp.stack([nlo_e, nhi_e], axis=2).reshape(B, P)
        s //= 2
    return d[:, :L], i[:, :L], e[:, :L]


def _score_packed_rows(q, rows, metric: Metric, q_sq,
                       B: int, F: int, M: int, d: int, bits: int,
                       expand: int):
    """Unpack gathered byte rows and score their inline neighbors.

    ``rows`` is the [B*expand, R/128, 128] u8 gather output; returns
    (nd [B, F] f32 distances, nbrs [B, F] i32 global ids). Shared by the
    single-chip `_fused_beam` and the mp-sharded engine
    (`parallel/sharded_fused.py`) so the quantized scoring semantics
    cannot drift between them. Traced helper — call under jit."""
    # unpack via 3D sub-row slices — flattening to [B, R] u8 forces a
    # tiled-layout copy of the whole 75 MB block every hop
    qrows = M * d * bits // 8 // 128
    if bits == 4:
        # split-halves unpack (see _pack_chunk): sign-extend the two
        # nibble planes in place; each feeds a half-width einsum —
        # no per-element interleave, no [B, F, d] relayout
        xi = jax.lax.bitcast_convert_type(
            rows[:, :qrows, :], jnp.int8).reshape(B, F, d // 2)
        four = jnp.int8(4)
        b_lo = jnp.right_shift(jnp.left_shift(xi, four), four)
        b_hi = jnp.right_shift(xi, four)
        halves = (b_lo.astype(jnp.bfloat16), b_hi.astype(jnp.bfloat16))
    else:
        block = jax.lax.bitcast_convert_type(
            rows[:, :qrows, :], jnp.int8).reshape(B, F, d)
    meta = rows[:, qrows:qrows + (8 * M) // 128, :].reshape(B, 8 * F)
    sc = jax.lax.bitcast_convert_type(
        meta.reshape(B, expand, 8 * M)[:, :, :4 * M].reshape(
            B, F, 4), jnp.float32)
    nbrs = jax.lax.bitcast_convert_type(
        meta.reshape(B, expand, 8 * M)[:, :, 4 * M:].reshape(
            B, F, 4), jnp.int32)

    if bits == 4:
        ip_q = (jnp.einsum("bd,bmd->bm", q[:, :d // 2], halves[0],
                           preferred_element_type=jnp.float32)
                + jnp.einsum("bd,bmd->bm", q[:, d // 2:], halves[1],
                             preferred_element_type=jnp.float32))
    else:
        ip_q = jnp.einsum("bd,bmd->bm", q, block.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    ip = ip_q * sc
    if metric in (Metric.IP, Metric.COSINE):
        nd = -ip
    else:
        if bits == 4:
            vn = (jnp.einsum("bmd,bmd->bm", halves[0], halves[0],
                             preferred_element_type=jnp.float32)
                  + jnp.einsum("bmd,bmd->bm", halves[1], halves[1],
                               preferred_element_type=jnp.float32)
                  ) * sc * sc
        else:
            vn = jnp.einsum("bmd,bmd->bm", block.astype(jnp.bfloat16),
                            block.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32) * sc * sc
        nd = q_sq - 2.0 * ip + vn
    return nd, nbrs


@partial(jax.jit,
         static_argnames=("k", "L", "metric", "max_hops", "n_base", "M", "d",
                          "collect_expanded", "visited_mode", "expand",
                          "exit_f", "bits", "rerank"))
def _fused_beam(table, base, eps, q, k: int, L: int, metric: Metric,
                max_hops: int, n_base: int, M: int, d: int,
                collect_expanded: int = 0, visited_mode: str = "merge",
                expand: int = 1, seed_ids=None, seed_d=None,
                exit_f: float | None = None, bits: int = 8,
                rerank: int = 0):
    """`collect_expanded=H>0` additionally returns the expansion history
    (reference full_retset, src/index_bipartite.cpp:1318): the ids of the
    first H nodes popped as closest-unexpanded, in pop order — the
    candidate pool the connectivity pass prunes (with exact f32
    distances recomputed there, so int8 approximation stays confined to
    traversal order).

    ``expand > 1`` pops that many closest-unexpanded entries per loop
    step (fanout expand*M): per-hop fixed costs (pool sort, loop
    overhead) amortize over more expansions, roughly halving step count
    at expand=2 — the high-L throughput knob, mirroring the classic
    engine's ``expand``. Traversal order differs slightly from
    expand=1 (the 2nd pop ignores the 1st pop's results), like the
    reference under OpenMP interleaving.

    ``visited_mode``: "merge" dedups re-encountered ids inside a full
    pool sort (no visited state — the serving default); "bitmask" keeps
    the reference-style visited bitmask so each id is scored exactly
    once — reference-parity ``cmps`` accounting (merge mode re-scores
    ids reached by several paths and honestly reports ~2x cmps). The
    bitmask's per-element visited probe/update costs B x M element
    gathers per hop; use it for parity evaluation, not serving.

    ``seed_ids``/``seed_d`` ([B, S] int32 / f32): per-query entry
    points replacing the global medoid ``eps`` — produced by the coarse
    sampled-subset matmul scan (`FusedSearcher(seed_sample=...)`), the
    analogue of HNSW's upper hierarchy levels. The beam
    starts inside the target neighborhood instead of walking from the
    medoid, which lifts recall at a given L and (with ``exit_f``) cuts
    hop counts. Seed distances may be approximate; traversal order uses
    them as-is and the final f32 rerank reports exact distances.

    ``exit_f``: optional early-termination factor. After each merge a
    query stops (its pool is marked fully expanded) once
    ``min_unexpanded_dist > d_k + exit_f * (d_k - d_0)`` — its closest
    unexpanded candidate can no longer plausibly improve the top-k.
    ``exit_f=0`` is the aggressive HNSW-style rule; larger values
    explore further. The reference always pops the full L-queue
    (src/index_bipartite.cpp:2356-2405); this knob is a beyond-reference
    throughput trade whose recall cost is measured, not assumed."""
    if visited_mode not in ("merge", "bitmask", "pool"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    use_bitmask = visited_mode == "bitmask"
    use_pool = visited_mode == "pool"
    B = q.shape[0]
    n_total = n_base + 2  # sentinel node row at n_base; invalid id n_base+1

    # seed: per-query coarse-scan seeds when provided, else the global eps
    if seed_ids is not None:
        E = seed_ids.shape[1]
        ep_ids = seed_ids.astype(jnp.int32)
        ep_d = seed_d
    else:
        E = eps.shape[0]
        ep_ids = jnp.broadcast_to(eps[None, :], (B, E)).astype(jnp.int32)
        ep_v = jnp.take(base, ep_ids.reshape(-1), axis=0).reshape(B, E, d)
        ep_ip = jnp.einsum("bd,bed->be", q, ep_v,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        if metric in (Metric.IP, Metric.COSINE):
            ep_d = -ep_ip
        else:
            ep_d = (jnp.sum(q * q, 1, keepdims=True) - 2 * ep_ip
                    + jnp.sum(ep_v * ep_v, 2))
    pad = L - E
    cand_ids = jnp.concatenate(
        [ep_ids, jnp.full((B, pad), n_total, jnp.int32)], axis=1)
    cand_d = jnp.concatenate([ep_d, jnp.full((B, pad), _INF)], axis=1)
    cand_exp = jnp.concatenate(
        [jnp.zeros((B, E), jnp.bool_), jnp.ones((B, pad), jnp.bool_)], axis=1)
    cand_d, cand_ids, cand_exp = jax.lax.sort(
        (cand_d, cand_ids, cand_exp), dimension=-1, num_keys=2)

    if metric == Metric.L2:
        q_sq = jnp.sum(q * q, axis=1, keepdims=True)

    H = max(collect_expanded, 1)
    hist0 = jnp.full((B, H), n_total, jnp.int32)

    n_words = -(-n_base // 32) if use_bitmask else 1
    visited0 = jnp.zeros((B, n_words), jnp.uint32)
    if use_bitmask:
        ep_c = jnp.minimum(ep_ids, n_base - 1)
        visited0 = _scatter_or_bits(
            visited0, ep_c >> 5,
            jnp.uint32(1) << (ep_c & 31).astype(jnp.uint32),
            ep_ids < n_base)
    P = 1 << (L + expand * M - 1).bit_length()  # bitonic width (pow2)

    def cond(st):
        return jnp.logical_and(jnp.any(~st[2]), st[-1] < max_hops)

    F = expand * M  # per-step fanout

    def maybe_exit(pool_d, pool_e):
        # early termination (see docstring): a query whose closest
        # unexpanded candidate is beyond d_k + exit_f*(d_k - d_0) marks
        # its whole pool expanded and drops out of the loop condition
        if exit_f is None:
            return pool_e
        d0 = pool_d[:, 0]
        dk = pool_d[:, k - 1]
        min_unexp = jnp.min(jnp.where(pool_e, _INF, pool_d), axis=1)
        stop = (min_unexp > dk + exit_f * (dk - d0)) & jnp.isfinite(dk)
        return pool_e | stop[:, None]

    def body(st):
        cand_ids, cand_d, cand_exp, visited, cmps, hops, hist, it = st
        unexp = ~cand_exp
        if expand == 1:
            has = jnp.any(unexp, axis=1)
            sel = jnp.argmax(unexp, axis=1)[:, None]           # [B, 1]
            sel_valid = has[:, None]
        else:
            # positions of the first `expand` unexpanded entries
            rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1) - 1
            onrank = unexp & (rank < expand)
            nsel = jnp.sum(onrank, axis=1)
            key = jnp.where(
                onrank,
                jax.lax.broadcasted_iota(jnp.int32, unexp.shape, 1),
                jnp.int32(L + 1))
            sel = jax.lax.top_k(-key, expand)[0] * -1          # [B, e]
            sel_valid = (sel <= L) & (jax.lax.broadcasted_iota(
                jnp.int32, sel.shape, 1) < nsel[:, None])
            sel = jnp.minimum(sel, L - 1)
        b_i = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 0)
        cur = jnp.where(sel_valid, cand_ids[b_i, sel], n_base)  # sentinel
        cand_exp = cand_exp.at[b_i, jnp.where(sel_valid, sel, L)].set(
            True, mode="drop")
        if collect_expanded > 0:
            pos = hops[:, None] + jax.lax.broadcasted_iota(
                jnp.int32, sel.shape, 1)
            pos = jnp.where(sel_valid, pos, H)  # H = OOB → dropped
            hist = hist.at[b_i, pos].set(
                jnp.where(sel_valid, cur, n_total), mode="drop")

        # THE gather: one packed byte row per expansion
        cur_c = jnp.minimum(cur, n_base).reshape(-1)           # [B*e]
        rows = jnp.take(table, cur_c, axis=0)      # [B*e, R/128, 128] u8
        nd, nbrs = _score_packed_rows(
            q, rows, metric, q_sq if metric == Metric.L2 else None,
            B=B, F=F, M=M, d=d, bits=bits, expand=expand)

        if use_bitmask or use_pool:
            # "bitmask": reference VisitedListPool semantics — an id is
            # scored once, ever. "pool": membership test against the
            # live candidate pool only (sound — a dropped candidate can
            # never re-enter; see beam.py) — no visited state, and the
            # pool update runs through the bitonic merge cascade instead
            # of two full [B, L+F] sorts (the merge-mode cost at high L).
            # Intra-step duplicates (same id twice in one fan-out)
            # reduce to the first occurrence — O(F²) elementwise.
            in_b = nbrs < n_base
            nb_c = jnp.where(in_b, nbrs, 0)
            if use_pool:
                seen = jnp.any(nbrs[:, :, None] == cand_ids[:, None, :],
                               axis=2)
            else:
                words = nb_c >> 5
                bitv = jnp.uint32(1) << (nb_c & 31).astype(jnp.uint32)
                seen = (visited[jnp.arange(B)[:, None], words] & bitv) != 0
            earlier = (nbrs[:, :, None] == nbrs[:, None, :]) & (
                jax.lax.broadcasted_iota(jnp.int32, (1, F, F), 2)
                < jax.lax.broadcasted_iota(jnp.int32, (1, F, F), 1))
            first_occ = ~jnp.any(earlier, axis=2)
            fresh = in_b & ~seen & first_occ
            if use_bitmask:
                visited = _scatter_or_bits(visited, words, bitv, fresh)
            nd = jnp.where(fresh, nd, _INF)
            new_ids = jnp.where(fresh, nbrs, n_total)
            cmps = cmps + jnp.sum(fresh, axis=1, dtype=jnp.int32)
            hops = hops + jnp.sum(sel_valid, axis=1, dtype=jnp.int32)
            # sort the F new entries, then ONE bitonic merge into the
            # (already sorted) pool — log2(P) select stages instead of
            # two ~log² full sorts.
            nd_s, ni_s, ne_s = jax.lax.sort(
                (nd, new_ids, ~fresh), dimension=-1, num_keys=2)
            pad_w = P - L - F
            all_d = jnp.concatenate(
                [cand_d, jnp.full((B, pad_w), _INF), nd_s[:, ::-1]], axis=1)
            all_i = jnp.concatenate(
                [cand_ids, jnp.full((B, pad_w), n_total, jnp.int32),
                 ni_s[:, ::-1]], axis=1)
            all_e = jnp.concatenate(
                [cand_exp, jnp.ones((B, pad_w), jnp.bool_),
                 ne_s[:, ::-1]], axis=1)
            all_d, all_i, all_e = _bitonic_merge_triple(
                all_d, all_i, all_e, L)
            all_e = maybe_exit(all_d, all_e)
            return (all_i, all_d, all_e, visited, cmps, hops, hist, it + 1)

        # merge mode — no membership test, no pre-dedup: a re-encountered
        # id is simply re-scored and killed by the id-grouped dedup in
        # the merge below (an id quantized in two source blocks scores
        # differently per path; the kept copy is the expanded one, else
        # the best-scoring one). Dropped candidates provably cannot
        # re-enter the pool (monotone L-th key, see beam.py) — and the
        # O(F·L) membership broadcast disappears.
        fresh = nbrs < n_base
        nd = jnp.where(fresh, nd, _INF)
        new_ids = jnp.where(fresh, nbrs, n_total)
        cmps = cmps + jnp.sum(fresh, axis=1, dtype=jnp.int32)
        hops = hops + jnp.sum(sel_valid, axis=1, dtype=jnp.int32)

        all_d = jnp.concatenate([cand_d, nd], axis=1)
        all_i = jnp.concatenate([cand_ids, new_ids], axis=1)
        # id-grouped dedup (see beam.py merge mode): sort by (id,
        # expanded-first, dist), keep the FIRST copy of every id run (an
        # expanded copy wins so a node is never re-expanded; otherwise the
        # best int8-path distance), null the rest to padding, resort by
        # distance. Padding entries (~fresh) enter pre-expanded so they
        # never drive the loop.
        all_e = jnp.concatenate([cand_exp, ~fresh], axis=1)
        not_e = jnp.logical_not(all_e)
        all_i, not_e, all_d = jax.lax.sort(
            (all_i, not_e, all_d), dimension=-1, num_keys=3)
        dup = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.bool_),
             all_i[:, 1:] == all_i[:, :-1]], axis=1)
        all_d = jnp.where(dup, _INF, all_d)
        all_i = jnp.where(dup, n_total, all_i)
        all_e = jnp.where(dup, True, jnp.logical_not(not_e))
        all_d, all_i, all_e = jax.lax.sort(
            (all_d, all_i, all_e), dimension=-1, num_keys=2)
        out_e = maybe_exit(all_d[:, :L], all_e[:, :L])
        return (all_i[:, :L], all_d[:, :L], out_e, visited, cmps,
                hops, hist, it + 1)

    st = (cand_ids, cand_d, cand_exp, visited0,
          jnp.full((B,), E, jnp.int32), jnp.zeros((B,), jnp.int32),
          hist0, jnp.int32(0))
    cand_ids, cand_d, _, _, cmps, hops, hist, _ = jax.lax.while_loop(
        cond, body, st)

    # exact f32 rerank of the pool head (also dedups residual id copies
    # that entered via different int8 source blocks). int4 traversal
    # misorders the pool more, so its rerank reaches deeper — the extra
    # rows are a one-off ~2k-row gather, noise next to the walk's.
    # ``rerank`` overrides the depth outright (recall lever at fixed L).
    kk = min(L, rerank or max(2 * k, k + 8) * (2 if bits == 4 else 1))
    top_ids = jnp.minimum(cand_ids[:, :kk], n_base - 1)
    valid = cand_ids[:, :kk] < n_base
    vecs = jnp.take(base, top_ids.reshape(-1), axis=0).reshape(B, kk, d)
    ip = jnp.einsum("bd,bkd->bk", q, vecs, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if metric in (Metric.IP, Metric.COSINE):
        ed = -ip
    else:
        ed = q_sq - 2.0 * ip + jnp.sum(vecs * vecs, 2)
    ed = jnp.where(valid, ed, _INF)
    ed, ei = jax.lax.sort((ed, cand_ids[:, :kk]), dimension=-1, num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.bool_), ei[:, 1:] == ei[:, :-1]], axis=1)
    ed = jnp.where(dup, _INF, ed)
    ed, ei = jax.lax.sort((ed, ei), dimension=-1, num_keys=2)
    if collect_expanded > 0:
        return ei[:, :k], ed[:, :k], cmps, hops, hist
    return ei[:, :k], ed[:, :k], cmps, hops


@partial(jax.jit, donate_argnums=(0,))
def _table_fill(buf, chunk_rows, start):
    return jax.lax.dynamic_update_slice_in_dim(buf, chunk_rows, start, 0)


def pack_neighbor_table(base: jax.Array, neighbors, chunk: int = 16384,
                        into: jax.Array | None = None, bits: int = 8,
                        ) -> Tuple[jax.Array, int]:
    """Pack a padded adjacency into the fused byte-row table.

    ``base`` must be device-resident (metric-preprocessed f32 [N, d]);
    ``neighbors`` is int32 [N, M] with sentinel >= N — host (np) or
    device (the connectivity pass repacks its device-resident supply
    graph every round; ids never touch the host). Returns
    (table u8 [N+1, R/128, 128], M_padded).

    Packing is chunked so the f32 gather scratch stays bounded; chunks
    land in a preallocated DONATED buffer — a concatenate would
    transiently double the N·R tensor. ``into``
    recycles a previous table of the same shape as that buffer (every
    row is overwritten): repacking every connectivity round would
    otherwise re-allocate a multi-GB contiguous block into a fragmented
    heap (observed RESOURCE_EXHAUSTED at 1M on round 2). Row N is the
    sentinel: zero vectors, invalid ids (u8 zeros bitcast to id 0 would
    alias node 0, so it is overwritten with one explicit sentinel row).
    """
    n, d = base.shape
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if d % (8 if bits == 8 else 16):
        # with M % 16 == 0, the M*d*bits/8 qv region lands on the
        # 128-byte sub-row boundary iff d % 8 == 0 (int8) / d % 16 == 0
        # (int4 packs two per byte); callers pad dims once —
        # io.formats.data_align, or FusedSearcher's column zero-pad
        raise ValueError(f"fused byte-row packing needs dim % "
                         f"{8 if bits == 8 else 16} == 0 at bits={bits}, "
                         f"got d={d}; zero-pad the vectors")
    M0 = neighbors.shape[1]
    if M0 % 16:
        # M multiple of 16 keeps every packed region on a 128-byte
        # sub-row boundary (the unpack slices at sub-row granularity)
        padc = 16 - M0 % 16
        xp = jnp if isinstance(neighbors, jax.Array) else np
        neighbors = xp.concatenate(
            [neighbors, xp.full((neighbors.shape[0], padc), n,
                                neighbors.dtype)], axis=1)
    M = neighbors.shape[1]
    R = _row_bytes(M, d, bits)
    on_device = isinstance(neighbors, jax.Array)
    shape = (n + 1, R // 128, 128)
    if into is not None and into.shape == shape and into.dtype == jnp.uint8:
        table = into
    else:
        table = jnp.zeros(shape, jnp.uint8)
    for s in range(0, n, chunk):
        if on_device:
            c = min(chunk, n - s)
            rows = jax.lax.dynamic_slice_in_dim(neighbors, s, c, 0)
            rows = rows.astype(jnp.int32)
        else:
            rows = jnp.asarray(neighbors[s:s + chunk].astype(np.int32))
        p = _pack_chunk(base, rows, n_base=n, M=M, d=d, bits=bits)
        table = _table_fill(table, p, jnp.int32(s))
    sent = _pack_chunk(base, jnp.full((1, M), n, jnp.int32),
                       n_base=n, M=M, d=d, bits=bits)
    table = _table_fill(table, sent, jnp.int32(n))
    return table, M


class FusedSearcher:
    """Serving engine over inline int8 neighbor-block byte rows."""

    def __init__(self, index: "RoarGraphIndex", base: np.ndarray,
                 chunk: int = 65536, max_degree: int = 0,
                 seed_sample: int = 0, bits: int = 8):
        """``seed_sample=r`` (e.g. 64) keeps a strided 1-in-r sample of
        the base resident in bf16 for per-query entry-point scans
        (`search(seeds=...)`). ``bits=4`` nibble-packs traversal rows —
        half the per-expansion gather bytes for ~2x coarser traversal
        distances; the exact f32 rerank keeps
        reported distances exact either way."""
        self.metric = index.metric
        self.base = prepare_vectors(np.asarray(base, np.float32), self.metric)
        align = 8 if bits == 8 else 16
        self._col_pad = (align - self.base.shape[1] % align) % align
        if self._col_pad:
            # zero columns change no IP/L2/cosine distance; they keep the
            # packed qv region on the 128-byte sub-row boundary
            self.base = jnp.pad(self.base, ((0, 0), (0, self._col_pad)))
        n, d = self.base.shape
        nb = np.asarray(index.graph.neighbors)
        if max_degree and max_degree < nb.shape[1]:
            nb = nb[:, :max_degree]  # adjacency is closest-first per node
        self.eps = jnp.asarray([index.graph.ep], jnp.int32)
        self.bits = bits
        self.table, self.M = pack_neighbor_table(self.base, nb, chunk=chunk,
                                                 bits=bits)
        self.n_base, self.d = n, d
        self._samp = (make_seed_sample(self.base, seed_sample)
                      if seed_sample else None)

    def search(self, queries: np.ndarray, k: int, L: int,
               query_batch: int = 8192, max_hops: int = 0,
               device_out: bool = False, visited_mode: str = "auto",
               expand: int = 1, seeds: int = 0,
               exit_f: float | None = None, rerank: int = 0,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if seeds and self._samp is None:
            raise ValueError("seeds > 0 needs FusedSearcher(seed_sample=r)")
        if seeds > L:
            raise ValueError(f"seeds ({seeds}) must be <= L ({L})")
        if k > L:
            # the pool holds L candidates; a larger k would silently
            # return only L columns (jnp slice clamping)
            raise ValueError(f"k ({k}) must be <= L ({L})")
        if not isinstance(queries, jax.Array):
            queries = np.asarray(queries, np.float32)
        q = prepare_vectors(queries, self.metric)
        if self._col_pad:
            q = jnp.pad(q, ((0, 0), (0, self._col_pad)))
        nq, d = q.shape
        qb = min(query_batch, nq)
        pad = (-nq) % qb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, d), jnp.float32)])
        mh = max_hops or 4 * L + 32
        if visited_mode == "auto":
            visited_mode = "merge"  # bitmask = parity accounting only
        outs = []
        for s in range(0, nq + pad, qb):
            qs = jax.lax.dynamic_slice_in_dim(q, s, qb)
            seed_ids = seed_d = None
            if seeds:
                seed_ids, seed_d = seed_scan(
                    *self._samp, qs, n_seeds=seeds, metric=self.metric)
            outs.append(_fused_beam(
                self.table, self.base, self.eps,
                qs, k=k, L=L,
                metric=self.metric, max_hops=mh, n_base=self.n_base,
                M=self.M, d=self.d, visited_mode=visited_mode,
                expand=expand, seed_ids=seed_ids, seed_d=seed_d,
                exit_f=exit_f, bits=self.bits, rerank=rerank))
        if device_out:
            if len(outs) == 1:
                return tuple(o[:nq] for o in outs[0])
            return tuple(jnp.concatenate([o[j] for o in outs])[:nq]
                         for j in range(4))
        ids = np.concatenate([np.asarray(o[0]) for o in outs])[:nq]
        dists = np.concatenate([np.asarray(o[1]) for o in outs])[:nq]
        cmps = np.concatenate([np.asarray(o[2]) for o in outs])[:nq]
        hops = np.concatenate([np.asarray(o[3]) for o in outs])[:nq]
        return ids.astype(np.int32), dists, cmps, hops

    def benchmark(self, queries: np.ndarray, k: int, L: int,
                  query_batch: int = 8192, warmup: int = 1,
                  visited_mode: str = "auto", expand: int = 1,
                  seeds: int = 0, exit_f: float | None = None,
                  rerank: int = 0) -> dict:
        # device-timed (see FlatIndex.benchmark): results blocked on
        # device, downloaded outside the timed region
        q = prepare_vectors(np.asarray(queries, np.float32), self.metric)
        qb = min(query_batch, q.shape[0])
        kw = dict(visited_mode=visited_mode, expand=expand, seeds=seeds,
                  exit_f=exit_f, rerank=rerank)
        for _ in range(warmup):  # the timed call itself (see FlatIndex)
            jax.block_until_ready(self.search(
                q, k, L, query_batch=qb, device_out=True, **kw))
        t0 = time.perf_counter()
        out = self.search(q, k, L, query_batch=qb, device_out=True, **kw)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (np.asarray(o) for o in out)
        return {"L_pq": L, "k": k, "qps": q.shape[0] / dt,
                "avg_cmps": float(cmps.mean()), "avg_hops": float(hops.mean()),
                "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
                "ids": ids.astype(np.int32), "dists": dists}
