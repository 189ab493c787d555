"""Batched lockstep beam search over a padded graph.

Batched recast of the reference's one-query-at-a-time best-first loop
(`SearchRoarGraph`, reference src/index_bipartite.cpp:2311-2420):

- the sorted fixed-capacity ``NeighborPriorityQueue`` (reference
  neighbor.h:150-192) becomes a sorted candidate pool ``[B, L]`` carried
  through a ``lax.while_loop``, merged each step with ``jax.lax.sort``;
- the epoch-tagged ``VisitedListPool`` (reference
  include/visited_list_pool.h) becomes a per-query bitmask
  ``uint32 [B, ceil(N/32)]`` in device memory, updated with duplicate-safe
  scatter-OR;
- ``closest_unexpanded()`` becomes an argmax over the unexpanded mask of
  the sorted pool (first True = smallest distance);
- one loop step expands `expand` nodes for *every* query in the batch —
  neighbor-row gather, visited check, vector gather, batched distance,
  sorted merge;
- per-query (cmps, hops) counters are carried to match the reference's
  reporting (src/index_bipartite.cpp:2354-2419).

Termination matches the reference: a query is done when every entry of its
pool is expanded; the loop runs while any query is live, with a static
iteration cap for XLA.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mysteryann_tpu.ops.distances import Metric

_INF = jnp.float32(jnp.inf)


class SearchResult(NamedTuple):
    ids: jax.Array     # int32 [B, k]
    dists: jax.Array   # f32   [B, k]
    cmps: jax.Array    # int32 [B] — distance computations (reference "cmps")
    hops: jax.Array    # int32 [B] — node expansions (reference "hops")
    # expansion history (reference full_retset) when collect_expanded > 0:
    hist_ids: jax.Array | None = None   # int32 [B, H], sentinel-padded
    hist_d: jax.Array | None = None     # f32 [B, H]


def _batch_dist(q: jax.Array, vecs: jax.Array, metric: Metric) -> jax.Array:
    """Distances query[b] → vecs[b, m]: [B, d] x [B, M, d] -> [B, M].

    L2 norms are recomputed from the gathered vectors, which are already
    at hand, instead of gathered from a norm table. Full f32 precision:
    these are the distances the search reports.
    """
    ip = jnp.einsum("bd,bmd->bm", q, vecs, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if metric in (Metric.IP, Metric.COSINE):
        return -ip
    qn = jnp.sum(q * q, axis=-1, keepdims=True)
    vn = jnp.sum(vecs * vecs, axis=-1)
    return jnp.maximum(qn - 2.0 * ip + vn, 0.0)


def _scatter_or_bits(visited: jax.Array, words: jax.Array, bits: jax.Array,
                     active: jax.Array) -> jax.Array:
    """OR `bits` into `visited[b, words[b, m]]`, duplicate-word safe.

    Distinct neighbors falling in the same visited word carry distinct bit
    positions, so within one row the combined contribution for a word is the
    *sum* of its members' bits == their OR. After combining, duplicate
    scatter indices write identical values, making `.at[].set` well-defined.
    O(M^2) combine — M is the graph degree (~32-64), cheap elementwise work.
    """
    bits = jnp.where(active, bits, jnp.uint32(0))
    same_word = words[:, :, None] == words[:, None, :]          # [B, M, M]
    combined = jnp.sum(
        jnp.where(same_word, bits[:, None, :], jnp.uint32(0)), axis=2,
        dtype=jnp.uint32,
    )                                                            # [B, M]
    b_idx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 0)
    new_vals = visited[b_idx, words] | combined
    return visited.at[b_idx, words].set(new_vals, mode="drop")


@partial(
    jax.jit,
    static_argnames=("k", "L", "metric", "max_hops", "expand", "two_hop",
                     "visited_mode", "collect_expanded", "two_hop_chunk"),
)
def beam_search(
    base: jax.Array,            # f32 [N, d] (metric-preprocessed)
    neighbors: jax.Array,       # int32 [N(+Nq), M_pad], sentinel >= n_total
    eps: jax.Array,             # int32 [E] entry point ids (shared by batch)
    queries: jax.Array,         # f32 [B, d]
    k: int,
    L: int,
    metric: Metric = Metric.IP,
    max_hops: int = 0,
    expand: int = 1,
    two_hop: bool = False,
    visited_mode: str = "bitmask",
    collect_expanded: int = 0,
    query_vecs_for_graph: jax.Array | None = None,
    seed_ids: jax.Array | None = None,   # int32 [B, S] per-query entries
    seed_d: jax.Array | None = None,     # f32 [B, S] their distances
    two_hop_chunk: int = 0,  # >0: hop-2 groups processed per inner step
) -> SearchResult:
    """Best-first beam search of `queries` over the padded graph.

    `two_hop=True` reproduces the bipartite search pattern (reference
    src/index_bipartite.cpp:282-356): pool entries are base nodes, and an
    expansion visits neighbors-of-neighbors (base→query→base). In that mode
    `neighbors` must cover base+query nodes (global id space) and
    `query_vecs_for_graph` is unused (query nodes are never scored).

    `visited_mode` selects the dedup structure:

    - ``"bitmask"``: per-query uint32 bitmask over all N base points — the
      exact analogue of the reference's VisitedListPool; an id is scored at
      most once (reference-parity ``cmps``). Costs [B, N/32] device state and
      a scatter per step.
    - ``"pool"``: membership test against the candidate pool only. Sound
      because re-insertion of a dropped candidate is impossible — the
      pool's worst kept distance is monotonically non-increasing, and a
      candidate was dropped precisely because it was worse (the pool never
      holds +inf pads once full). Ids reached again by another path may be
      re-*scored* (higher ``cmps``) but are rejected at the merge, so
      traversal order and results are unchanged. No big visited buffer, no
      scatter — the fast serving mode.
    - ``"merge"``: no dedup structure at all. Re-encountered ids are
      re-scored and deduplicated INSIDE the merge: sort by (id,
      expanded-first, dist), keep the first copy of each id run, resort
      by distance. Same soundness argument as "pool" (a dropped candidate
      can never re-enter); drops the O(F·L) membership broadcast too —
      the fastest mode at large L. Results can differ from "bitmask" by
      ulp-level ties only (a re-scored distance is not always
      bit-identical to its first encounter).
    """
    metric = Metric.parse(metric)
    if k > L:
        raise ValueError(f"k ({k}) must be <= L ({L})")
    if visited_mode not in ("bitmask", "pool", "merge"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    use_bitmask = visited_mode == "bitmask"
    use_merge = visited_mode == "merge"
    n_base, d = base.shape
    n_total = neighbors.shape[0]
    M = neighbors.shape[1]
    B = queries.shape[0]
    E = eps.shape[0]
    if max_hops <= 0:
        max_hops = 4 * L + 32
    n_words = -(-n_base // 32) if use_bitmask else 1

    def gather_vecs(ids):  # ids int32 [...], clamped row gather
        flat = jnp.minimum(ids, n_base - 1).reshape(-1)
        return jnp.take(base, flat, axis=0).reshape(ids.shape + (d,))

    # ---- seed pool with entry points -------------------------------------
    # per-query seeds (coarse-scan entry points, see search.fused._seed_scan)
    # replace the shared medoid when provided
    if seed_ids is not None:
        E = seed_ids.shape[1]
        ep_ids = seed_ids.astype(jnp.int32)
        ep_d = (seed_d if seed_d is not None
                else _batch_dist(queries, gather_vecs(ep_ids), metric))
    else:
        ep_ids = jnp.broadcast_to(eps[None, :], (B, E)).astype(jnp.int32)
        ep_d = _batch_dist(queries, gather_vecs(ep_ids), metric)
    pad = L - E
    assert pad >= 0, f"L={L} must be >= number of entry points E={E}"
    cand_ids = jnp.concatenate(
        [ep_ids, jnp.full((B, pad), n_total, jnp.int32)], axis=1)
    cand_d = jnp.concatenate([ep_d, jnp.full((B, pad), _INF)], axis=1)
    cand_exp = jnp.concatenate(
        [jnp.zeros((B, E), jnp.bool_), jnp.ones((B, pad), jnp.bool_)], axis=1)
    cand_d, cand_ids, cand_exp = jax.lax.sort(
        (cand_d, cand_ids, cand_exp), dimension=-1, num_keys=2)

    visited = jnp.zeros((B, n_words), jnp.uint32)
    if use_bitmask:
        ep_words = ep_ids >> 5
        ep_bits = (jnp.uint32(1) << (ep_ids & 31).astype(jnp.uint32))
        visited = _scatter_or_bits(visited, ep_words, ep_bits,
                                   ep_ids < n_base)

    cmps0 = jnp.full((B,), E, jnp.int32)
    hops0 = jnp.zeros((B,), jnp.int32)

    # expansion history (reference full_retset, src/index_bipartite.cpp:1318):
    # every (id, dist) popped as closest_unexpanded, in pop order. Needed by
    # the connectivity pass, whose prune wants the whole visited region —
    # including expanded-then-dropped far nodes (the long-range edges).
    H = max(collect_expanded, 1)
    hist_ids0 = jnp.full((B, H), n_total, jnp.int32)
    hist_d0 = jnp.full((B, H), _INF)

    def cond(state):
        cand_exp = state[2]
        it = state[-1]
        live = jnp.any(jnp.logical_not(cand_exp))
        return jnp.logical_and(live, it < max_hops)

    def body(state):
        (cand_ids, cand_d, cand_exp, visited, cmps, hops,
         hist_ids, hist_d, it) = state

        # -- pick the `expand` closest unexpanded entries per query --------
        unexp = jnp.logical_not(cand_exp)                         # [B, L]
        has = jnp.any(unexp, axis=1)                              # [B]
        if expand == 1 and not two_hop:
            sel = jnp.argmax(unexp, axis=1)[:, None]              # [B, 1]
            sel_valid = has[:, None]
        else:
            # positions of first `expand` unexpanded entries (pool sorted)
            rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1) - 1  # [B, L]
            e = 1 if two_hop else expand
            onrank = unexp & (rank < e)
            nsel = jnp.sum(onrank, axis=1)                        # [B]
            key = jnp.where(onrank,
                            jax.lax.broadcasted_iota(jnp.int32, unexp.shape, 1),
                            jnp.int32(L + 1))
            sel = jax.lax.top_k(-key, e)[0] * -1                  # [B, e]
            sel_valid = sel <= L
            sel = jnp.minimum(sel, L - 1)
            sel_valid = sel_valid & (jax.lax.broadcasted_iota(
                jnp.int32, sel.shape, 1) < nsel[:, None])

        b_iota = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 0)
        cur = jnp.where(sel_valid, cand_ids[b_iota, sel], n_total)  # [B, e]
        sel_set = jnp.where(sel_valid, sel, L)  # L = OOB → dropped
        if collect_expanded > 0:
            cur_d = jnp.where(sel_valid, cand_d[b_iota, sel], _INF)
            pos = hops[:, None] + jax.lax.broadcasted_iota(
                jnp.int32, sel.shape, 1)
            pos = jnp.where(sel_valid, pos, H)  # H = OOB → dropped
            hist_ids = hist_ids.at[b_iota, pos].set(cur, mode="drop")
            hist_d = hist_d.at[b_iota, pos].set(cur_d, mode="drop")
        cand_exp = cand_exp.at[b_iota, sel_set].set(True, mode="drop")

        def process(st5, nbrs):
            """Score a fan-out slice and merge it into the pool.

            st5 = (cand_ids, cand_d, cand_exp, visited, cmps); `nbrs` is
            [B, F] global ids (sentinel >= n_total). Pulling this out of
            the step lets two-hop mode feed hop-2 groups in bounded
            chunks instead of materializing the full [B, M², d] gather.
            """
            cand_ids, cand_d, cand_exp, visited, cmps = st5
            F = nbrs.shape[1]
            # -- seen-before check ------------------------------------------
            in_base = nbrs < n_base   # only base nodes are scored/inserted
            nb_c = jnp.where(in_base, nbrs, 0)
            if use_merge:
                # dedup happens inside the merge sort (see docstring)
                fresh = in_base
            else:
                if use_bitmask:
                    words = nb_c >> 5
                    bits = (jnp.uint32(1) << (nb_c & 31).astype(jnp.uint32))
                    seen = (visited[jax.lax.broadcasted_iota(
                        jnp.int32, words.shape, 0), words] & bits) != 0
                else:
                    # pool membership (see visited_mode docstring)
                    seen = jnp.any(nbrs[:, :, None] == cand_ids[:, None, :],
                                   axis=2)
                # intra-slice duplicates (same id appearing twice in this
                # slice's fan-out) must be reduced to one representative:
                # duplicates would corrupt the sum-as-OR trick in
                # _scatter_or_bits and insert twice into the pool.
                f_iota = jax.lax.broadcasted_iota(jnp.int32, nbrs.shape, 1)
                sv, si = jax.lax.sort((nbrs, f_iota), dimension=-1,
                                      num_keys=1)
                dup_sorted = jnp.concatenate(
                    [jnp.zeros((B, 1), jnp.bool_), sv[:, 1:] == sv[:, :-1]],
                    axis=1)
                fb_iota = jax.lax.broadcasted_iota(jnp.int32, nbrs.shape, 0)
                first_occ = jnp.zeros_like(in_base).at[
                    fb_iota, si].set(~dup_sorted)
                fresh = in_base & ~seen & first_occ               # [B, F]
                if use_bitmask:
                    visited = _scatter_or_bits(visited, words, bits, fresh)

            # -- distances for fresh neighbors ------------------------------
            vecs = gather_vecs(nb_c)                              # [B, F, d]
            nd = _batch_dist(queries, vecs, metric)
            nd = jnp.where(fresh, nd, _INF)
            new_ids = jnp.where(fresh, nbrs, n_total)
            cmps = cmps + jnp.sum(fresh, axis=1, dtype=jnp.int32)

            # -- sorted merge into the pool ---------------------------------
            all_d = jnp.concatenate([cand_d, nd], axis=1)
            all_i = jnp.concatenate([cand_ids, new_ids], axis=1)
            all_e = jnp.concatenate(
                [cand_exp, jnp.ones((B, F), jnp.bool_) & ~fresh], axis=1)
            if use_merge:
                # id-grouped dedup: sort by (id, expanded-first, dist),
                # keep the FIRST copy of every id run (an expanded copy
                # wins so a node is never re-expanded; otherwise the
                # best-distance copy), null the rest to padding, then
                # resort by distance. NOTE a re-scored distance is NOT
                # always bit-identical to the first encounter (CPU einsum
                # differs by ulps across fan-out positions), so dedup must
                # key on id alone, never (id, dist).
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
            else:
                all_d, all_i, all_e = jax.lax.sort(
                    (all_d, all_i, all_e), dimension=-1, num_keys=2)
            return (all_i[:, :L], all_d[:, :L], all_e[:, :L], visited, cmps)

        # -- gather neighbor rows -------------------------------------------
        cur_c = jnp.minimum(cur, n_total - 1)
        e_sel = cur_c.shape[1]
        nbrs = jnp.take(neighbors, cur_c.reshape(-1), axis=0).reshape(
            B, e_sel, M)                                          # [B, e, M]
        nbrs = jnp.where((cur < n_total)[:, :, None], nbrs, n_total)
        st5 = (cand_ids, cand_d, cand_exp, visited, cmps)
        if two_hop and two_hop_chunk and two_hop_chunk < M:
            # hop-2 in bounded chunks: [B, c, M] gathers instead of one
            # [B, M, M] (and [B, c*M, d] vector fetches instead of
            # [B, M², d] — at the reference's M_pjbp=35/d=512 the full
            # fan-out is ~1.3 GB per 1k queries). Incremental merges keep
            # top-L exactly (the pool merge is associative in the kept
            # set; earlier chunks' insertions are visible to later
            # chunks' dedup, matching single-shot first-occurrence
            # semantics).
            c = two_hop_chunk
            n_chunks = -(-M // c)
            nbrs1 = nbrs.reshape(B, M)  # two_hop forces e_sel == 1
            if n_chunks * c != M:
                nbrs1 = jnp.concatenate(
                    [nbrs1, jnp.full((B, n_chunks * c - M), n_total,
                                     jnp.int32)], axis=1)

            def chunk_step(i, st5):
                sl = jax.lax.dynamic_slice_in_dim(nbrs1, i * c, c, axis=1)
                n1 = jnp.minimum(sl, n_total - 1)
                nb2 = jnp.take(neighbors, n1.reshape(-1), axis=0).reshape(
                    B, c, M)
                nb2 = jnp.where((sl < n_total)[:, :, None], nb2, n_total)
                return process(st5, nb2.reshape(B, c * M))

            st5 = jax.lax.fori_loop(0, n_chunks, chunk_step, st5)
        else:
            if two_hop:
                # expand neighbors-of-neighbors: base→query→base
                n1 = jnp.minimum(nbrs, n_total - 1)
                nbrs2 = jnp.take(neighbors, n1.reshape(-1), axis=0).reshape(
                    B, e_sel * M, M)                              # [B,e*M,M]
                nbrs2 = jnp.where(
                    (nbrs < n_total).reshape(B, -1, 1), nbrs2, n_total)
                nbrs = nbrs2.reshape(B, -1)                       # [B,e*M*M]
            else:
                nbrs = nbrs.reshape(B, -1)                        # [B, e*M]
            st5 = process(st5, nbrs)

        cand_ids, cand_d, cand_exp, visited, cmps = st5
        hops = hops + jnp.sum(sel_valid, axis=1, dtype=jnp.int32)
        return (cand_ids, cand_d, cand_exp,
                visited, cmps, hops, hist_ids, hist_d, it + 1)

    state = (cand_ids, cand_d, cand_exp, visited, cmps0, hops0,
             hist_ids0, hist_d0, jnp.int32(0))
    (cand_ids, cand_d, cand_exp, visited, cmps, hops,
     hist_ids, hist_d, _) = jax.lax.while_loop(cond, body, state)

    return SearchResult(
        ids=cand_ids[:, :k], dists=cand_d[:, :k], cmps=cmps, hops=hops,
        hist_ids=hist_ids if collect_expanded > 0 else None,
        hist_d=hist_d if collect_expanded > 0 else None)


def run_query_batches(q: jax.Array, nq: int, qb: int, run,
                      device_out: bool) -> Tuple:
    """Shared query-batching driver: zero-pad `q` [nq, d] to a multiple
    of ``qb``, stream fixed-shape batches through ``run(qs) -> tuple of
    [qb, ...] arrays``, and concatenate/trim the columns. One
    implementation for `Searcher.search` and `BipartiteSearcher.search`
    (the padding/output protocol must not drift between engines).
    ``device_out`` leaves results on device."""
    import numpy as np

    pad = (-nq) % qb
    if pad:
        q = jnp.concatenate(
            [q, jnp.zeros((pad, q.shape[1]), jnp.float32)])
    outs = [run(jax.lax.dynamic_slice_in_dim(q, s, qb))
            for s in range(0, nq + pad, qb)]
    cols = list(zip(*outs))
    if device_out:
        if len(outs) == 1:
            return tuple(c[0][:nq] for c in cols)
        return tuple(jnp.concatenate(c)[:nq] for c in cols)
    return tuple(np.concatenate([np.asarray(x) for x in c])[:nq]
                 for c in cols)


def search_batched(base, neighbors, eps, queries, k, L, metric=Metric.IP,
                   query_batch: int = 1024, **kw) -> Tuple:
    """Host wrapper: stream query batches of a fixed shape through the jit."""
    import numpy as np

    metric = Metric.parse(metric)
    nq = queries.shape[0]
    out_i = np.empty((nq, k), np.int32)
    out_d = np.empty((nq, k), np.float32)
    out_c = np.empty((nq,), np.int32)
    out_h = np.empty((nq,), np.int32)
    qb = min(query_batch, nq)
    for s in range(0, nq, qb):
        e = min(s + qb, nq)
        q = queries[s:e]
        if e - s < qb:
            q = np.concatenate(
                [q, np.zeros((qb - (e - s), q.shape[1]), np.float32)], axis=0)
        r = beam_search(base, neighbors, eps, jnp.asarray(q), k=k, L=L,
                        metric=metric, **kw)
        out_i[s:e] = np.asarray(r.ids)[: e - s]
        out_d[s:e] = np.asarray(r.dists)[: e - s]
        out_c[s:e] = np.asarray(r.cmps)[: e - s]
        out_h[s:e] = np.asarray(r.hops)[: e - s]
    return out_i, out_d, out_c, out_h
