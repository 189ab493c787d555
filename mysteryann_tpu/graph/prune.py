"""Batched occlusion pruning — the RoarGraph edge-selection rule, batched.

All four reference prune functions share one shape (reference
src/index_bipartite.cpp: PruneBiSearchBaseGetBase:1612-1694,
PruneProjectionReverseCandidates:1527-1610,
PruneProjectionInternalReverseCandidates:1434-1525,
PruneProjectionBaseSearchCandidates:1846-1940):

1. dedup candidates, drop the source node, sort by (distance-to-source, id);
2. greedy scan: keep candidate ``p`` unless some already-kept ``t`` has
   ``d(p, t) < d(p, src)`` (the occlusion rule), until ``cap`` kept;
3. optional fill pass: append closest occluded candidates until ``cap``;
4. the connectivity-pass variant refuses to *seed* the kept set with a
   candidate already present in the node's projection list, and its
   pass 1 never revisits entries positioned before the chosen seed
   (src/index_bipartite.cpp:1857-1864);
5. the reference's "second pass" re-scans from the start with the
   identical factor-1.0 rule. For the phase-A prune
   (PruneBiSearchBaseGetBase:1658-1683) pass 1 already visited every
   position, so it is semantically inert. For the connectivity-pass
   variant (:1897-1931) it is NOT: entries skipped before the seed —
   including the node's existing projection neighbors — get a second
   chance against the pass-1 kept set. ``two_pass=True`` reproduces
   that: a second keep-driven scan over the full candidate set,
   continuing from pass 1's kept/occluded state.

The scan is inherently sequential in the kept set (SURVEY §7 hard part #2),
but only ``C`` steps long; it runs as a ``fori_loop`` over a precomputed
candidate-pairwise distance tile ``[B, C, C]`` so the whole batch prunes in
lockstep with all distances coming from one batched matmul. Distances
are taken at full f32 precision (``Precision.HIGHEST``), as the
reference computes them: the [B, C, C] tile is small, so the cost is
low, and reduced-precision passes would flip near-tie keep decisions.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from mysteryann_tpu.ops.distances import Metric

_INF = jnp.float32(jnp.inf)


@partial(jax.jit,
         static_argnames=("cap", "metric", "fill", "two_pass", "gather_fn",
                          "n_base"))
def batched_occlusion_prune(
    src_vecs: jax.Array,     # f32 [B, d] — the node whose list is being built
    src_ids: jax.Array,      # i32 [B] — its id (excluded from candidates)
    cand_ids: jax.Array,     # i32 [B, C] — sentinel >= N marks empty slots
    cand_dists: jax.Array,   # f32 [B, C] — distance(candidate, src)
    base: jax.Array | None,  # f32 [N, d]; None with gather_fn + n_base
    cap: int,
    metric: Metric = Metric.IP,
    fill: bool = True,
    not_seedable: jax.Array | None = None,  # bool [B, C]
    two_pass: bool = False,
    gather_fn=None,          # flat ids [K] -> vecs [K, d]; default = base
    n_base: int = 0,         # N when base is None (sharded callers)
    cand_vecs: jax.Array | None = None,  # f32 [B, C], pre-gathered rows
) -> Tuple[jax.Array, jax.Array]:
    """Return (pruned_ids i32 [B, cap] sentinel-padded, counts i32 [B]).

    ``gather_fn`` decouples the scan from vector storage so sharded
    callers (parallel.sharded_build — base row-sharded over ``mp``,
    vectors fetched by owner-masked psum) run the IDENTICAL keep-scan:
    single-device and sharded results agree wherever their distances
    do (see parallel/sharded_build.py for where they need not).

    ``cand_vecs`` ([B, C, d], aligned with ``cand_ids``) reuses the
    candidate rows a caller already fetched (dists_to_src
    ``return_vecs=True``): the row gather is the main memory cost of
    the prune phases, and without this every batch fetched the
    same B*C rows twice. The in-tensor reorder by the sort permutation
    yields bit-identical vectors to a post-sort gather.
    """
    metric = Metric.parse(metric)
    n = base.shape[0] if base is not None else n_base
    assert n > 0, "need base or n_base"
    B, C = cand_ids.shape

    valid = (cand_ids < n) & (cand_ids != src_ids[:, None]) & (cand_ids >= 0)
    d_sorted_key = jnp.where(valid, cand_dists, _INF)
    seed_block = (jnp.zeros((B, C), jnp.bool_)
                  if not_seedable is None else not_seedable)

    # sort by (dist, id); invalid slots sink to the end. The iota rides
    # along as the permutation for reordering pre-gathered vectors.
    perm0 = jax.lax.broadcasted_iota(jnp.int32, (B, C), 1)
    d_s, id_s, seedblk_s, perm = jax.lax.sort(
        (d_sorted_key, cand_ids, seed_block, perm0),
        dimension=-1, num_keys=2)
    valid_s = jnp.isfinite(d_s)
    # dedup: same id ⇒ same dist ⇒ adjacent after the sort
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.bool_), id_s[:, 1:] == id_s[:, :-1]], axis=1)
    valid_s = valid_s & ~dup

    # candidate-pairwise distances [B, C, C] — one batched contraction.
    # clip BOTH ends: the valid mask admits negative ids as input
    if cand_vecs is not None:
        vecs = jnp.take_along_axis(cand_vecs, perm[:, :, None], axis=1)
    else:
        flat_ids = jnp.clip(id_s, 0, n - 1).reshape(-1)
        if gather_fn is None:
            vecs = jnp.take(base, flat_ids, axis=0)
        else:
            vecs = gather_fn(flat_ids)
        vecs = vecs.reshape(B, C, vecs.shape[-1])                 # [B, C, d]
    ip = jnp.einsum("bcd,bed->bce", vecs, vecs,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if metric in (Metric.IP, Metric.COSINE):
        pd = -ip
    else:
        sq = jnp.sum(vecs * vecs, axis=-1)
        pd = jnp.maximum(sq[:, :, None] - 2.0 * ip + sq[:, None, :], 0.0)

    seedable_s = ~seedblk_s

    # Keep-driven scan: the sequential sorted-order walk keeps at most
    # `cap` candidates, and occlusion only grows — so iterating "keep the
    # first available candidate, occlude its shadow" `cap` times visits
    # exactly the same keep set as walking all C positions (a candidate
    # occluded when the walk passes it can never become keepable later).
    # cap (~32) iterations instead of C (~hundreds).
    b_iota = jnp.arange(B)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, C), 1)

    # seed first (reference :1861-1864): the walk skips not-seedable
    # candidates while the kept set is empty — and a skip at one's turn
    # is PERMANENT, so not-seedable candidates positioned before the
    # seed stay excluded even after seeding
    avail0 = valid_s & seedable_s
    has0 = jnp.any(avail0, axis=1)
    j0 = jnp.argmax(avail0, axis=1)                                # [B]
    kept0 = jnp.zeros((B, C), jnp.bool_).at[
        b_iota, jnp.where(has0, j0, C)].set(True, mode="drop")
    # pass 1 never revisits entries before the seed (reference
    # :1857-1866: the seed-skip `while` advances past them permanently).
    # A row with NO seedable candidate keeps nothing in pass 1 — the
    # reference's skip loop runs off the end (pre_seed covers every
    # position then, excluding all not-seedable entries)
    valid_all = valid_s
    pre_seed = jnp.where(has0[:, None], pos < j0[:, None], True)
    valid_s = valid_s & ~(seedblk_s & pre_seed)
    pd0 = jnp.take_along_axis(pd, j0[:, None, None], axis=1)[:, 0]
    occ0 = has0[:, None] & (pd0 < d_s)

    def make_keep_step(valid_mask):
        def keep_step(i, carry):
            kept, occ, cnt = carry
            avail = valid_mask & ~occ & ~kept
            has = jnp.any(avail, axis=1)
            j = jnp.argmax(avail, axis=1)                          # [B]
            do = has & (cnt < cap)
            kept = kept.at[b_iota, jnp.where(do, j, C)].set(
                True, mode="drop")
            # future candidate c is occluded by kept j if pd[j, c] < d[c]
            pdj = jnp.take_along_axis(
                pd, j[:, None, None], axis=1)[:, 0]                # [B, C]
            occ = occ | (do[:, None] & (pdj < d_s))
            return kept, occ, cnt + do.astype(jnp.int32)
        return keep_step

    kept, occ, cnt = jax.lax.fori_loop(
        1, cap, make_keep_step(valid_s),
        (kept0, occ0, has0.astype(jnp.int32)))
    if two_pass:
        # reference second pass (:1897-1931): re-scan from the start —
        # pre-seed-skipped entries get a chance against the pass-1 kept
        # set; everything pass 1 occluded stays occluded
        kept, occ, cnt = jax.lax.fori_loop(
            0, cap, make_keep_step(valid_all), (kept, occ, cnt))

    # order: kept candidates (sorted) first, then (if fill) valid
    # non-kept — drawn from the FULL valid set (the reference's fill
    # pass :1685-1691 iterates every candidate; pre-seed-skipped
    # entries are fillable even though pass 1 could not keep them)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, C), 1)
    if fill:
        key = jnp.where(kept, pos, jnp.where(valid_all, pos + C, 2 * C))
    else:
        key = jnp.where(kept, pos, 2 * C)
    order_key, out_ids = jax.lax.sort((key, id_s), dimension=-1, num_keys=1)
    out_ids = jnp.where(order_key[:, :cap] < 2 * C,
                        out_ids[:, :cap], jnp.int32(n))
    counts = jnp.sum(out_ids[:, :cap] < n, axis=1, dtype=jnp.int32)
    return out_ids, counts


@partial(jax.jit, static_argnames=("metric", "gather_fn", "n_base",
                                   "return_vecs"))
def dists_to_src(src_vecs: jax.Array, cand_ids: jax.Array,
                 base: jax.Array | None,
                 metric: Metric = Metric.IP, gather_fn=None,
                 n_base: int = 0, return_vecs: bool = False):
    """distance(candidate[b, c], src[b]) for prune inputs; [B, C].

    ``return_vecs=True`` also returns the gathered candidate rows
    [B, C, d] so the caller can hand them to `batched_occlusion_prune`
    (``cand_vecs=``) instead of re-fetching the same rows.
    """
    metric = Metric.parse(metric)
    n = base.shape[0] if base is not None else n_base
    flat = jnp.clip(cand_ids, 0, n - 1).reshape(-1)
    vecs = (jnp.take(base, flat, axis=0) if gather_fn is None
            else gather_fn(flat)).reshape(
        cand_ids.shape + (src_vecs.shape[-1],))
    ip = jnp.einsum("bcd,bd->bc", vecs, src_vecs,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if metric in (Metric.IP, Metric.COSINE):
        d = -ip
    else:
        sq_c = jnp.sum(vecs * vecs, axis=-1)
        sq_s = jnp.sum(src_vecs * src_vecs, axis=-1, keepdims=True)
        d = jnp.maximum(sq_c - 2.0 * ip + sq_s, 0.0)
    d = jnp.where((cand_ids >= 0) & (cand_ids < n), d, _INF)
    return (d, vecs) if return_vecs else d
