"""Multi-device search.

Two scaling modes (SURVEY §2's accelerator-equivalents note):

- `query_parallel_search`: the index fits one device → replicate base+graph,
  shard the query stream over every device (pure DP — the analogue of the
  reference's `omp parallel for` over queries,
  tests/test_search_roargraph.cpp:203-209).

- `distributed_beam_search`: the index does NOT fit one device (T2I-100M
  class) → base vectors and the padded adjacency are row-sharded over the
  ``mp`` mesh axis, queries sharded over ``dp``. Each lockstep expansion:

    1. the owner shard of the expanded node contributes its neighbor row;
       one ``psum`` over ``mp`` broadcasts it (int32 [B, M] — KBs);
    2. every shard gathers vectors only for the neighbor ids *it owns*,
       computes partial distances, and a second ``psum`` combines them
       (f32 [B, M]) — vectors never leave their shard, only distances do;
    3. pool merge + visited-bitmask update run replicated per dp-shard
       (cheap sort; identical on every mp peer, no extra comm).

  The per-node mutexes of the reference have no analogue: state is
  functional and each query's pool is private.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mysteryann_tpu.ops.distances import Metric
from mysteryann_tpu.search.beam import SearchResult, _scatter_or_bits, beam_search

_INF = jnp.float32(jnp.inf)


def query_parallel_search(
    mesh: Mesh, base, neighbors, eps, queries, k: int, L: int,
    metric: Metric = Metric.IP, **kw,
) -> SearchResult:
    """DP-only: replicate index, shard queries over the whole mesh."""
    q = jax.device_put(queries, NamedSharding(mesh, P(("dp", "mp"), None)))
    b = jax.device_put(base, NamedSharding(mesh, P()))
    nb = jax.device_put(neighbors, NamedSharding(mesh, P()))
    return beam_search(b, nb, eps, q, k=k, L=L, metric=metric, **kw)


def distributed_beam_search(
    mesh: Mesh,
    base,          # [N, d] — sharded over "mp" rows
    neighbors,     # [N, M] int32, global neighbor ids, sentinel >= N
    eps,           # [E] int32 entry points
    queries,       # [B, d] — sharded over "dp"
    k: int,
    L: int,
    metric: Metric = Metric.IP,
    max_hops: int = 0,
    visited_mode: str = "bitmask",
    collect_expanded: int = 0,
    expand: int = 1,
) -> SearchResult:
    """``visited_mode``: "bitmask" keeps the exact per-query visited
    bitmask (``[B, N/32]`` HBM per dp shard — fine to ~10M); "merge"
    drops it and dedups re-encountered ids inside the pool merge (the
    single-chip engine's proof of equivalence, search/beam.py docstring,
    carries over unchanged) — the only option at 100M-class N, where a
    bitmask would cost ~12.5 MB per in-flight query; "pool" tests
    membership against the candidate pool only (see beam.py — the mode
    the connectivity pass traverses with).

    ``collect_expanded=H`` returns the expansion history
    (reference full_retset) like `beam_search` — required by the sharded
    build's phase D.

    ``expand``: nodes popped per lockstep step (the single-chip engine's
    knob — pool-maintenance sorts amortize over `expand` expansions).
    Selection/merge logic mirrors `beam_search` exactly, so traversal is
    bit-identical to the single-device engine at every expand on the CPU
    (pinned by tests/test_sharded_build.py). On GPUs the psum'd
    distances may round differently (parallel/sharded_build.py), which
    reorders near-ties."""
    metric = Metric.parse(metric)
    if visited_mode not in ("bitmask", "merge", "pool"):
        raise ValueError(f"unknown visited_mode {visited_mode!r}")
    n, d = base.shape
    B = queries.shape[0]
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    if n % mp or B % dp:
        raise ValueError(f"mp ({mp}) must divide N ({n}); dp ({dp}) "
                         f"must divide B ({B})")
    E = int(np.asarray(eps).shape[0])
    if L < E:
        # mirrors the single-chip engine's guard; without it the pool
        # seeding pads with a negative width deep inside shard_map
        raise ValueError(f"L ({L}) must be >= number of entry points "
                         f"E ({E})")
    if max_hops <= 0:
        max_hops = 4 * L + 32
    fn = _dist_search_fn(mesh, n, n // mp, k, L, metric, max_hops,
                         visited_mode, collect_expanded, expand)
    q = jax.device_put(queries, NamedSharding(mesh, P("dp", None)))
    b = jax.device_put(base, NamedSharding(mesh, P("mp", None)))
    nb = jax.device_put(neighbors, NamedSharding(mesh, P("mp", None)))
    ids, dists, cmps, hops, hist_ids, hist_d = fn(
        q, b, nb, jnp.asarray(eps, jnp.int32))
    return SearchResult(
        ids=ids, dists=dists, cmps=cmps, hops=hops,
        hist_ids=hist_ids if collect_expanded > 0 else None,
        hist_d=hist_d if collect_expanded > 0 else None)


@functools.lru_cache(maxsize=32)
def _dist_search_fn(mesh: Mesh, n: int, shard_n: int, k: int, L: int,
                    metric: Metric, max_hops: int, visited_mode: str,
                    collect_expanded: int, expand: int = 1):
    use_merge = visited_mode == "merge"
    use_pool = visited_mode == "pool"
    n_words = -(-n // 32) if visited_mode == "bitmask" else 1
    is_l2 = metric == Metric.L2
    H = max(collect_expanded, 1)

    def local(q, b_shard, nb_shard, eps):
        bl = q.shape[0]
        E = eps.shape[0]
        my = jax.lax.axis_index("mp")
        off = my * shard_n
        b_sq = jnp.sum(b_shard * b_shard, axis=-1)
        q_sq = jnp.sum(q * q, axis=-1)

        def gather_rows(ids):           # ids [bl, e] global -> [bl, e, M]
            owned = (ids >= off) & (ids < off + shard_n)
            loc = jnp.take(nb_shard, jnp.clip(ids - off, 0, shard_n - 1),
                           axis=0)
            contrib = jnp.where(owned[..., None], loc, 0)
            rows = jax.lax.psum(contrib, "mp")
            return jnp.where((ids < n)[..., None], rows, n)

        def dist_to_q(ids):             # ids [bl, M] global -> [bl, M]
            owned = (ids >= off) & (ids < off + shard_n)
            loc_ids = jnp.clip(ids - off, 0, shard_n - 1)
            vecs = jnp.take(b_shard, loc_ids, axis=0)      # [bl, M, d]
            ip = jnp.einsum("bd,bmd->bm", q, vecs,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            if is_l2:
                dloc = q_sq[:, None] - 2.0 * ip + b_sq[loc_ids]
            else:
                dloc = -ip
            return jax.lax.psum(jnp.where(owned, dloc, 0.0), "mp")

        # seed pool
        ep_ids = jnp.broadcast_to(eps[None, :], (bl, E)).astype(jnp.int32)
        ep_d = dist_to_q(ep_ids)
        pad = L - E
        cand_ids = jnp.concatenate(
            [ep_ids, jnp.full((bl, pad), n, jnp.int32)], axis=1)
        cand_d = jnp.concatenate([ep_d, jnp.full((bl, pad), _INF)], axis=1)
        cand_exp = jnp.concatenate(
            [jnp.zeros((bl, E), jnp.bool_), jnp.ones((bl, pad), jnp.bool_)],
            axis=1)
        cand_d, cand_ids, cand_exp = jax.lax.sort(
            (cand_d, cand_ids, cand_exp), dimension=-1, num_keys=2)
        visited = jnp.zeros((bl, n_words), jnp.uint32)
        if visited_mode == "bitmask":
            visited = _scatter_or_bits(
                visited, ep_ids >> 5,
                jnp.uint32(1) << (ep_ids & 31).astype(jnp.uint32),
                ep_ids < n)
        hist_ids0 = jnp.full((bl, H), n, jnp.int32)
        hist_d0 = jnp.full((bl, H), _INF)

        def cond(st):
            return jnp.logical_and(jnp.any(~st[2]), st[-1] < max_hops)

        def body(st):
            (cand_ids, cand_d, cand_exp, visited, cmps, hops,
             hist_ids, hist_d, it) = st
            # -- pick the `expand` closest unexpanded entries per query --
            # (mirrors search/beam.py body exactly, incl. the expand==1
            # fast path — bit-identity with the single-chip engine is the
            # sharded build's exactness contract)
            unexp = ~cand_exp
            has = jnp.any(unexp, axis=1)
            if expand == 1:
                sel = jnp.argmax(unexp, axis=1)[:, None]      # [bl, 1]
                sel_valid = has[:, None]
            else:
                rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1) - 1
                onrank = unexp & (rank < expand)
                nsel = jnp.sum(onrank, axis=1)                # [bl]
                key = jnp.where(
                    onrank,
                    jax.lax.broadcasted_iota(jnp.int32, unexp.shape, 1),
                    jnp.int32(L + 1))
                sel = jax.lax.top_k(-key, expand)[0] * -1     # [bl, e]
                sel_valid = sel <= L
                sel = jnp.minimum(sel, L - 1)
                sel_valid = sel_valid & (jax.lax.broadcasted_iota(
                    jnp.int32, sel.shape, 1) < nsel[:, None])
            b_i = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 0)
            cur = jnp.where(sel_valid, cand_ids[b_i, sel], n)  # [bl, e]
            if collect_expanded > 0:
                cur_d = jnp.where(sel_valid, cand_d[b_i, sel], _INF)
                pos = hops[:, None] + jax.lax.broadcasted_iota(
                    jnp.int32, sel.shape, 1)
                pos = jnp.where(sel_valid, pos, H)  # H = OOB → dropped
                hist_ids = hist_ids.at[b_i, pos].set(cur, mode="drop")
                hist_d = hist_d.at[b_i, pos].set(cur_d, mode="drop")
            cand_exp = cand_exp.at[b_i, jnp.where(sel_valid, sel, L)].set(
                True, mode="drop")

            nbrs = gather_rows(cur).reshape(bl, -1)          # [bl, e*M]
            in_b = nbrs < n
            nb_c = jnp.where(in_b, nbrs, 0)
            if use_merge:
                fresh = in_b
            else:
                if use_pool:
                    seen = jnp.any(
                        nbrs[:, :, None] == cand_ids[:, None, :], axis=2)
                else:
                    words = nb_c >> 5
                    bits = jnp.uint32(1) << (nb_c & 31).astype(jnp.uint32)
                    seen = (visited[jnp.arange(bl)[:, None], words]
                            & bits) != 0
                f_iota = jax.lax.broadcasted_iota(jnp.int32, nbrs.shape, 1)
                sv, si = jax.lax.sort((nbrs, f_iota), dimension=-1,
                                      num_keys=1)
                dups = jnp.concatenate(
                    [jnp.zeros((bl, 1), jnp.bool_), sv[:, 1:] == sv[:, :-1]],
                    axis=1)
                first = jnp.zeros_like(in_b).at[
                    jnp.arange(bl)[:, None], si].set(~dups)
                fresh = in_b & ~seen & first
                if not use_pool:
                    visited = _scatter_or_bits(visited, words, bits, fresh)

            nd = jnp.where(fresh, dist_to_q(nb_c), _INF)
            new_ids = jnp.where(fresh, nbrs, n)
            cmps = cmps + jnp.sum(fresh, axis=1, dtype=jnp.int32)
            hops = hops + jnp.sum(sel_valid, axis=1, dtype=jnp.int32)

            all_d = jnp.concatenate([cand_d, nd], axis=1)
            all_i = jnp.concatenate([cand_ids, new_ids], axis=1)
            all_e = jnp.concatenate([cand_exp, ~fresh], axis=1)
            if use_merge:
                # id-grouped dedup (see beam.py "merge" mode): keep the
                # first copy of every id run — expanded copies win, else
                # the best distance — then resort by distance
                not_e = jnp.logical_not(all_e)
                all_i, not_e, all_d = jax.lax.sort(
                    (all_i, not_e, all_d), dimension=-1, num_keys=3)
                dup = jnp.concatenate(
                    [jnp.zeros((bl, 1), jnp.bool_),
                     all_i[:, 1:] == all_i[:, :-1]], axis=1)
                all_d = jnp.where(dup, _INF, all_d)
                all_i = jnp.where(dup, n, all_i)
                all_e = jnp.where(dup, True, jnp.logical_not(not_e))
            all_d, all_i, all_e = jax.lax.sort(
                (all_d, all_i, all_e), dimension=-1, num_keys=2)
            return (all_i[:, :L], all_d[:, :L], all_e[:, :L], visited,
                    cmps, hops, hist_ids, hist_d, it + 1)

        st = (cand_ids, cand_d, cand_exp, visited,
              jnp.full((bl,), E, jnp.int32), jnp.zeros((bl,), jnp.int32),
              hist_ids0, hist_d0, jnp.int32(0))
        (cand_ids, cand_d, _, _, cmps, hops,
         hist_ids, hist_d, _) = jax.lax.while_loop(cond, body, st)
        return (cand_ids[:, :k], cand_d[:, :k], cmps, hops,
                hist_ids, hist_d)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("dp", None), P("mp", None), P("mp", None), P()),
        out_specs=(P("dp", None), P("dp", None), P("dp"), P("dp"),
                   P("dp", None), P("dp", None)),
        check_vma=False,
    ))
