"""mp-sharded fused-table serving — the 10M+ sublinear engine.

The single-device fused engine (search/fused.py) is the sublinear
serving mode at 1M-class scale, but its byte-row table grows with N
(bits=4, M=32, d=128 → 3 KB/row → 28.6 GB at 10M) and outgrows one
device's memory. This module row-shards the table over the ``mp`` mesh axis —
shard j owns rows [j·sn, (j+1)·sn) — and runs the SAME lockstep beam
replicated across ``mp`` with one owner-masked ``psum`` per step:

  1. every shard computes the step's expansion ids (replicated pool
     state — identical on every mp peer, no communication);
  2. the owner shard of each expanded node gathers its local byte
     row, unpacks + scores the inline int8/int4 neighbors
     (`_score_packed_rows` — the same traced helper the single-chip
     engine uses, so quantized scoring cannot drift);
  3. one ``psum`` over ``mp`` combines (dists, ids): each expansion has
     exactly ONE owner, so non-owners contribute exact zeros — f32
     addition with 0.0 is exact, which is what makes the sharded result
     bit-identical to the single-chip engine (test-pinned);
  4. pool merge runs replicated; queries shard over ``dp`` and never
     communicate.

Per-step traffic: [B/dp, expand·M] f32 + i32 ≈ KBs-to-MBs over NVLink
(see parallel/mesh.py for why ``mp`` must stay within a host). The
final exact-f32 rerank shards the base the same way (owner-masked ip
psum). The coarse seed sample stays REPLICATED — at 1-in-8 of a 10M
corpus it is 320 MB bf16 per device, noise next to the table shard; shard
it too if a >100M corpus ever needs it.

Reference parity: this serves the same RoarGraph the reference serves
single-host (src/index_bipartite.cpp:2311-2420); the sharding axis is
the device answer to "the index outgrew one memory" — which the
reference cannot do at all (single-node DRAM only).
"""

from __future__ import annotations

import functools
import time
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.search.fused import (_bitonic_merge_triple, _pack_chunk,
                                         _row_bytes, _score_packed_rows)
from mysteryann_tpu.search.seeding import make_seed_sample, seed_scan

_INF = jnp.float32(jnp.inf)


def _pack_shard_host(base_dev, nb: np.ndarray, lo: int, sn: int,
                     n_global: int, M: int, d: int, bits: int,
                     chunk: int = 16384) -> np.ndarray:
    """Pack rows [lo, lo+sn) of the global adjacency into one shard's
    byte-row table, on host: [sn+1, R/128, 128] u8, local sentinel last.

    Rows past the corpus (lo+i >= n_global) pack as sentinel rows —
    all-invalid ids, zero vectors — so mp-padding rows are inert. The
    host detour exists because the full table deliberately does NOT fit
    one device (that is the point of this module); each shard's slice is
    assembled here and `jax.device_put` ships it straight to its owner.
    """
    R = _row_bytes(M, d, bits)
    out = np.empty((sn + 1, R // 128, 128), np.uint8)
    sent = np.full((1, M), n_global, np.int32)
    for s in range(0, sn, chunk):
        c = min(chunk, sn - s)
        rows = np.full((c, M), n_global, np.int32)
        avail = max(0, min(lo + s + c, n_global) - (lo + s))
        if avail:
            rows[:avail] = nb[lo + s: lo + s + avail]
        p = _pack_chunk(base_dev, jnp.asarray(rows), n_base=n_global,
                        M=M, d=d, bits=bits)
        out[s: s + c] = np.asarray(p)
    out[sn] = np.asarray(_pack_chunk(base_dev, jnp.asarray(sent),
                                     n_base=n_global, M=M, d=d, bits=bits))[0]
    return out


@functools.lru_cache(maxsize=16)
def _sharded_fused_fn(mesh: Mesh, n: int, sn: int, k: int, L: int,
                      metric: Metric, max_hops: int, M: int, d: int,
                      expand: int, bits: int, rerank: int, seeded: bool):
    """Compile the shard_map'd fused beam (merge-mode pool update)."""
    is_l2 = metric == Metric.L2
    F = expand * M
    n_total = n + 2

    def local(table, b_shard, eps, q, seed_ids, seed_d):
        table = table[0]            # [sn+1, R/128, 128] (squeezed mp block)
        b_shard = b_shard[0]        # [sn, d]
        bl = q.shape[0]
        my = jax.lax.axis_index("mp")
        off = my * sn
        if is_l2:
            q_sq = jnp.sum(q * q, axis=1, keepdims=True)
        else:
            q_sq = None

        def owner_ip(ids, kk):
            """Exact f32 scores of global ids vs q — owner-masked psum."""
            mine = (ids >= off) & (ids < off + sn) & (ids < n)
            lid = jnp.where(mine, ids - off, 0)
            vecs = jnp.take(b_shard, lid.reshape(-1), axis=0).reshape(
                bl, kk, d)
            ip = jnp.einsum("bd,bkd->bk", q, vecs,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            if is_l2:
                loc = q_sq - 2.0 * ip + jnp.sum(vecs * vecs, 2)
            else:
                loc = -ip
            return jax.lax.psum(jnp.where(mine, loc, 0.0), "mp")

        # ---- pool seeding -------------------------------------------------
        if seeded:
            E = seed_ids.shape[1]
            ep_ids = seed_ids.astype(jnp.int32)
            ep_d = seed_d
        else:
            E = eps.shape[0]
            ep_ids = jnp.broadcast_to(eps[None, :], (bl, E)).astype(jnp.int32)
            ep_d = owner_ip(ep_ids, E)
        pad = L - E
        cand_ids = jnp.concatenate(
            [ep_ids, jnp.full((bl, pad), n_total, jnp.int32)], axis=1)
        cand_d = jnp.concatenate([ep_d, jnp.full((bl, pad), _INF)], axis=1)
        cand_exp = jnp.concatenate(
            [jnp.zeros((bl, E), jnp.bool_), jnp.ones((bl, pad), jnp.bool_)],
            axis=1)
        cand_d, cand_ids, cand_exp = jax.lax.sort(
            (cand_d, cand_ids, cand_exp), dimension=-1, num_keys=2)

        def cond(st):
            return jnp.logical_and(jnp.any(~st[2]), st[-1] < max_hops)

        def body(st):
            cand_ids, cand_d, cand_exp, cmps, hops, it = st
            unexp = ~cand_exp
            if expand == 1:
                has = jnp.any(unexp, axis=1)
                sel = jnp.argmax(unexp, axis=1)[:, None]
                sel_valid = has[:, None]
            else:
                rank = jnp.cumsum(unexp.astype(jnp.int32), axis=1) - 1
                onrank = unexp & (rank < expand)
                nsel = jnp.sum(onrank, axis=1)
                key = jnp.where(
                    onrank,
                    jax.lax.broadcasted_iota(jnp.int32, unexp.shape, 1),
                    jnp.int32(L + 1))
                sel = jax.lax.top_k(-key, expand)[0] * -1
                sel_valid = (sel <= L) & (jax.lax.broadcasted_iota(
                    jnp.int32, sel.shape, 1) < nsel[:, None])
                sel = jnp.minimum(sel, L - 1)
            b_i = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 0)
            cur = jnp.where(sel_valid, cand_ids[b_i, sel], n)
            cand_exp = cand_exp.at[b_i, jnp.where(sel_valid, sel, L)].set(
                True, mode="drop")

            # owner shard gathers + scores its rows; others hit the local
            # sentinel row (invalid ids, zero contribution)
            mine = (cur >= off) & (cur < off + sn) & (cur < n)
            lid = jnp.where(mine, cur - off, sn)
            rows = jnp.take(table, lid.reshape(-1), axis=0)
            nd_l, nbrs_l = _score_packed_rows(
                q, rows, metric, q_sq, B=bl, F=F, M=M, d=d, bits=bits,
                expand=expand)
            ownF = jnp.repeat(mine, M, axis=1)              # [bl, F]
            nd = jax.lax.psum(jnp.where(ownF, nd_l, 0.0), "mp")
            # ids via +1 bias: a no-owner column (global sentinel / OOR
            # id) psums to 0 → -1 → mapped to the invalid id below
            nbrs = jax.lax.psum(
                jnp.where(ownF, nbrs_l + 1, 0), "mp") - 1

            fresh = (nbrs >= 0) & (nbrs < n)
            nd = jnp.where(fresh, nd, _INF)
            new_ids = jnp.where(fresh, nbrs, n_total)
            cmps = cmps + jnp.sum(fresh, axis=1, dtype=jnp.int32)
            hops = hops + jnp.sum(sel_valid, axis=1, dtype=jnp.int32)

            # merge-mode pool update — identical to the single-chip
            # engine (search/fused.py): id-grouped dedup then resort
            all_d = jnp.concatenate([cand_d, nd], axis=1)
            all_i = jnp.concatenate([cand_ids, new_ids], axis=1)
            all_e = jnp.concatenate([cand_exp, ~fresh], axis=1)
            not_e = jnp.logical_not(all_e)
            all_i, not_e, all_d = jax.lax.sort(
                (all_i, not_e, all_d), dimension=-1, num_keys=3)
            dup = jnp.concatenate(
                [jnp.zeros((bl, 1), jnp.bool_),
                 all_i[:, 1:] == all_i[:, :-1]], axis=1)
            all_d = jnp.where(dup, _INF, all_d)
            all_i = jnp.where(dup, n_total, all_i)
            all_e = jnp.where(dup, True, jnp.logical_not(not_e))
            all_d, all_i, all_e = jax.lax.sort(
                (all_d, all_i, all_e), dimension=-1, num_keys=2)
            return (all_i[:, :L], all_d[:, :L], all_e[:, :L], cmps,
                    hops, it + 1)

        st = (cand_ids, cand_d, cand_exp,
              jnp.full((bl,), E, jnp.int32), jnp.zeros((bl,), jnp.int32),
              jnp.int32(0))
        cand_ids, cand_d, _, cmps, hops, _ = jax.lax.while_loop(
            cond, body, st)

        # exact f32 rerank of the pool head (sharded base, owner psum)
        kk = min(L, rerank or max(2 * k, k + 8) * (2 if bits == 4 else 1))
        head = cand_ids[:, :kk]
        valid = head < n
        ed = owner_ip(jnp.minimum(head, n - 1), kk)
        ed = jnp.where(valid, ed, _INF)
        ed, ei = jax.lax.sort((ed, head), dimension=-1, num_keys=2)
        dup = jnp.concatenate(
            [jnp.zeros((bl, 1), jnp.bool_), ei[:, 1:] == ei[:, :-1]], axis=1)
        ed = jnp.where(dup, _INF, ed)
        ed, ei = jax.lax.sort((ed, ei), dimension=-1, num_keys=2)
        return ei[:, :k], ed[:, :k], cmps, hops

    seed_spec = P("dp", None) if seeded else P()
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("mp", None, None, None), P("mp", None, None), P(),
                  P("dp", None), seed_spec, seed_spec),
        out_specs=(P("dp", None), P("dp", None), P("dp"), P("dp")),
        check_vma=False,
    ))


class ShardedFusedSearcher:
    """Fused byte-row serving with the table row-sharded over ``mp``.

    Bit-identical results to the single-chip `FusedSearcher` at the same
    parameters (merge mode; pinned in tests/test_sharded_fused.py) — the
    table shards hold the same packed rows, scoring runs through the same
    traced helper, and the owner-masked psum adds exact zeros.
    """

    def __init__(self, mesh: Mesh, index, base, max_degree: int = 0,
                 seed_sample: int = 0, bits: int = 8):
        self.mesh = mesh
        self.mp = mesh.shape["mp"]
        self.dp = mesh.shape["dp"]
        self.metric = index.metric
        base_dev = prepare_vectors(np.asarray(base, np.float32), self.metric)
        align = 8 if bits == 8 else 16
        pad_c = (align - base_dev.shape[1] % align) % align
        if pad_c:
            base_dev = jnp.pad(base_dev, ((0, 0), (0, pad_c)))
        self._col_pad = pad_c
        n, d = base_dev.shape
        nb = np.asarray(index.graph.neighbors)
        if max_degree and max_degree < nb.shape[1]:
            nb = nb[:, :max_degree]
        if nb.shape[1] % 16:
            nb = np.concatenate(
                [nb, np.full((n, 16 - nb.shape[1] % 16), n, nb.dtype)],
                axis=1)
        M = nb.shape[1]
        sn = -(-n // self.mp)
        R = _row_bytes(M, d, bits)
        # host-assembled shard tables → device_put lands each on its owner
        host = np.empty((self.mp, sn + 1, R // 128, 128), np.uint8)
        for j in range(self.mp):
            host[j] = _pack_shard_host(base_dev, nb, j * sn, sn, n, M, d,
                                       bits)
        self.table = jax.device_put(
            host, NamedSharding(mesh, P("mp", None, None, None)))
        del host
        # rerank base, same row split (zero rows pad the tail shard).
        # Assembled from a HOST-side prepared copy — downloading the
        # multi-GB device array back would ride the slow device->host
        # path at exactly the 10M+ scale this module targets
        # (BASELINE.md transfer-path note); the metric preprocessing
        # (f32 cast + cosine row-normalize + column pad) is cheap in
        # numpy and bit-matches prepare_vectors'.
        b_np = np.asarray(base, np.float32)
        if self.metric == Metric.COSINE:
            # same formula as ops.distances.normalize_rows (sqrt-of-sum
            # in f32, eps=1e-12) so the shards bit-match prepare_vectors
            norms = np.sqrt(np.sum(b_np * b_np, axis=1, keepdims=True,
                                   dtype=np.float32))
            b_np = (b_np / np.maximum(norms, np.float32(1e-12))
                    ).astype(np.float32)
        if pad_c:
            b_np = np.pad(b_np, ((0, 0), (0, pad_c)))
        bh = np.zeros((self.mp, sn, d), np.float32)
        for j in range(self.mp):
            lo = j * sn
            avail = max(0, min(lo + sn, n) - lo)
            bh[j, :avail] = b_np[lo: lo + avail]
        del b_np
        self.base_sh = jax.device_put(
            bh, NamedSharding(mesh, P("mp", None, None)))
        del bh
        self._samp = (make_seed_sample(base_dev, seed_sample)
                      if seed_sample else None)
        self.eps = jnp.asarray([index.graph.ep], jnp.int32)
        self.n, self.d, self.M, self.sn, self.bits = n, d, M, sn, bits

    def search(self, queries, k: int, L: int, expand: int = 1,
               seeds: int = 0, max_hops: int = 0, rerank: int = 0,
               device_out: bool = False):
        if seeds and self._samp is None:
            raise ValueError("seeds > 0 needs seed_sample=r at init")
        if seeds > L:
            raise ValueError(f"seeds ({seeds}) must be <= L ({L})")
        if k > L:
            raise ValueError(f"k ({k}) must be <= L ({L})")
        q = prepare_vectors(np.asarray(queries, np.float32), self.metric)
        if self._col_pad:
            q = jnp.pad(q, ((0, 0), (0, self._col_pad)))
        nq = q.shape[0]
        pad = (-nq) % self.dp
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, self.d), jnp.float32)])
        q = jax.device_put(q, NamedSharding(self.mesh, P("dp", None)))
        seed_ids = seed_d = None
        if seeds:
            seed_ids, seed_d = seed_scan(*self._samp, q, n_seeds=seeds,
                                         metric=self.metric)
        fn = _sharded_fused_fn(
            self.mesh, self.n, self.sn, k, L, self.metric,
            max_hops or 4 * L + 32, self.M, self.d, expand, self.bits,
            rerank, seeds > 0)
        z = jnp.zeros((q.shape[0], 1), jnp.float32)  # dummy when unseeded
        out = fn(self.table, self.base_sh, self.eps, q,
                 seed_ids if seeds else z.astype(jnp.int32),
                 seed_d if seeds else z)
        if device_out:
            return tuple(o[:nq] for o in out)
        ids, dists, cmps, hops = (np.asarray(o)[:nq] for o in out)
        return ids.astype(np.int32), dists, cmps, hops

    def benchmark(self, queries, k: int, L: int, warmup: int = 1,
                  **kw) -> dict:
        for _ in range(warmup):
            jax.block_until_ready(
                self.search(queries, k, L, device_out=True, **kw))
        t0 = time.perf_counter()
        out = self.search(queries, k, L, device_out=True, **kw)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (np.asarray(o) for o in out)
        return {"L_pq": L, "k": k, "qps": len(ids) / dt,
                "avg_cmps": float(cmps.mean()),
                "avg_hops": float(hops.mean()),
                "ids": ids.astype(np.int32), "dists": dists}
