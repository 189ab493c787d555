"""Bipartite index variant (NeurIPS'23 OOD-track style).

Reproduces the reference's `BuildBipartite`/`qbaseNNbipartite`
(reference src/index_bipartite.cpp:42-141, 235-280) and two-hop
`SearchBipartiteGraph` (:282-356):

- node id space is global: bases ``0..N-1``, training queries ``N..N+Nq-1``
  (reference index_bipartite.h:140-150);
- each query node gets edges to its kNN bases (list truncated to
  ``M_pjbp``) *excluding* the top-1 (:264-269);
- only the top-1 base gets a reverse edge back to the query (:270-273) —
  base in-degree is unbounded in the reference; here base rows are padded
  to the observed max (or an optional cap, closest queries kept);
- search seeds 10 random base points and expands two hops per pop
  (base→query→base, :291-294, :324-341).

Persistence matches the reference bipartite Save/Load format
(:2045-2071): ``[total_pts u32]`` then per node ``[deg u32][ids…]``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.search.beam import beam_search, run_query_batches
from mysteryann_tpu.utils.params import BuildConfig
from mysteryann_tpu.index import register_index


@dataclasses.dataclass
@register_index("bipartite")
class BipartiteIndex:
    neighbors: np.ndarray   # int32 [N+Nq, W], sentinel = N+Nq
    n_base: int
    metric: Metric
    dim: int

    @property
    def n_total(self) -> int:
        return self.neighbors.shape[0]

    def save(self, path: str) -> None:
        from mysteryann_tpu import native
        n_total = self.n_total
        nb = np.ascontiguousarray(self.neighbors, np.int32)
        L = native.lib()
        if L is not None:
            import ctypes
            rc = L.msann_save_bipartite(
                path.encode(), n_total,
                nb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                nb.shape[1])
            if rc != 0:
                raise OSError(f"native save failed ({rc}) for {path}")
        else:
            valid = nb < n_total
            with open(path, "wb") as f:
                f.write(struct.pack("<I", n_total))
                for i in range(n_total):
                    row = nb[i, valid[i]].astype(np.uint32)
                    f.write(struct.pack("<I", row.size))
                    row.tofile(f)
        with open(path + ".meta.json", "w") as f:
            json.dump({"metric": self.metric.value, "dim": self.dim,
                       "n_base": self.n_base}, f)

    @classmethod
    def load(cls, path: str, n_base: Optional[int] = None,
             metric: Metric | str | None = None, dim: int = 0):
        from mysteryann_tpu import native
        meta = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        L = native.lib()
        if L is not None:
            import ctypes
            nt = ctypes.c_uint32()
            md = ctypes.c_uint32()
            rc = L.msann_scan_bipartite(path.encode(), ctypes.byref(nt),
                                        ctypes.byref(md))
            if rc == -22:
                raise ValueError(
                    f"{path}: trailing bytes in bipartite graph file")
            if rc != 0:
                raise OSError(f"native scan failed ({rc}) for {path}")
            n_total = int(nt.value)
            nb = np.empty((n_total, max(int(md.value), 1)), np.int32)
            rc = L.msann_load_bipartite(
                path.encode(),
                nb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                n_total, nb.shape[1])
            if rc != 0:
                raise OSError(f"native load failed ({rc}) for {path}")
            return cls(neighbors=nb,
                       n_base=int(n_base or meta.get("n_base", 0)),
                       metric=Metric.parse(metric or meta.get("metric", "ip")),
                       dim=int(dim or meta.get("dim", 0)))
        with open(path, "rb") as f:
            (n_total,) = struct.unpack("<I", f.read(4))
            payload = np.fromfile(f, dtype=np.uint32)
        lists, off, maxdeg = [], 0, 1
        for _ in range(n_total):
            deg = int(payload[off]); off += 1
            lists.append(payload[off:off + deg].astype(np.int32)); off += deg
            maxdeg = max(maxdeg, deg)
        if off != payload.size:
            raise ValueError(f"{path}: trailing bytes in bipartite graph file")
        nb = np.full((n_total, maxdeg), n_total, np.int32)
        for i, row in enumerate(lists):
            nb[i, : row.size] = row
        # explicit arguments win over the sidecar (a stale meta file must
        # not silently override a caller-supplied n_base — the base/query
        # id split decides which nodes can be returned as results)
        return cls(neighbors=nb,
                   n_base=int(n_base or meta.get("n_base", 0)),
                   metric=Metric.parse(metric or meta.get("metric", "ip")),
                   dim=int(dim or meta.get("dim", 0)))


def build_bipartite(
    base: np.ndarray,
    train_queries: np.ndarray,
    learn_base_knn: np.ndarray,
    cfg: BuildConfig = BuildConfig(),
    base_row_cap: int = 0,
) -> BipartiteIndex:
    """Materialize the bipartite graph from the loaded kNN.

    ``base_row_cap > 0`` bounds base in-degree (closest queries kept) to
    keep the padded tensor narrow on very skewed datasets; 0 = unbounded
    like the reference.
    """
    metric = Metric.parse(cfg.metric)
    n = base.shape[0]
    nq = train_queries.shape[0]
    n_total = n + nq
    knn = np.asarray(learn_base_knn[:, : cfg.M_pjbp], np.int64)

    # query rows: kNN minus every occurrence of the top-1 target
    tgt = knn[:, 0]
    q_rows = np.where(knn == tgt[:, None], n_total, knn).astype(np.int32)
    q_rows = q_rows[:, 1:]  # column 0 IS the target — always sentinel
    # left-compact
    order = np.argsort(q_rows == n_total, axis=1, kind="stable")
    q_rows = np.take_along_axis(q_rows, order, axis=1)

    # base rows: reverse edge from each query to its top-1 base
    counts = np.bincount(tgt, minlength=n)
    width_base = int(counts.max()) if counts.size else 1
    if base_row_cap > 0:
        width_base = min(width_base, base_row_cap)
    if base_row_cap > 0:
        # closest-first: order queries by distance to their target.
        # All-host math (an nq-row gather + per-row dots): uploading the
        # full base/query matrices to compute this was pure transfer
        # waste at 10M scale.
        a = base[tgt].astype(np.float32, copy=False)
        qd = np.asarray(train_queries, np.float32)
        if metric == Metric.COSINE:  # normalize_rows parity (eps 1e-12)
            a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True),
                               1e-12)
            qd = qd / np.maximum(np.linalg.norm(qd, axis=1, keepdims=True),
                                 1e-12)
        ip = np.einsum("ij,ij->i", a, qd)
        dist = (-ip if metric in (Metric.IP, Metric.COSINE)
                else ((a - qd) ** 2).sum(axis=1))
        order = np.lexsort((dist, tgt))
    else:
        order = np.argsort(tgt, kind="stable")
    ts = tgt[order]
    qs = order + n  # global query ids, in insertion (or distance) order
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(ts, minlength=n), out=offs[1:])
    rank = np.arange(ts.size, dtype=np.int64) - offs[ts]
    keep = rank < width_base
    b_rows = np.full((n, width_base), n_total, np.int32)
    b_rows[ts[keep], rank[keep]] = qs[keep].astype(np.int32)

    width = max(width_base, q_rows.shape[1])
    nb = np.full((n_total, width), n_total, np.int32)
    nb[:n, :width_base] = b_rows
    nb[n:, : q_rows.shape[1]] = q_rows
    return BipartiteIndex(neighbors=nb, n_base=n, metric=metric,
                          dim=base.shape[1])


class BipartiteSearcher:
    """Two-hop search over the bipartite graph (reference :282-356)."""

    def __init__(self, index: BipartiteIndex, base: np.ndarray, seed: int = 0,
                 n_init: int = 10):
        self.metric = index.metric
        self.base = prepare_vectors(base, self.metric)
        self.neighbors = jnp.asarray(index.neighbors)
        self.n_base = index.n_base
        rng = np.random.default_rng(seed)
        # the reference draws 10 fresh random seeds per query; one fixed
        # draw per searcher keeps the batch in lockstep. Unlike the
        # reference we draw only among base nodes that HAVE in-edges: on
        # sparse training coverage (Nq < N) most base rows are empty, and
        # an all-empty draw would dead-end every query in the batch (the
        # reference's per-query redraws merely make that failure rare).
        deg = (np.asarray(index.neighbors[: index.n_base])
               < index.n_total).sum(axis=1)
        pool = np.nonzero(deg > 0)[0]
        if pool.size == 0:
            pool = np.arange(index.n_base)
        self.eps = jnp.asarray(
            rng.choice(pool, size=min(n_init, pool.size),
                       replace=False).astype(np.int32))

    def search(self, queries: np.ndarray, k: int, L: int,
               query_batch: int = 512,
               two_hop_chunk: int = 0,
               device_out: bool = False) -> Tuple[np.ndarray, ...]:
        import jax

        if not isinstance(queries, jax.Array):
            queries = np.asarray(queries, np.float32)
        q = prepare_vectors(queries, self.metric)
        nq, d = q.shape
        qb = min(query_batch, nq)
        M = int(self.neighbors.shape[1])
        if two_hop_chunk == 0:
            # bound the hop-2 working set ([qb, c*M, d] vector gather) to
            # ~128 MB; the full fan-out is [qb, M², d] — ~1.3 GB per 1k
            # queries at the reference's M_pjbp=35, d=512
            budget = (1 << 25) // max(1, qb * d)  # rows of the fan-out
            two_hop_chunk = max(1, min(M, budget // max(1, M)))
            # bitmask dedup additionally builds a [qb, F, F] same-word
            # broadcast with F = c*M (beam._scatter_or_bits) — bound
            # that to ~128 MB too, or it silently doubles peak memory
            f_max = int(((1 << 27) // max(1, qb)) ** 0.5)
            two_hop_chunk = max(1, min(two_hop_chunk,
                                       f_max // max(1, M)))
        def run(qs):
            r = beam_search(self.base, self.neighbors, self.eps, qs,
                            k=k, L=L, metric=self.metric, two_hop=True,
                            two_hop_chunk=two_hop_chunk)
            return r.ids, r.dists, r.cmps, r.hops

        return run_query_batches(q, nq, qb, run, device_out)

    def benchmark(self, queries: np.ndarray, k: int, L: int,
                  query_batch: int = 512, warmup: int = 1,
                  two_hop_chunk: int = 0) -> dict:
        """Device-timed sweep row, same methodology as Searcher.benchmark
        (queries staged in device memory, results blocked on device —
        host download excluded)."""
        import time

        q = prepare_vectors(np.asarray(queries, np.float32), self.metric)
        qb = min(query_batch, q.shape[0])
        for _ in range(warmup):  # the timed call itself (see FlatIndex)
            jax.block_until_ready(self.search(
                q, k, L, query_batch=qb, two_hop_chunk=two_hop_chunk,
                device_out=True))
        t0 = time.perf_counter()
        out = self.search(q, k, L, query_batch=qb,
                          two_hop_chunk=two_hop_chunk, device_out=True)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (np.asarray(o) for o in out)
        return {
            "L_pq": L, "k": k,
            "qps": q.shape[0] / dt,
            "avg_cmps": float(cmps.mean()),
            "avg_hops": float(hops.mean()),
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "ids": ids.astype(np.int32), "dists": dists,
        }
