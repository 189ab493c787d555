"""Flat (brute-force) index — a full scan as a serving mode.

The reference exists because CPUs cannot brute-force million-scale
corpora per query (hence graphs + SIMD, reference distance.h/
index_bipartite.cpp). On an accelerator an 8192-query × 1M-base × 128-d
distance block is one large matmul, so brute force is a serving mode in
its own right at this scale (the brute-force kNN regime of PAPERS.md).
Its speed on the H100 is recorded in PERF.md.

Each [B, tile] distance block is reduced exactly (`ops.knn.min_k`) and
folded into a running top-k. The block lives in device memory, so the
default tile is sized from the device's memory (`flat_tile`). "f32"
scans at the matmul's default precision (TF32 on H100) and reports those
scores unreranked, so it is not exact there; "bf16" and "int8" scan a
reduced copy of the table and rerank their k·oversample head with exact
f32 distances, and on the H100 they beat "f32" on both speed and recall
(PERF.md).

Scaling: O(N) per query; shard the base over ``mp`` for more
(`parallel.sharded_knn`). The projected-graph indexes (`graph/`) serve
the regimes where a scan costs too much.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.index import register_index
from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.ops.knn import (exact_knn_device, int8_global_knn_device,
                                    int8_knn_device, quantize_global_int8,
                                    quantize_rows_int8)
from mysteryann_tpu.utils.memory import device_memory_bytes

# largest scan tile (rows of the table per [B, tile] score block)
_MAX_TILE = 262144


def flat_tile(batch: int) -> int:
    """Default scan tile for a query batch: the largest power of two up
    to ``_MAX_TILE`` whose f32 [batch, tile] score block takes at most
    a quarter of the device's memory."""
    budget = device_memory_bytes() // 4 // (4 * max(1, batch))
    tile = _MAX_TILE
    while tile > 1024 and tile > budget:
        tile //= 2
    return tile


@partial(jax.jit, static_argnames=("k", "metric"))
def _rerank_f32(base, q, cand_i, k: int, metric: Metric):
    """Exact f32 rescoring of per-query candidate ids."""
    B, kk = cand_i.shape
    d = base.shape[1]
    vecs = jnp.take(base, cand_i.reshape(-1), axis=0).reshape(B, kk, d)
    ip = jnp.einsum("bd,bkd->bk", q, vecs, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    if metric in (Metric.IP, Metric.COSINE):
        dists = -ip
    else:
        dists = (jnp.sum(q * q, 1, keepdims=True) - 2.0 * ip
                 + jnp.sum(vecs * vecs, 2))
    neg, pos = jax.lax.top_k(-dists, k)
    return -neg, jnp.take_along_axis(cand_i, pos, axis=1)


@register_index("flat")
class FlatIndex:
    """Device-resident brute-force index.

    ``precision="f32"`` (the default) scans and reports the f32 matmul
    at its default precision: TF32 on the H100, with no rerank, so ids
    at near-ties and distances at ~1e-4 relative differ from an exact
    scan.

    ``precision="int8"`` scans with per-row symmetric int8 (s8 x s8 →
    s32, 4x less memory traffic than f32) and reranks the k·oversample
    head with exact f32 — reported distances stay exact, recall loss is
    confined to scan-boundary candidates the oversample absorbs.

    ``precision="bf16"`` scans a bf16-RESIDENT copy of the table (half
    the bytes per sweep — the lever where the scan is bandwidth-bound)
    and reranks the k·oversample head with exact f32, so reported
    distances stay exact.

    ``tile`` (rows per score block) defaults to `flat_tile` of the
    query batch.
    """

    def __init__(self, base: np.ndarray, metric: Metric | str = Metric.IP,
                 tile: int | None = None, oversample: int = 2,
                 precision: str = "f32", int8_scale: str = "auto"):
        if precision not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown precision {precision!r}")
        if int8_scale not in ("auto", "row", "global"):
            raise ValueError(f"unknown int8_scale {int8_scale!r}")
        self.metric = Metric.parse(metric)
        self.precision = precision
        self.base = prepare_vectors(np.asarray(base, np.float32), self.metric)
        self.tile = tile
        self.oversample = oversample
        if precision == "int8":
            # "global": one base-side scale → the selection ranks raw s8
            # accumulators, no per-column rescale (IP/cosine only).
            # "row": per-row scales, tighter quantization, required for
            # L2.
            if int8_scale == "auto":
                int8_scale = ("row" if self.metric == Metric.L2
                              else "global")
            if int8_scale == "global" and self.metric == Metric.L2:
                raise ValueError("int8_scale='global' supports ip/cosine "
                                 "only (L2 needs per-row norms)")
            self.int8_scale = int8_scale
            if int8_scale == "global":
                self.base_i8, self.base_scale = quantize_global_int8(
                    self.base)
                self.base_norm = None
            else:
                self.base_i8, self.base_scale = quantize_rows_int8(self.base)
                self.base_norm = (jnp.sum(self.base * self.base, axis=1)
                                  if self.metric == Metric.L2 else None)
        elif precision == "bf16":
            self.base_bf16 = jnp.asarray(self.base, jnp.bfloat16)

    @property
    def n_base(self) -> int:
        return self.base.shape[0]

    def search(self, queries: np.ndarray, k: int,
               query_batch: int = 8192, device_out: bool = False,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [Q, k] i32, dists [Q, k] f32).

        Queries stay device-resident between batches — no host round trip.
        ``device_out=True`` leaves results on device (callers composing
        further device work, and device-timed benchmarking).
        """
        if k > self.n_base:
            # the reference throws when a search returns < k results
            # (src/index_bipartite.cpp:2408-2412); a silently narrower
            # [Q, N] result breaks [Q, k] consumers
            raise ValueError(f"k ({k}) > corpus size ({self.n_base})")
        if not isinstance(queries, jax.Array):
            queries = np.asarray(queries, np.float32)
        q = prepare_vectors(queries, self.metric)
        nq, d = q.shape
        if nq == 0:
            e_i = np.empty((0, k), np.int32)
            e_d = np.empty((0, k), np.float32)
            return (jnp.asarray(e_i), jnp.asarray(e_d)) if device_out \
                else (e_i, e_d)
        qb = min(query_batch, nq)
        pad = (-nq) % qb
        if pad:
            q = jnp.concatenate([q, jnp.zeros((pad, d), jnp.float32)])
        kk = min(k * self.oversample, self.n_base)
        tile = min(self.tile or flat_tile(qb), self.n_base)
        outs = []
        for s in range(0, nq + pad, qb):
            qs = jax.lax.dynamic_slice_in_dim(q, s, qb)
            if self.precision == "bf16":
                # both operands bf16 so the matmul takes the full-rate
                # bf16 path; f32 accumulate (preferred_element_type)
                _, ii = exact_knn_device(
                    qs.astype(jnp.bfloat16), self.base_bf16, k=kk,
                    metric=self.metric, tile=tile)
                dd, ii = _rerank_f32(self.base, qs,
                                     jnp.maximum(ii, 0), k, self.metric)
                outs.append((ii, dd))
            elif self.precision == "int8":
                if self.int8_scale == "global":
                    q_i8, _ = quantize_rows_int8(qs)
                    _, ii = int8_global_knn_device(
                        q_i8, self.base_i8, k=kk, tile=tile)
                else:
                    _, ii = int8_knn_device(
                        qs, self.base_i8, self.base_scale, k=kk,
                        metric=self.metric, tile=tile,
                        base_norm=self.base_norm)
                dd, ii = _rerank_f32(self.base, qs,
                                     jnp.maximum(ii, 0), k, self.metric)
                outs.append((ii, dd))
            else:
                dd, ii = exact_knn_device(
                    qs, self.base, k=k, metric=self.metric, tile=tile)
                outs.append((ii, dd))
        if device_out:
            if len(outs) == 1:
                return outs[0][0][:nq], outs[0][1][:nq]
            return (jnp.concatenate([o[0] for o in outs])[:nq],
                    jnp.concatenate([o[1] for o in outs])[:nq])
        out_i = np.concatenate([np.asarray(o[0]) for o in outs])[:nq]
        out_d = np.concatenate([np.asarray(o[1]) for o in outs])[:nq]
        return out_i.astype(np.int32), out_d

    def benchmark(self, queries: np.ndarray, k: int,
                  query_batch: int = 8192, warmup: int = 1) -> dict:
        # device-timed: queries pre-staged in device memory, results
        # blocked on device and downloaded OUTSIDE the timed region (the
        # reference's timed region likewise starts and ends in working
        # memory)
        q = prepare_vectors(np.asarray(queries, np.float32), self.metric)
        qb = min(query_batch, q.shape[0])
        # warm up with the timed call itself: its padding and slicing
        # compile for the full query count, not just for one batch
        for _ in range(warmup):
            jax.block_until_ready(
                self.search(q, k, query_batch=qb, device_out=True))
        t0 = time.perf_counter()
        ids, dists = self.search(q, k, query_batch=qb, device_out=True)
        jax.block_until_ready((ids, dists))
        dt = time.perf_counter() - t0
        return {
            "qps": q.shape[0] / dt,
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "avg_cmps": float(self.n_base),
            "avg_hops": 0.0,
            "ids": np.asarray(ids).astype(np.int32), "dists": np.asarray(dists),
        }
