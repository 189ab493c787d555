"""Exact k-nearest-neighbor search — tiled matmul + running top-k merge.

The reference *outsources* this step: the projected-graph build consumes a
precomputed query→base exact kNN file produced by DiskANN utilities
(reference src/index_bipartite.cpp:2622-2639 loads it; thirdparty/DiskANN
computes it). We own it instead: stream base tiles through one matmul
against a resident query block and fold each tile's distances into a
running top-k. Every scan selects through `min_k`, an exact top-k with
a chunk-minimum prefilter.

This both generates build inputs (train-query kNN) and ground truth for
recall evaluation — replacing the reference's downloaded GT files.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.ops.distances import Metric, pairwise_dist, prepare_vectors

_INF = jnp.float32(jnp.inf)

# chunk width of the min_k prefilter: a [B, n] block is read once as
# [B, n/128, 128] chunk minima, so the sorts that follow run over n/128
# chunk keys and k*128 survivors instead of all n columns
_CHUNK = 128


def min_k(dists: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact k smallest entries of each row of ``dists`` [B, n]:
    (vals [B, k] ascending, pos [B, k] int32).

    The one selection every scan in the package calls. XLA's GPU top-k
    sorts whole rows, so a row long enough to hold at least 2k chunks of
    ``_CHUNK`` columns is prefiltered: the k chunks with the smallest
    minima hold every one of the row's k smallest entries (a chunk
    holding one has its minimum at or below the k-th value; any other
    chunk's minimum lies above it), so only their k*_CHUNK columns (plus
    a ragged tail under one chunk) reach the final top-k. Ties may pick
    different positions than a plain sort; the values are the same.
    """
    B, n = dists.shape
    g = n // _CHUNK
    if g < 2 * k:
        neg, pos = jax.lax.top_k(-dists, k)
        return -neg, pos.astype(jnp.int32)
    head = dists[:, :g * _CHUNK].reshape(B, g, _CHUNK)
    _, cidx = jax.lax.top_k(-jnp.min(head, axis=2), k)          # [B, k]
    cand = jnp.take_along_axis(head, cidx[:, :, None], axis=1)
    cand = cand.reshape(B, k * _CHUNK)
    pos = (cidx[:, :, None] * _CHUNK
           + jnp.arange(_CHUNK, dtype=jnp.int32)).reshape(B, k * _CHUNK)
    if n > g * _CHUNK:
        cand = jnp.concatenate([cand, dists[:, g * _CHUNK:]], axis=1)
        pos = jnp.concatenate(
            [pos, jnp.broadcast_to(
                jnp.arange(g * _CHUNK, n, dtype=jnp.int32),
                (B, n - g * _CHUNK))], axis=1)
    neg, p = jax.lax.top_k(-cand, k)
    return -neg, jnp.take_along_axis(pos, p, axis=1).astype(jnp.int32)


def _merge_topk(best, t_d, t_i, k: int):
    """Fold a tile's (dists, ids) into the running top-k — the tiny
    exact [B, k+kk] merge shared by every scan here."""
    best_d, best_i = best
    cat_d = jnp.concatenate([best_d, t_d], axis=1)
    cat_i = jnp.concatenate([best_i, t_i], axis=1)
    neg, pos = jax.lax.top_k(-cat_d, k)
    return -neg, jnp.take_along_axis(cat_i, pos, axis=1)


def scan_min_k(block_dists, n: int, k: int, tile: int, batch: int
               ) -> Tuple[jax.Array, jax.Array]:
    """Running top-k over ``n`` rows scored in tiles: (dists [batch, k],
    ids [batch, k] i32, -1 where n < k). Traced helper — call under jit.

    ``block_dists(lo, size)`` returns the [batch, size] distances of rows
    [lo, lo+size); ``lo`` is traced for the full tiles (one compiled
    step under ``lax.scan``) and a Python int for the remainder. Each
    tile reduces through `min_k` and folds into the running top-k. The
    scan runs over tile INDICES and the callers slice their
    loop-invariant tables: tiling a table as scan xs makes XLA copy the
    whole table into the loop buffer.
    """
    tile = min(tile, n)
    n_full = n // tile
    rem = n - n_full * tile
    best = (jnp.full((batch, k), _INF, jnp.float32),
            jnp.full((batch, k), -1, jnp.int32))
    if n_full:
        def step(carry, t_idx):
            lo = t_idx * tile
            t_d, t_pos = min_k(block_dists(lo, tile), min(k, tile))
            return _merge_topk(carry, t_d, t_pos + lo, k), None

        best, _ = jax.lax.scan(step, best,
                               jnp.arange(n_full, dtype=jnp.int32))
    if rem:
        lo = n_full * tile
        t_d, t_pos = min_k(block_dists(lo, rem), min(k, rem))
        best = _merge_topk(best, t_d, t_pos + lo, k)
    return best


@partial(jax.jit, static_argnames=("k", "metric", "tile", "precision"))
def exact_knn_device(
    queries: jax.Array,
    base: jax.Array,
    k: int,
    metric: Metric = Metric.IP,
    tile: int = 131072,
    precision: str = "default",
) -> Tuple[jax.Array, jax.Array]:
    """kNN of `queries` [B, d] in `base` [N, d] → (dists [B,k], ids [B,k] i32).

    Scans base in tiles of `tile` rows; each [B, tile] distance block is
    reduced exactly by `min_k` and folded into the running top-k
    (`scan_min_k`). The block is materialized in device memory, so
    ``tile`` bounds the working set at B x tile x 4 bytes.
    """
    metric = Metric.parse(metric)

    def block(lo, size):
        return pairwise_dist(
            queries, jax.lax.dynamic_slice_in_dim(base, lo, size, 0),
            metric=metric, precision=precision)

    return scan_min_k(block, base.shape[0], k, tile, queries.shape[0])


def exact_knn(
    queries: np.ndarray,
    base: np.ndarray,
    k: int,
    metric: Metric | str = Metric.IP,
    query_batch: int = 4096,
    base_tile: int = 65536,
    precision: str = "default",
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-level exact kNN: streams query batches through the device.

    Returns (dists [Q,k] f32, ids [Q,k] i32) as numpy. Handles metric
    preprocessing (cosine normalization) on device.
    """
    metric = Metric.parse(metric)
    base_d = prepare_vectors(np.asarray(base, np.float32), metric)
    nq = queries.shape[0]
    base_tile = min(base_tile, int(base.shape[0]))
    out_d = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int32)
    for s in range(0, nq, query_batch):
        e = min(s + query_batch, nq)
        qb = prepare_vectors(np.asarray(queries[s:e], np.float32), metric)
        # pad the query batch to a fixed shape so every chunk hits one
        # compiled executable
        bpad = query_batch - (e - s)
        if bpad:
            qb = jnp.pad(qb, ((0, bpad), (0, 0)))
        d_, i_ = exact_knn_device(
            qb, base_d, k, metric=metric, tile=base_tile,
            precision=precision,
        )
        out_d[s:e] = np.asarray(d_)[: e - s]
        out_i[s:e] = np.asarray(i_)[: e - s]
    return out_d, out_i


def compute_ground_truth(
    queries: np.ndarray,
    base: np.ndarray,
    k: int,
    metric: Metric | str = Metric.IP,
    **kw,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact GT in the reference's GT convention (ids u32 + dists f32).

    Uses full-precision matmuls — GT must be exact, not rounded to the
    reduced-precision matmul passes of ``precision="default"``.
    """
    d, i = exact_knn(queries, base, k, metric=metric, precision="highest", **kw)
    return i.astype(np.uint32), d


def quantize_rows_int8(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-row symmetric int8 quantization: x ≈ q * scale[:, None]."""
    amax = jnp.max(jnp.abs(x), axis=1)
    scale = jnp.maximum(amax, 1e-30) / 127.0
    q = jnp.clip(jnp.rint(x / scale[:, None]), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def quantize_global_int8(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """One symmetric int8 scale for the whole table: x ≈ q * scale.

    A uniform base-side scale makes raw s8xs8→s32 scores ORDER-PRESERVING
    per query for IP/cosine, so the selection can rank the integer
    accumulators directly, with no per-column rescale. Costs more
    quantization error on small-norm rows than per-row scales; the f32
    rerank absorbs it.
    """
    amax = jnp.max(jnp.abs(x))
    scale = jnp.maximum(amax, 1e-30) / 127.0
    q = jnp.clip(jnp.rint(x / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def _s8_dot(q_i8: jax.Array, b_i8: jax.Array) -> jax.Array:
    """s8 [B, d] x s8 [T, d] → s32 [B, T]."""
    return jax.lax.dot_general(q_i8, b_i8, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)


@partial(jax.jit, static_argnames=("k", "tile"))
def int8_global_knn_device(
    q_i8: jax.Array,        # int8 [B, d] (per-row query quantization is
    base_i8: jax.Array,     #              order-preserving; base is global)
    k: int,
    tile: int = 262144,
) -> Tuple[jax.Array, jax.Array]:
    """(neg s32 scores f32 [B, k], ids [B, k]) via a global-scale int8 scan.

    IP/cosine only: with one base-side scale, -s32 ranks identically to
    the true negated inner product per query, so the selection ranks the
    s8xs8→s32 accumulators directly. Scores are raw negated s8·s8
    accumulators; callers either rerank the head in f32 for exact
    distances or rescale by q_scale·base_scale for approximate ones
    (`FlatIndex`).
    """
    def block(lo, size):
        tile_b = jax.lax.dynamic_slice_in_dim(base_i8, lo, size, 0)
        return -_s8_dot(q_i8, tile_b).astype(jnp.float32)

    return scan_min_k(block, base_i8.shape[0], k, tile, q_i8.shape[0])


@partial(jax.jit, static_argnames=("k", "metric", "tile"))
def int8_knn_device(
    queries: jax.Array,      # f32 [B, d] (metric-preprocessed)
    base_i8: jax.Array,      # int8 [N, d]
    base_scale: jax.Array,   # f32 [N]
    k: int,
    metric: Metric = Metric.IP,
    tile: int = 131072,
    base_norm: jax.Array | None = None,   # f32 [N] ||b||² (L2 only)
) -> Tuple[jax.Array, jax.Array]:
    """Approximate kNN via an int8 scan (s8 x s8 → s32, 4x less memory
    traffic than an f32 scan). Same tiled running top-k as
    `exact_knn_device`; scores carry per-row quantization error (~0.5%
    relative), so callers rerank the head in f32 — see
    `FlatIndex(precision="int8")`.
    """
    metric = Metric.parse(metric)
    if metric == Metric.L2 and base_norm is None:
        # zero norms would silently rank by inner product instead of L2
        raise ValueError("int8_knn_device with metric=L2 requires "
                         "base_norm (||b||^2 per row)")
    q_i8, q_scale = quantize_rows_int8(queries)
    if metric == Metric.L2:
        q_sq = jnp.sum(queries * queries, axis=1, keepdims=True)

    def block(lo, size):
        tile_b = jax.lax.dynamic_slice_in_dim(base_i8, lo, size, 0)
        tile_s = jax.lax.dynamic_slice_in_dim(base_scale, lo, size, 0)
        ip = (_s8_dot(q_i8, tile_b).astype(jnp.float32)
              * q_scale[:, None]) * tile_s[None, :]
        if metric in (Metric.IP, Metric.COSINE):
            return -ip
        tile_n = jax.lax.dynamic_slice_in_dim(base_norm, lo, size, 0)
        return q_sq - 2.0 * ip + tile_n[None, :]

    return scan_min_k(block, base_i8.shape[0], k, tile, queries.shape[0])
