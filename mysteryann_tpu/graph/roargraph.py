"""RoarGraph construction — batched, functional, device-resident.

Reproduces the behavior of the reference build
(`BuildRoarGraph`/`LinkProjection`, reference src/index_bipartite.cpp:143-233,
1043-1277) with a dense batched design instead of mutex-guarded pointer
chasing:

Phase A (projection, :1059-1097): each training query's kNN list (truncated
to ``M_sq``) is projected onto its top-1 base point; the remaining list
members, with distances measured *to that target*, pass the occlusion prune
and become the target's out-edges. Queries sharing a target race in the
reference (last writer wins, :1088-1091); here the lowest-index query wins,
deterministically.

Phase B (reverse edges, :1100-1104) + Phase C (degree repair, :1107-1136):
for every forward edge u→v, v collects u as a reverse candidate; a node
whose forward+reverse candidates exceed ``M_pjbp`` is re-pruned. The
reference prunes incrementally at each overflowing insertion under a
per-node mutex; here each node prunes once over its full candidate set —
deterministic, and one batched device pass.

Phase D (connectivity enhancement, :1183-1269): every base node greedy-
searches the supply graph from the medoid entry point
(SearchProjectionGraphInternal:1279-1350) with queue length ``L_pjpq``; the
search pool is pruned (PruneProjectionBaseSearchCandidates:1846-1940 — no
fill pass, seed must not already be a projection neighbor) into fresh
supply out-edges; reverse supply edges are capped at ``2*M_pjbp`` inserts
and overflow-pruned back to ``M_pjbp``
(SupplyAddReverse:1352-1389 + PruneProjectionInternalReverseCandidates:
1434-1525); finally up to ``2*M_pjbp`` novel supply edges are appended to
each projection list (:1251-1269). Final degree ≤ ``2*M_pjbp``.

Entry point: the medoid — argmin squared-L2 to the base centroid,
regardless of metric (CalculateProjectionep:2004-2041).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time as _time
import warnings
from typing import Optional, Tuple

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.graph.adjacency import PaddedGraph
from mysteryann_tpu.graph.prune import batched_occlusion_prune, dists_to_src
from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.search.beam import beam_search
from mysteryann_tpu.utils.params import BuildConfig
from mysteryann_tpu.utils.memory import device_memory_bytes
from mysteryann_tpu.utils.timers import Timer
from mysteryann_tpu.index import register_index


# --------------------------------------------------------------------------
# index container + persistence
# --------------------------------------------------------------------------


@dataclasses.dataclass
@register_index("roargraph")
class RoarGraphIndex:
    graph: PaddedGraph
    metric: Metric
    dim: int

    def save(self, path: str) -> None:
        """Reference-compatible projection graph file + JSON sidecar.

        Binary layout identical to SaveProjectionGraph (reference
        src/index_bipartite.cpp:2606-2619): ``[ep u32][npts u32]`` then per
        node ``[deg u32][ids u32…]``.
        """
        save_projection_graph(path, self.graph)
        with open(path + ".meta.json", "w") as f:
            json.dump({"metric": self.metric.value, "dim": self.dim,
                       "max_degree": self.graph.max_degree}, f)

    @classmethod
    def load(cls, path: str, metric: Metric | str | None = None,
             dim: int = 0) -> "RoarGraphIndex":
        meta = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        g = load_projection_graph(path, m_pad=meta.get("max_degree"))
        m = Metric.parse(metric or meta.get("metric", "ip"))
        return cls(graph=g, metric=m, dim=int(meta.get("dim", dim)))


def save_projection_graph(path: str, g: PaddedGraph) -> None:
    from mysteryann_tpu import native
    nb = np.ascontiguousarray(g.neighbors, np.int32)
    n = g.n_nodes
    L = native.lib()
    if L is not None:
        import ctypes
        rc = L.msann_save_projection(
            path.encode(), g.ep, n,
            nb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nb.shape[1])
        if rc != 0:
            raise OSError(f"native save failed ({rc}) for {path}")
        return
    # vectorized fallback: assemble the [deg, ids…]* word stream in one
    # array instead of 2 Python calls per node (minutes at 10M nodes)
    valid = nb < n
    degs = valid.sum(axis=1).astype(np.int64)
    row_starts = np.zeros(n, np.int64)
    np.cumsum(1 + degs[:-1], out=row_starts[1:])
    out = np.empty(int(n + degs.sum()), np.uint32)
    out[row_starts] = degs.astype(np.uint32)
    rank = np.cumsum(valid, axis=1) - 1
    out[(row_starts[:, None] + 1 + rank)[valid]] = nb[valid].astype(np.uint32)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", g.ep, n))
        out.tofile(f)


def load_projection_graph(path: str, m_pad: Optional[int] = None) -> PaddedGraph:
    from mysteryann_tpu import native
    L = native.lib()
    if L is not None:
        import ctypes
        ep = ctypes.c_uint32()
        n = ctypes.c_uint32()
        md = ctypes.c_uint32()
        words = ctypes.c_int64()
        rc = L.msann_scan_projection(path.encode(), ctypes.byref(ep),
                                     ctypes.byref(n), ctypes.byref(md),
                                     ctypes.byref(words))
        if rc == -22:  # EINVAL: trailing bytes
            raise ValueError(f"{path}: trailing bytes in projection graph file")
        if rc != 0:
            raise OSError(f"native scan failed ({rc}) for {path}")
        width = m_pad or max(int(md.value), 1)
        nb = np.empty((n.value, width), np.int32)
        rc = L.msann_load_projection(
            path.encode(), nb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n.value, width)
        if rc != 0:
            raise OSError(f"native load failed ({rc}) for {path}")
        return PaddedGraph(neighbors=nb, ep=int(ep.value))
    with open(path, "rb") as f:
        ep, n = struct.unpack("<II", f.read(8))
        payload = np.fromfile(f, dtype=np.uint32)
    if n > 1_000_000:
        warnings.warn(
            f"native loader unavailable; Python fallback parsing {n} "
            "adjacency rows (build mysteryann_tpu/native for large graphs)")
    # row starts follow the data-dependent recurrence s+1+deg — the only
    # sequential part; degree extraction and id placement are vectorized
    starts = np.empty(n, np.int64)
    off = 0
    # python-int walk beats numpy scalar indexing, but a whole-payload
    # tolist() is ~28 B/word transient (10 GB for a 10M-node graph) —
    # chunk it: O(chunk) extra memory, same speed
    CH = 1 << 22
    lo, words = 0, []
    for i in range(n):
        starts[i] = off
        if not lo <= off < lo + len(words):
            lo = off
            words = payload[lo: lo + CH].tolist()
        off += 1 + words[off - lo]
    if off != payload.size:
        raise ValueError(f"{path}: trailing bytes in projection graph file")
    degs = payload[starts].astype(np.int64)
    m_pad = m_pad or max(int(degs.max(initial=0)), 1)
    nb = np.full((n, m_pad), n, np.int32)
    cols = np.arange(m_pad, dtype=np.int64)
    # truncate rows wider than m_pad (matches the native loader)
    mask = cols[None, :] < np.minimum(degs, m_pad)[:, None]
    pos = starts[:, None] + 1 + cols[None, :]
    nb[mask] = payload[pos[mask]].astype(np.int32)
    return PaddedGraph(neighbors=nb, ep=int(ep))


def load_nsg_graph(path: str, n_nodes: int = 0,
                   m_pad: Optional[int] = None) -> PaddedGraph:
    """Import an NSG-format graph: ``[width u32][ep u32]`` then per node
    ``[deg u32][ids…]`` (reference LoadNsgGraph,
    src/index_bipartite.cpp:2073-2095 — which hardcodes npts=1,000,000;
    here ``n_nodes=0`` means read until EOF)."""
    with open(path, "rb") as f:
        width, ep = struct.unpack("<II", f.read(8))
        payload = np.fromfile(f, dtype=np.uint32)
    lists, off, maxdeg = [], 0, 1
    while off < payload.size and (n_nodes == 0 or len(lists) < n_nodes):
        deg = int(payload[off]); off += 1
        lists.append(payload[off:off + deg].astype(np.int32)); off += deg
        maxdeg = max(maxdeg, deg)
    if n_nodes and len(lists) != n_nodes:
        raise ValueError(f"{path}: expected {n_nodes} nodes, "
                         f"parsed {len(lists)}")
    n = len(lists)
    nb = np.full((n, m_pad or maxdeg), n, np.int32)
    for i, row in enumerate(lists):
        nb[i, : min(row.size, nb.shape[1])] = row[: nb.shape[1]]
    return PaddedGraph(neighbors=nb, ep=int(ep))


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


class _BuildCheckpoint:
    """Phase-level build checkpointing (absent in the reference).

    ``fingerprint`` guards resume correctness: phase outputs depend on
    the build config and input shapes, so checkpoints written under a
    different fingerprint are discarded instead of silently resumed.
    """

    def __init__(self, directory: Optional[str],
                 fingerprint: Optional[dict] = None):
        self.dir = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
            if fingerprint is not None:
                meta_path = os.path.join(directory, "build_meta.json")
                old = None
                if os.path.exists(meta_path):
                    try:
                        with open(meta_path) as f:
                            old = json.load(f)
                    except (OSError, ValueError):
                        old = None
                if old != fingerprint:
                    for f in os.listdir(directory):
                        if f.startswith("build_") and f.endswith(".npy"):
                            os.remove(os.path.join(directory, f))
                    with open(meta_path, "w") as f:
                        json.dump(fingerprint, f)

    def _path(self, phase: str) -> str:
        return os.path.join(self.dir, f"build_{phase}.npy")

    def load(self, phase: str) -> Optional[np.ndarray]:
        if not self.dir or not os.path.exists(self._path(phase)):
            return None
        return np.load(self._path(phase))

    def save(self, phase: str, arr: np.ndarray) -> None:
        if not self.dir:
            return
        tmp = self._path(phase) + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, self._path(phase))

    def clean_prefix(self, prefix: str) -> None:
        if not self.dir:
            return
        for f in os.listdir(self.dir):
            if f.startswith(f"build_{prefix}") and f.endswith(".npy"):
                os.remove(os.path.join(self.dir, f))


@jax.jit
def _medoid_device(base: jax.Array) -> jax.Array:
    c = jnp.mean(base, axis=0, keepdims=True)
    d = (jnp.sum(base * base, axis=1) - 2.0 * (base @ c[0])
         + jnp.sum(c * c))
    return jnp.argmin(d)


def compute_medoid(base: jax.Array) -> int:
    """argmin_i ||base_i - centroid||² (reference CalculateProjectionep).

    One jitted dispatch instead of 7 eager device programs."""
    return int(_medoid_device(base))


def _aggregate_reverse(
    e_src: np.ndarray, e_dst: np.ndarray, e_dist: np.ndarray,
    n: int, r_max: int,
) -> np.ndarray:
    """Group reverse edges by destination, closest-first, into [n, r_max].

    (Phase D's arrival-order variant lives on device in
    ``_fold_round_device``.) Returns sentinel(n)-padded int32.
    """
    order = np.lexsort((e_dist, e_dst))
    ds, ss = e_dst[order], e_src[order]
    counts = np.bincount(ds, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    rank = np.arange(ds.size, dtype=np.int64) - offsets[ds]
    keep = rank < r_max
    out = np.full((n, r_max), n, np.int32)
    out[ds[keep], rank[keep]] = ss[keep]
    return out


@partial(jax.jit, static_argnames=("n", "r_max"))
def _aggregate_reverse_device(e_src, e_dst, e_dist, n: int, r_max: int):
    """Device twin of `_aggregate_reverse`: same (dst, dist)-stable
    grouping (lax.sort is stable like np.lexsort), scatter into a
    sentinel-padded [n, r_max]. Keeps the 1M-scale BC phase on the
    device: no [n, 3M] reverse tensor crosses to the host."""
    E = e_src.shape[0]
    ds, _, ss = jax.lax.sort(
        (e_dst.astype(jnp.int32), e_dist, e_src.astype(jnp.int32)),
        dimension=-1, num_keys=2)
    arrival = jnp.arange(E, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), ds[1:] != ds[:-1]])
    seg_start = jax.lax.cummax(jnp.where(is_start, arrival, 0))
    rank = arrival - seg_start
    keep = (ds < n) & (rank < r_max)
    rev = jnp.full((n + 1, r_max), n, jnp.int32)
    rev = rev.at[jnp.where(keep, ds, n), jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ss, n), mode="drop")[:n]
    return rev


def _batched_prune_rows(
    base_dev: jax.Array,
    node_ids: np.ndarray,        # [K] rows to prune
    cand: np.ndarray,            # [K, C] candidate ids (sentinel n)
    cap: int,
    metric: Metric,
    batch: int,
    fill: bool,
    not_seedable: Optional[np.ndarray] = None,  # [K, C] bool
    return_device: bool = False,
    two_pass: bool = False,
) -> np.ndarray:
    """Run the occlusion prune over row batches; returns [K, cap] ids.

    Accepts host OR device arrays — device inputs never round-trip the
    host; ``return_device=True`` keeps the output on device too.
    """
    n = base_dev.shape[0]
    k_rows = node_ids.shape[0]
    dev_out = []
    out = None if return_device else np.full((k_rows, cap), n, np.int32)
    batch = max(1, min(batch, k_rows))
    xp = jnp if isinstance(cand, jax.Array) else np
    for s in range(0, k_rows, batch):
        e = min(s + batch, k_rows)
        ids_b = node_ids[s:e]
        cand_b = cand[s:e]
        ns_b = not_seedable[s:e] if not_seedable is not None else None
        if e - s < batch:  # pad to the compiled shape
            pad = batch - (e - s)
            ids_b = xp.concatenate(
                [ids_b, xp.zeros(pad, ids_b.dtype)])
            cand_b = xp.concatenate(
                [cand_b, xp.full((pad, cand_b.shape[1]), n, cand_b.dtype)])
            if ns_b is not None:
                ns_b = xp.concatenate(
                    [ns_b, xp.zeros((pad, ns_b.shape[1]), bool)])
        ids_j = jnp.asarray(ids_b, jnp.int32)
        cand_j = jnp.asarray(cand_b, jnp.int32)
        src_vecs = jnp.take(base_dev, ids_j, axis=0)
        # return_vecs: reuse the candidate rows in the prune — the row
        # gather is the main memory cost of the prune phases
        cd, cv = dists_to_src(src_vecs, cand_j, base_dev, metric,
                              return_vecs=True)
        pruned, _ = batched_occlusion_prune(
            src_vecs, ids_j, cand_j, cd, base_dev, cap=cap, metric=metric,
            fill=fill,
            not_seedable=None if ns_b is None else jnp.asarray(ns_b),
            two_pass=two_pass, cand_vecs=cv,
        )
        if return_device:
            dev_out.append(pruned[: e - s])
        else:
            out[s:e] = np.asarray(pruned)[: e - s]
    if return_device:
        return dev_out[0] if len(dev_out) == 1 else jnp.concatenate(dev_out)
    return out


def _resolve_engine(cfg, n: int, d: int) -> str:
    """Resolve connectivity_engine='auto' for corpus (n, d) — one shared
    rule so the checkpoint tag and the pass itself cannot disagree."""
    from mysteryann_tpu.search.fused import _row_bytes
    engine = cfg.connectivity_engine
    bits = cfg.connectivity_bits
    dim_mult = 8 if bits == 8 else 16
    if engine == "auto":
        w16 = -(-2 * cfg.M_pjbp // 16) * 16
        # fused needs the packed table resident next to base+supply+prune
        # scratch (table budget: 5/8 of the device's memory) and dims on
        # the byte-row sub-row boundary (pack_neighbor_table)
        engine = ("fused" if d % dim_mult == 0
                  and (n + 1) * _row_bytes(w16, d, bits)
                  <= device_memory_bytes() * 5 // 8
                  else "classic")
    return engine


def _rounds_for_pass(cfg, pass_i: int) -> int:
    """Connectivity rounds for phase-D pass ``pass_i`` (0-based).

    Pass 1 runs the full incremental schedule (its rounds bootstrap the
    sparse post-projection graph); later passes search an already
    converged graph, where the intra-pass incremental effect is
    marginal — they default to a quarter of the rounds (min 2), which
    cuts the per-round fold/pack cost (measured at 1M: recall frontier
    unchanged within the documented ±1pt round-count noise,
    BASELINE.md)."""
    r0 = cfg.connectivity_iters or 16
    if pass_i == 0:
        return r0
    return cfg.connectivity_iters_later or max(2, r0 // 4)


def _prune_batch(cfg, n: int) -> int:
    """Rows per phase-D occlusion-prune call. It bounds the [B, C, C]
    tile (C = history H): 2048 ≈ 1.2 GB f32 at H=384, affordable below
    4M nodes where the fused table leaves headroom; above that the
    classic path sits next to a multi-GB base and keeps 1024. The
    sharded build prunes at the same row count, so both compile the
    same prune shapes."""
    return max(8, min(cfg.search_batch, 2048 if n < 4_000_000 else 1024))


def _phase_d_knob_tag(cfg, n: int, d: int) -> str:
    """Phase-D checkpoint tag suffix: every knob that changes phase-D
    outputs (the knobs are fingerprint-neutral so phases A-C survive a
    knob change; see build_roargraph)."""
    engine = _resolve_engine(cfg, n, d)
    t = (f"{engine}_e{cfg.connectivity_expand}"
         f"i{cfg.connectivity_iters}j{_rounds_for_pass(cfg, 1)}"
         f"h{cfg.history_mult}")
    if engine == "fused":
        t += f"b{cfg.connectivity_bits}"
        if cfg.connectivity_seeds:
            t += f"s{cfg.connectivity_seeds}r{cfg.connectivity_seed_sample}"
    return t


@partial(jax.jit, static_argnames=("n", "cap"))
def _merge_fr_block(own_b: jax.Array, rev_b: jax.Array, n: int, cap: int):
    """One row block of the forward∪reverse merge, on device.

    Reverse entries already present in the own list are dropped; valid
    entries compact left in own-then-reverse, position-stable order (the
    reference's push_back-without-prune insertion). Returns
    (merged [bs, cap], total [bs] = valid count after dedup) — the exact
    key-sort recast of the former host argsort path (bit-identity pinned
    by tests/test_roargraph_build.py building through both phases)."""
    bs, A = own_b.shape
    R = rev_b.shape[1]
    C = A + R
    dup = (rev_b[:, :, None] == own_b[:, None, :]).any(axis=2)
    posA = jax.lax.broadcasted_iota(jnp.int32, own_b.shape, 1)
    posR = jax.lax.broadcasted_iota(jnp.int32, rev_b.shape, 1)
    own_key = jnp.where(own_b < n, posA, 2 * C + posA)
    rev_key = jnp.where((rev_b < n) & ~dup, A + posR, 3 * C + posR)
    keys = jnp.concatenate([own_key, rev_key], axis=1)
    vals = jnp.concatenate([own_b, rev_b], axis=1)
    k_s, v_s = jax.lax.sort((keys, vals), dimension=-1, num_keys=1)
    merged = jnp.where(k_s[:, :cap] < 2 * C, v_s[:, :cap], jnp.int32(n))
    total = (jnp.sum(own_b < n, axis=1, dtype=jnp.int32)
             + jnp.sum((rev_b < n) & ~dup, axis=1, dtype=jnp.int32))
    return merged, total


def _merge_forward_reverse(
    base_dev: jax.Array,
    own: np.ndarray,        # [N, A] current lists (sentinel-padded)
    rev: np.ndarray,        # [N, R] reverse candidates (sentinel-padded)
    cap: int,
    metric: Metric,
    batch: int,
    fill: bool,
    prune_threshold: Optional[int] = None,
) -> np.ndarray:
    """Per node: own ∪ reverse; prune to ``cap`` when above threshold.

    Nodes at or under the threshold keep own-then-reverse order (reference
    push_back without prune); overfull nodes go through the batched
    occlusion prune.

    Runs ON DEVICE in row blocks: the former host version's [N, R, A]
    numpy dedup broadcast measured 360 s of a 10M build on one host core
    (2026-08-19 build log). Results are unchanged (same dedup rule, same stable
    compaction order, same overfull prune).
    """
    n, A = own.shape
    R = rev.shape[1]
    thresh = cap if prune_threshold is None else prune_threshold
    on_dev = isinstance(own, jax.Array)
    own_dev = jnp.asarray(own, jnp.int32)
    rev_dev = jnp.asarray(rev, jnp.int32)   # 3.8 GB at 10M
    # block size bounds the [bs, R, A] device broadcast (~0.5 GB bool)
    bs = max(1024, min(n, (1 << 29) // max(1, R * A)))
    merged = None if on_dev else np.empty((n, cap), np.int32)
    m_blks, t_blks = [], []
    total = None if on_dev else np.empty(n, np.int32)
    for s in range(0, n, bs):
        st = min(s, max(0, n - bs))  # clamped window (one compiled shape)
        m_b, t_b = _merge_fr_block(
            jax.lax.dynamic_slice_in_dim(own_dev, st, min(bs, n), 0),
            jax.lax.dynamic_slice_in_dim(rev_dev, st, min(bs, n), 0),
            n=n, cap=cap)
        if on_dev:
            m_blks.append(m_b[s - st:])
            t_blks.append(t_b[s - st:])
        else:
            merged[st: st + bs] = np.asarray(m_b)
            total[st: st + bs] = np.asarray(t_b)
    if on_dev:
        merged = m_blks[0] if len(m_blks) == 1 else jnp.concatenate(m_blks)
        total = t_blks[0] if len(t_blks) == 1 else jnp.concatenate(t_blks)
        hard = np.nonzero(np.asarray(total > thresh))[0]  # [n] bool only
    else:
        hard = np.nonzero(total > thresh)[0]
    if hard.size:
        # overfull rows: occlusion-prune over the FULL dedup'd candidate
        # list (own-then-reverse), reconstructed on device per block
        out_rows = (None if on_dev
                    else np.empty((hard.size, cap), np.int32))
        OB = 1 << 15
        for s in range(0, hard.size, OB):
            blk = hard[s: s + OB]
            ids = jnp.asarray(np.minimum(blk, n - 1).astype(np.int32))
            own_r = jnp.take(own_dev, ids, axis=0)
            rev_r = jnp.take(rev_dev, ids, axis=0)
            dup = (rev_r[:, :, None] == own_r[:, None, :]).any(axis=2)
            cand_b = jnp.concatenate(
                [own_r, jnp.where(dup, n, rev_r)], axis=1)
            pruned_b = _batched_prune_rows(
                base_dev, jnp.asarray(blk.astype(np.int32)), cand_b, cap,
                metric, batch, fill, return_device=on_dev)
            if on_dev:
                merged = merged.at[jnp.asarray(
                    blk.astype(np.int32))].set(pruned_b[: blk.size])
            else:
                out_rows[s: s + blk.size] = pruned_b
        if not on_dev:
            merged[hard] = out_rows
    return merged


# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------


def build_roargraph(
    base: np.ndarray,
    train_queries: np.ndarray,
    learn_base_knn: np.ndarray,
    cfg: BuildConfig = BuildConfig(),
    verbose: bool = True,
    checkpoint_dir: str | None = None,
) -> RoarGraphIndex:
    """Build the RoarGraph projection index.

    `learn_base_knn` is the exact train-query→base kNN ([Nq, K] ids,
    K ≥ cfg.M_sq) — produce it with `ops.knn.exact_knn` or load the
    reference's file via `io.read_knn_ibin`.

    `checkpoint_dir`: mid-build checkpointing (the reference has none —
    its build is all-or-nothing, SURVEY §5). Phase outputs are saved
    there and a rerun resumes from the last completed phase.
    """
    import functools
    import sys

    t_build0 = _time.perf_counter()
    metric = Metric.parse(cfg.metric)
    M = cfg.M_pjbp
    n = base.shape[0]
    nq = train_queries.shape[0]
    # progress goes to stderr: stdout belongs to callers (bench.py's JSON
    # contract, CLI table output)
    log = (functools.partial(print, file=sys.stderr, flush=True)
           if verbose else (lambda *a, **k: None))

    base_dev = prepare_vectors(base, metric)  # device, normalized if cosine
    knn = np.asarray(learn_base_knn[:, : cfg.M_sq], np.int64)

    # fingerprint includes a cheap content digest: shapes + config alone
    # would let a resume splice phase outputs computed from a DIFFERENT
    # same-shaped corpus into this build (silently wrong adjacency)
    def _digest(a) -> str:
        # Probe rows only, never the full array: a full download of the
        # device-resident base is hundreds of MB. Device arrays gather
        # the row set with ONE jnp.take. Sums run in numpy over the
        # downloaded rows so host- and device-passed arrays produce
        # IDENTICAL digests (existing checkpoint fingerprints are
        # unchanged).
        step = max(1, a.shape[0] // 64)
        idx = np.arange(0, a.shape[0], step, dtype=np.int64)[:64]
        if isinstance(a, jax.Array):
            probe = np.asarray(jnp.take(a, jnp.asarray(idx), axis=0))
            row0 = np.asarray(a[:1])[0]
        else:
            probe = np.asarray(a[idx])
            row0 = np.asarray(a[0])
        return f"{float(np.sum(probe)):.6e}/{float(np.sum(np.abs(row0))):.6e}"

    # fingerprint-NEUTRAL knobs: connectivity_passes (pass p's checkpoint
    # is identical whatever the total pass count, so a 1-pass build
    # extends to 2 passes incrementally) and the batching sizes
    # (query_batch / search_batch change how work is chunked, never the
    # per-row results — clamped tail windows re-search rows to identical
    # values, and prune batches are padded, not merged). The phase-D-only
    # knobs (engine/expand/bits/seeds/iters/history) are excluded too:
    # phases A-C don't depend on them, so changing a phase-D knob must
    # not discard the A-C checkpoints — instead those knobs are baked
    # into the phase-D checkpoint TAG below, which isolates D outputs
    # per knob set.
    cfg_fp = dataclasses.asdict(cfg)
    for neutral in ("connectivity_passes", "query_batch", "search_batch",
                    "connectivity_engine", "connectivity_expand",
                    "connectivity_bits", "connectivity_seeds",
                    "connectivity_seed_sample", "connectivity_iters",
                    "connectivity_iters_later", "history_mult"):
        cfg_fp.pop(neutral, None)
    ckpt = _BuildCheckpoint(checkpoint_dir, fingerprint={
        "cfg": cfg_fp, "n": int(n), "nq": int(nq),
        "dim": int(base.shape[1]),
        "base": _digest(base), "queries": _digest(train_queries),
        "knn": _digest(learn_base_knn)})
    log(f"setup (staging + fingerprint): "
        f"{_time.perf_counter() - t_build0:.1f}s")

    with Timer("medoid") as t_med:
        # checkpointed: a pure function of the (fingerprinted) base — a resume must not pay it again
        ep_st = ckpt.load("medoid")
        if ep_st is not None:
            ep = int(ep_st[0])
        else:
            ep = compute_medoid(base_dev)
            ckpt.save("medoid", np.asarray([ep], np.int64))
    log(f"projection ep: {ep} ({t_med.elapsed:.2f}s)")

    # ---- Phase A: projection ------------------------------------------------
    # Every training query's list is pruned against its top-1 target.
    # Queries sharing a target race in the reference: each one's pruned
    # list is written then ProjectionAddReverse'd, so ALL of them
    # contribute reverse edges v→tgt even though only one list survives
    # as the forward list (:1088-1092). We keep the first query's list as
    # the forward list (deterministic) and harvest reverse candidates
    # from every query's pruned list.
    with Timer("phaseA") as t_a:
        st = ckpt.load("phaseA")
        if st is not None:
            pruned_all = st
        else:
            tgt_all32 = knn[:, 0].astype(np.int32)
            cand = knn.astype(np.int32)                         # [Nq, M_sq]
            cand = np.where(cand == tgt_all32[:, None], n, cand)
            pruned_all = _batched_prune_rows(
                base_dev, tgt_all32, cand, M, metric,
                cfg.query_batch, fill=True)                     # [Nq, M]
            ckpt.save("phaseA", pruned_all)
        tgt_all = knn[:, 0]
        winners_tgt, first_idx = np.unique(tgt_all, return_index=True)
        forward = np.full((n, M), n, np.int32)
        forward[winners_tgt] = pruned_all[first_idx]
    log(f"phase A: {winners_tgt.size}/{nq} unique targets "
        f"({t_a.elapsed:.2f}s)")

    # ---- Phase B+C: reverse edges + degree repair ---------------------------
    with Timer("phaseBC") as t_bc:
        projection = ckpt.load("phaseBC")
        proj_np = projection
        if projection is None:
            pv = pruned_all < n
            e_src = np.repeat(tgt_all, M)[pv.ravel()]           # u = target
            e_dst = pruned_all.ravel().astype(np.int64)[pv.ravel()]
            # dedupe (v→u) pairs across queries sharing a target
            key = e_dst * np.int64(n) + e_src
            _, uniq = np.unique(key, return_index=True)
            e_src, e_dst = e_src[uniq], e_dst[uniq]
            on_dev = n < 4_000_000
            if on_dev:
                # DEVICE path: reverse aggregation + forward scatter on
                # device — no [n, 3M] reverse or [n, M] forward upload
                e_dist = _edge_dists(base_dev, e_src, e_dst, metric,
                                     return_device=True)
                rev = _aggregate_reverse_device(
                    jnp.asarray(e_src.astype(np.int32)),
                    jnp.asarray(e_dst.astype(np.int32)),
                    e_dist, n=n, r_max=3 * M)
                fwd = jnp.full((n, M), n, jnp.int32).at[
                    jnp.asarray(winners_tgt.astype(np.int32))].set(
                    jnp.asarray(pruned_all[first_idx]))
            else:
                # edge distances for closest-first reverse capping
                e_dist = _edge_dists(base_dev, e_src, e_dst, metric)
                rev = _aggregate_reverse(e_src, e_dst, e_dist, n,
                                         r_max=3 * M)
                fwd = forward
            # host-visible split: the [chunk, R, A] novelty masks inside
            # _merge_forward_reverse run on one host core (VERDICT r2
            # flagged their 10M cost as profile-invisible)
            _t0 = _time.perf_counter()
            projection = _merge_forward_reverse(
                base_dev, fwd, rev, cap=M, metric=metric,
                batch=cfg.query_batch, fill=True)
            log(f"phase B/C merge: {_time.perf_counter() - _t0:.1f}s")
            # one download serves both the checkpoint and degree stats;
            # phase D keeps the device-resident copy
            proj_np = np.asarray(projection)
            ckpt.save("phaseBC", proj_np)
        del forward, pruned_all
    pg = PaddedGraph(neighbors=proj_np, ep=ep)
    st = pg.degree_stats()
    log(f"phase B/C: degree avg {st['avg']:.1f} max {st['max']} "
        f"zero {st['zero']} ({t_bc.elapsed:.2f}s)")

    # ---- Phase D: connectivity enhancement ----------------------------------
    # knob suffix isolates phase-D checkpoints per knob set (the knobs
    # are fingerprint-neutral above so A-C checkpoints survive)
    knobs = _phase_d_knob_tag(cfg, n, base.shape[1])
    with Timer("phaseD") as t_d:
        final = projection
        for p_i in range(max(1, cfg.connectivity_passes)):
            tag = (f"phaseD{'' if p_i == 0 else p_i + 1}_{knobs}")
            supply = ckpt.load(tag)
            if supply is None:
                supply = _connectivity_pass(base_dev, final, ep, cfg,
                                            metric, log, ckpt=ckpt, tag=tag,
                                            pass_i=p_i)
                ckpt.save(tag, np.asarray(supply))
                ckpt.clean_prefix(f"{tag}_r")  # round files superseded
            # merge novel supply edges into projection (reference
            # :1251-1269); later passes (beyond-reference) search the
            # completed graph and stay under the same 2M degree bound.
            # Below 4M everything stays DEVICE-resident across passes:
            # no per-pass download/upload of the [N, 2-3M] adjacency
            _t0 = _time.perf_counter()
            final = _append_novel(final, supply, cap_add=2 * M, n=n)
            if final.shape[1] > 2 * M:
                final = _cap_degree(final, base_dev, 2 * M, metric,
                                    cfg.query_batch, n)
            log(f"phase D pass {p_i + 1} merge+cap: "
                f"{_time.perf_counter() - _t0:.1f}s")
        # phase E: reachability repair (reference's dead CollectPoints)
        final = np.asarray(final)  # one download; host BFS
        final = _ensure_reachability(final, ep, base_dev, metric, log)
    g = PaddedGraph(neighbors=final, ep=ep)
    st = g.degree_stats()
    log(f"phase D: final degree avg {st['avg']:.1f} max {st['max']} "
        f"zero {st['zero']} ({t_d.elapsed:.2f}s)")

    # residual accounting: time inside this function but outside the four
    # phase timers (ckpt fingerprinting, host allocs, degree stats)
    t_other = (_time.perf_counter() - t_build0 - t_med.elapsed
               - t_a.elapsed - t_bc.elapsed - t_d.elapsed)
    log(f"build split: medoid {t_med.elapsed:.1f}s A {t_a.elapsed:.1f}s "
        f"BC {t_bc.elapsed:.1f}s D {t_d.elapsed:.1f}s other {t_other:.1f}s")

    from mysteryann_tpu.utils.trace import tracer
    tr = tracer()
    tr.record("build.medoid", t_med.elapsed)
    # (phase-D internals — search/pack/prune/fold — are logged to stderr
    # by _connectivity_pass)
    tr.record("build.phaseA", t_a.elapsed, queries=int(nq))
    tr.record("build.phaseBC", t_bc.elapsed)
    tr.record("build.phaseD", t_d.elapsed, nodes=int(n))
    tr.count("build.nodes", n)

    return RoarGraphIndex(graph=g, metric=metric, dim=base.shape[1])


def _edge_dists(base_dev, e_src, e_dst, metric, chunk: int = 1 << 20,
                return_device: bool = False):
    """Distances for an edge list, chunked through the device."""
    out = None if return_device else np.empty(e_src.size, np.float32)
    parts = []
    for s in range(0, e_src.size, chunk):
        e = min(s + chunk, e_src.size)
        a = jnp.take(base_dev, jnp.asarray(e_src[s:e], jnp.int32), axis=0)
        b = jnp.take(base_dev, jnp.asarray(e_dst[s:e], jnp.int32), axis=0)
        ip = jnp.sum(a * b, axis=-1)
        if metric in (Metric.IP, Metric.COSINE):
            d = -ip
        else:
            d = jnp.sum((a - b) ** 2, axis=-1)
        if return_device:
            parts.append(d)
        else:
            out[s:e] = np.asarray(d)
    if return_device:
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return out




@partial(jax.jit, donate_argnums=(0,))
def _fold_round_device(supply: jax.Array, chunk_lists: jax.Array,
                       r0: jax.Array):
    """Fold one connectivity chunk into the live supply graph ON DEVICE.

    Device recast of the host fold (own-row overwrite + arrival-order
    reverse aggregation + dedup'd free-slot merge for rows that fit):
    re-uploading the whole [N, 2M] supply tensor every round is avoided,
    and the host lexsort group-by is bound to one core. Returns (supply', rev [n, W], fit [n]) —
    rows that do NOT fit keep only their own lists; the caller routes
    them through the overflow prune + refill.
    """
    n, W = supply.shape
    # own rows: overwrite with the fresh pruned lists (reference :1213)
    supply = _own_overwrite(supply, chunk_lists, r0)

    # arrival-order reverse aggregation, budget W per destination
    # (reference SupplyAddReverse push_back order; see host
    # _aggregate_reverse for why closest-first caps starve tail nodes)
    ds, ss, rank = _round_edges(chunk_lists, r0, n)
    keep = (ds < n) & (rank < W)
    rev = jnp.full((n + 1, W), n, jnp.int32)
    rev = rev.at[jnp.where(keep, ds, n), jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ss, n), mode="drop")[:n]

    deg_own = jnp.sum(supply < n, axis=1, dtype=jnp.int32)
    deg_rev = jnp.sum(rev < n, axis=1, dtype=jnp.int32)
    fit = (deg_own + deg_rev) <= W
    return _merge_rev_rows(supply, rev, fit, n), rev, fit




def _own_overwrite(supply: jax.Array, chunk_lists: jax.Array, r0):
    """Own-row overwrite of one chunk (reference :1213). Traced helper
    shared by `_fold_round_device` and the slabbed fold prologue
    `_fold_own_rows` — ONE implementation so the two fold paths cannot
    drift (their bit-identity is test-pinned)."""
    n, W = supply.shape
    c, M = chunk_lists.shape
    row_ids = r0 + jnp.arange(c, dtype=jnp.int32)
    ok_row = row_ids < n
    chunk_lists = jnp.where(ok_row[:, None], chunk_lists, n)
    own_new = jnp.concatenate(
        [chunk_lists, jnp.full((c, W - M), n, jnp.int32)], axis=1)
    return supply.at[jnp.where(ok_row, row_ids, n)].set(
        own_new, mode="drop")


@partial(jax.jit, donate_argnums=(0,))
def _fold_own_rows(supply: jax.Array, chunk_lists: jax.Array, r0: jax.Array):
    """Own-row overwrite of one chunk, in place (slabbed fold prologue)."""
    return _own_overwrite(supply, chunk_lists, r0)


def _merge_rev_rows(own: jax.Array, rev: jax.Array, fit: jax.Array, n: int):
    """Append rev edges into own rows' free slots for rows that fit,
    dropping entries already present (the host fold's dedup), blocked so
    the [bs, W, W] membership broadcast stays bounded.

    Prefers a block size that DIVIDES the row count: the merged output
    shape then matches the donated input buffer, letting XLA alias them
    — a fresh N*W alloc here (2.56 GB at 10M) was part of the fold's
    RESOURCE_EXHAUSTED peak. Traced helper shared by
    `_fold_round_device` and `_fold_slab` (bit-identity test-pinned)."""
    rows, W = own.shape

    def blk(args):
        own_b, rev_b, fit_b = args
        dup = (rev_b[:, :, None] == own_b[:, None, :]).any(axis=2)
        posw = jax.lax.broadcasted_iota(jnp.int32, own_b.shape, 1)
        own_key = jnp.where(own_b < n, posw, 3 * W + posw)
        rev_key = jnp.where((rev_b < n) & ~dup, W + posw, 4 * W + posw)
        keys = jnp.concatenate([own_key, rev_key], axis=1)
        vals = jnp.concatenate([own_b, rev_b], axis=1)
        k_s, v_s = jax.lax.sort((keys, vals), dimension=-1, num_keys=1)
        packed = jnp.where(k_s[:, :W] < 2 * W, v_s[:, :W], jnp.int32(n))
        return jnp.where(fit_b[:, None], packed, own_b)

    bs = min(8192, rows)
    for cand_bs in range(min(8192, rows), 255, -1):
        if rows % cand_bs == 0:
            bs = cand_bs
            break
    pad_r = (-rows) % bs
    if pad_r:
        own = jnp.concatenate([own, jnp.full((pad_r, W), n, jnp.int32)])
        rev = jnp.concatenate([rev, jnp.full((pad_r, W), n, jnp.int32)])
        fit = jnp.concatenate([fit, jnp.zeros((pad_r,), jnp.bool_)])
    merged = jax.lax.map(
        blk, (own.reshape(-1, bs, W), rev.reshape(-1, bs, W),
              fit.reshape(-1, bs)))
    return merged.reshape(-1, W)[:rows]


def _round_edges(chunk_lists, r0, n):
    """Arrival-ordered reverse edge streams for one chunk: (ds, ss, rank),
    sorted by (destination, arrival). Traced helper shared by the slab
    fold and the overflow rev-row reconstruction."""
    c, M = chunk_lists.shape
    row_ids = r0 + jnp.arange(c, dtype=jnp.int32)
    ok_row = row_ids < n
    chunk_lists = jnp.where(ok_row[:, None], chunk_lists, n)
    src = jnp.repeat(row_ids, M)
    dst = chunk_lists.reshape(-1)
    dstk = jnp.where(dst < n, dst, jnp.int32(n))
    arrival = jnp.arange(c * M, dtype=jnp.int32)
    ds, _, ss = jax.lax.sort((dstk, arrival, src), dimension=-1, num_keys=2)
    is_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), ds[1:] != ds[:-1]])
    seg_start = jax.lax.cummax(jnp.where(is_start, arrival, 0))
    rank = arrival - seg_start
    return ds, ss, rank


@partial(jax.jit, donate_argnums=(0,), static_argnames=("sn",))
def _fold_slab(supply: jax.Array, chunk_lists: jax.Array, r0: jax.Array,
               lo: jax.Array, sn: int):
    """One row-slab of the fold: reverse-aggregate + merge rows
    [lo, lo+sn), updating the donated supply in place.

    Memory-bounded twin of `_fold_round_device` for corpora where the
    full-size reverse scratch + merged copy (2 x N x W int32 — 5.1 GB at
    10M) cannot sit next to base + supply: peak extra memory here is
    2 x sn x W. Outputs are bit-identical to the single-jit fold
    (same edges, same ranks, same merge) — pinned by
    tests/test_roargraph_build.py."""
    n, W = supply.shape
    ds, ss, rank = _round_edges(chunk_lists, r0, n)
    keep = (ds >= lo) & (ds < jnp.minimum(lo + sn, n)) & (rank < W)
    rev = jnp.full((sn + 1, W), n, jnp.int32)
    rev = rev.at[jnp.where(keep, ds - lo, sn),
                 jnp.where(keep, rank, 0)].set(
        jnp.where(keep, ss, n), mode="drop")[:sn]
    own = jax.lax.dynamic_slice_in_dim(supply, lo, sn, 0)
    deg_own = jnp.sum(own < n, axis=1, dtype=jnp.int32)
    deg_rev = jnp.sum(rev < n, axis=1, dtype=jnp.int32)
    fit = (deg_own + deg_rev) <= W
    merged = _merge_rev_rows(own, rev, fit, n)
    supply = jax.lax.dynamic_update_slice_in_dim(supply, merged, lo, 0)
    return supply, fit


@partial(jax.jit, static_argnames=("n", "W"))
def _rev_rows_for_ids(chunk_lists, r0, ids_sorted, n: int, W: int):
    """Reconstruct the arrival-order reverse lists for a sorted id set
    (sentinel-padded) — the overflow rows' rev candidates, without a
    dense N x W scratch."""
    K = ids_sorted.shape[0]
    ds, ss, rank = _round_edges(chunk_lists, r0, n)
    pos = jnp.searchsorted(ids_sorted, ds)
    pos_c = jnp.minimum(pos, K - 1)
    hit = (jnp.take(ids_sorted, pos_c) == ds) & (ds < n) & (rank < W)
    rev = jnp.full((K + 1, W), n, jnp.int32)
    rev = rev.at[jnp.where(hit, pos_c, K),
                 jnp.where(hit, rank, 0)].set(
        jnp.where(hit, ss, n), mode="drop")[:K]
    return rev


def _refill_rows_device(pruned: jax.Array, cand: jax.Array,
                        n: int) -> jax.Array:
    """Overflow-row refill: start from the pruned list, append candidates
    not already kept — in candidate (arrival) order, duplicates dropped —
    into free slots up to W = cand_width / 2."""
    return _refill_jit(pruned, cand, n=n)


@partial(jax.jit, static_argnames=("n",))
def _refill_jit(pruned, cand, n: int):
    K, M = pruned.shape
    C = cand.shape[1]
    W = C // 2
    merged0 = jnp.concatenate(
        [pruned, jnp.full((K, W - M), n, jnp.int32)], axis=1)
    dup = (cand[:, :, None] == merged0[:, None, :]).any(axis=2)
    posw = jax.lax.broadcasted_iota(jnp.int32, merged0.shape, 1)
    posc = jax.lax.broadcasted_iota(jnp.int32, cand.shape, 1)
    own_key = jnp.where(merged0 < n, posw, 3 * C + posw)
    cand_key = jnp.where((cand < n) & ~dup, W + posc, 4 * C + posc)
    keys = jnp.concatenate([own_key, cand_key], axis=1)
    vals = jnp.concatenate([merged0, cand], axis=1)
    k_s, v_s = jax.lax.sort((keys, vals), dimension=-1, num_keys=1)
    return jnp.where(k_s[:, :W] < 2 * C, v_s[:, :W], jnp.int32(n))


@partial(jax.jit, static_argnames=("cap", "n"))
def _compact_truncate_device(rows: jax.Array, cap: int, n: int) -> jax.Array:
    """Left-compact valid (< n) entries, truncate to cap, sentinel n."""
    K, W = rows.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, rows.shape, 1)
    key = jnp.where(rows < n, pos, W + pos)
    k_s, v_s = jax.lax.sort((key, rows), dimension=-1, num_keys=1)
    return jnp.where(k_s[:, :cap] < W, v_s[:, :cap], jnp.int32(n))


def _fold_and_overflow(base_dev, supply_dev, chunk_lists, r0, n, M, metric,
                       prune_batch):
    """Fold one round's pruned chunk lists into the live supply graph.

    Reverse edges: the reference appends while a destination is under 2M
    and occlusion-prunes back to M on overflow (SupplyAddReverse →
    PruneProjectionInternalReverseCandidates) — arrival-order insertion
    with prune-then-refill windows; a closest-first cap or a prune-only
    fold strands tail nodes with zero in-degree (measured 13-17k
    unreachable on a 100k corpus). Deterministic given (supply, chunk),
    which is what makes round-checkpoint replay sound.

    The N*W reverse scratch lives only inside this call — at 10M it is
    2.56 GB, and keeping it referenced across the next round's search
    (as the caller previously did) held it next to base + supply for no
    use. Above ~4M nodes the fold
    runs in row slabs (`_fold_slab` — bit-identical outputs) so the
    reverse scratch + merged copy never materialize at full N x W."""
    W = supply_dev.shape[1]
    slabbed = n >= 4_000_000
    if slabbed:
        supply_dev = _fold_own_rows(supply_dev, chunk_lists, jnp.int32(r0))
        # slab size: rev + merged scratch ~2 * sn * W * 4 bytes <= ~2.6 GB
        # (the earlier 26 << 28 constant was ~7 GB — 2.7x the documented
        # budget; it only held at <=10M because max(2, ...) dominated)
        n_slabs = max(2, -(-(8 * n * W) // (26 * 10 ** 8)))
        while n % n_slabs and n_slabs < 64:
            n_slabs += 1  # prefer equal slabs (one compiled shape)
        sn = -(-n // n_slabs)
        fits = []
        lo = 0
        while lo < n:
            s_len = min(sn, n - lo)
            supply_dev, fit_s = _fold_slab(
                supply_dev, chunk_lists, jnp.int32(r0), jnp.int32(lo),
                sn=s_len)
            fits.append(np.asarray(fit_s))
            lo += s_len
        fit = np.concatenate(fits)
    else:
        supply_dev, rev_dev, fit_d = _fold_round_device(
            supply_dev, chunk_lists, jnp.int32(r0))
        fit = np.asarray(fit_d)
    over = np.nonzero(~fit)[0]
    if over.size:
        K = max(1024, 1 << (int(over.size) - 1).bit_length())
        # pad with sentinel n: keeps the id vector sorted for the
        # searchsorted-based rev reconstruction; padded rows prune to
        # garbage and are dropped by the sentinel scatter below
        over_ids = np.full(K, n, np.int32)
        over_ids[: over.size] = over
        ids_dev = jnp.asarray(np.minimum(over_ids, n - 1))
        own_rows = jnp.take(supply_dev, ids_dev, axis=0)
        if slabbed:
            rev_rows = _rev_rows_for_ids(
                chunk_lists, jnp.int32(r0), jnp.asarray(over_ids), n=n, W=W)
        else:
            rev_rows = jnp.take(rev_dev, ids_dev, axis=0)
            del rev_dev
        cand = jnp.concatenate([own_rows, rev_rows], axis=1)
        pruned = _batched_prune_rows(
            base_dev, ids_dev, cand, M, metric, prune_batch,
            fill=False, return_device=True)
        # refill free slots with arrival-order leftovers not kept
        merged = _refill_rows_device(pruned, cand, n)
        scat = np.full(K, n, np.int32)
        scat[: over.size] = over
        supply_dev = supply_dev.at[jnp.asarray(scat)].set(
            merged, mode="drop")
    elif not slabbed:
        del rev_dev
    return supply_dev, fit


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("n_base", "M", "d", "bits"))
def _scatter_pack_rows(table, base, ids, supply, *, n_base, M, d, bits):
    """Repack ONLY the given supply rows into the fused byte-row table.

    ids int32 [B] (pad slots = n_base, which rewrites the sentinel row
    with sentinel content — a no-op by construction). Byte-identical to
    a full `pack_neighbor_table` for those rows: `_pack_chunk` is a pure
    per-row function of (base, row)."""
    from mysteryann_tpu.search.fused import _pack_chunk
    safe = jnp.minimum(ids, n_base - 1)
    rows = jnp.take(supply, safe, axis=0).astype(jnp.int32)
    rows = jnp.where((ids >= n_base)[:, None], n_base, rows)
    p = _pack_chunk(base, rows, n_base=n_base, M=M, d=d, bits=bits)
    return table.at[ids].set(p, mode="drop")


def _repack_changed(table, base_dev, supply_dev, ids_np, n, M, d, bits,
                    blk: int = 32768):
    """Scatter-repack the changed rows in fixed-size blocks (one compile)."""
    for s in range(0, ids_np.size, blk):
        b = ids_np[s: s + blk]
        idp = np.full(blk, n, np.int32)
        idp[: b.size] = b
        table = _scatter_pack_rows(table, base_dev, jnp.asarray(idp),
                                   supply_dev, n_base=n, M=M, d=d, bits=bits)
    return table


def _connectivity_pass(base_dev, projection, ep, cfg, metric, log,
                       ckpt=None, tag="phaseD", pass_i=0):
    """Phase D: per-node search + prune + reverse supply edges.

    The reference runs this incrementally — every node's search sees the
    supply edges (incl. reverse edges) added by nodes processed before it
    (src/index_bipartite.cpp:1192-1220 mutates supply_nbrs_ in-flight).
    That bootstrapping is what densifies a sparse post-projection graph;
    a single frozen-snapshot pass stalls on under-covered corpora. We
    reproduce it in rounds: the node set is processed in
    ``connectivity_rounds`` chunks, and after each chunk its pruned lists
    plus closest-first reverse edges (insertion budget 2·M_pjbp) are
    folded into the supply tensor the next chunk searches.

    Search engine per ``cfg.connectivity_engine``: "fused" repacks the
    live supply graph into int8 neighbor-block byte rows each round and
    traverses with one row gather per hop (search/fused.py) — the prune below
    recomputes exact f32 distances over the collected pool, so int8
    approximation affects traversal order only; "classic" is the f32
    lockstep beam (no table memory — the 10M+ path).
    """
    from mysteryann_tpu.search.fused import (_fused_beam, _row_bytes,
                                             pack_neighbor_table)

    n, M = projection.shape[0], cfg.M_pjbp
    d = base_dev.shape[1]
    L = cfg.L_pjpq
    sb = max(8, min(cfg.search_batch, n))
    eps = jnp.asarray([ep], jnp.int32)
    prune_batch = _prune_batch(cfg, n)
    t_walk = t_pack = t_fold = t_ckpt = 0.0

    # Round schedule trades build time for fidelity to the reference's
    # fully incremental pass (each node's search sees all previous
    # nodes' edges). Only fixed equal chunks are implemented:
    # connectivity_iters rounds of ceil(n/rounds) nodes (0 = 16). A
    # geometric-doubling schedule was studied and removed — at 1M with
    # identical data/params and full 32k eval it was noise (fixed-16
    # .7938, fixed-32 .7900, geometric .7912 at L=100, ±1pt run
    # sensitivity), while each extra chunk shape costs one more compile.
    # At 100k fixed-32 gained +1.5pt (.9440 vs .9285) — raise
    # connectivity_iters on small corpora where build time is cheap.
    # Passes >= 2 search an already-converged graph: they run
    # `_rounds_for_pass` rounds (default rounds/4, min 2).
    rounds = _rounds_for_pass(cfg, pass_i)
    chunks = [-(-n // rounds)] * rounds
    # live supply graph, width 2M (insertion budget) — DEVICE-resident:
    # the per-round fold runs on device (_fold_round_device); only tiny
    # fit-masks and overflow indices touch the host
    W = 2 * M
    if isinstance(projection, jax.Array):
        # device-resident pass input (multi-pass, n < 4M): widen/trim on
        # device, no host round trip. jnp.copy
        # on the trim path: a full-extent slice ALIASES the caller's
        # buffer, and the round fold donates supply_dev — donating an
        # alias kills the caller's projection (caught by
        # dryrun_multichip: "Buffer has been deleted or donated")
        pw = projection.shape[1]
        supply_dev = (jnp.copy(projection[:, :W]) if pw >= W
                      else jnp.concatenate(
            [projection.astype(jnp.int32),
             jnp.full((n, W - pw), n, jnp.int32)], axis=1))
        supply_dev = supply_dev.astype(jnp.int32)
    else:
        supply0 = np.full((n, W), n, np.int32)
        supply0[:, : projection.shape[1]] = projection[:, : W]
        supply_dev = jnp.asarray(supply0)   # 2.56 GB at 10M
        del supply0

    engine = _resolve_engine(cfg, n, d)
    bits = cfg.connectivity_bits
    dim_mult = 8 if bits == 8 else 16
    if engine == "fused" and d % dim_mult:
        raise ValueError(f"connectivity_engine='fused' needs dim % "
                         f"{dim_mult} == 0 at connectivity_bits={bits} "
                         f"(got d={d}); pad the vectors or use 'classic'")
    # entry-point seeding: the node's own vector is the query, so one
    # bf16 sample-scan matmul per batch replaces the ~40-hop medoid
    # navigation prefix of every phase-D search (same mechanism as
    # serving-side FusedSearcher(seed_sample=...); the sample is a
    # strided slice, ~n*d/rate bf16 bytes resident)
    seeds = cfg.connectivity_seeds if engine == "fused" else 0
    samp = samp_sq = samp_ids = None
    if seeds:
        from mysteryann_tpu.search.seeding import make_seed_sample, seed_scan
        samp, samp_sq, samp_ids = make_seed_sample(
            base_dev, cfg.connectivity_seed_sample)
    log(f"phase D engine: {engine} (expand={cfg.connectivity_expand}"
        + (f", bits={bits}"
           + (f", seeds={seeds}/1-in-{cfg.connectivity_seed_sample}"
              if seeds else "")
           if engine == "fused" else "") + ")")

    # projection rows feed only the per-batch not-seedable mask; above
    # ~4M nodes keep them on the HOST and upload [sb, M] slices (~0.5 MB)
    # per batch instead of holding an N*M int32 tensor (1.28 GB at 10M)
    # next to base+supply
    proj_on_host = n >= 4_000_000
    proj_dev = None if proj_on_host else jnp.asarray(projection)

    def proj_slice(sl):
        if proj_on_host:
            return jnp.asarray(projection[sl: sl + sb])
        return jax.lax.dynamic_slice_in_dim(proj_dev, sl, sb, 0)

    table = None
    packed_supply = None  # supply snapshot the current table reflects
    Mt = None
    H = cfg.history_mult * L  # history ≈ reference full_retset size
    r0 = 0
    for round_i, chunk in enumerate(chunks):
        r1 = min(r0 + chunk, n)
        # round-level resume: a transient device fault mid-phase must not
        # discard hours of search. Each
        # round's pruned chunk lists are checkpointed (~chunk*M*4 bytes);
        # resume replays the deterministic fold of saved rounds instead of
        # re-searching them.
        saved = ckpt.load(f"{tag}_r{round_i}") if ckpt is not None else None
        if saved is not None:
            chunk_dev = jnp.asarray(saved)
            supply_dev, fit = _fold_and_overflow(
                base_dev, supply_dev, chunk_dev, r0, n, M, metric,
                prune_batch)
            log(f"\rreplayed connectivity round {min(r1, n)}/{n}", end="")
            r0 = r1
            continue
        if engine == "fused":
            _t0 = _time.perf_counter()
            # Incremental repack: diff the supply against the snapshot the
            # current table was packed from and scatter-repack only changed
            # rows (byte-identical — _pack_chunk is pure per row). Late
            # pass-1 and all pass-2 rounds change a small fraction of rows
            # (the graph converges; reverse candidates dedup away), so this
            # replaces most full repacks with small scatters. Full repack when
            # >40% changed (scatter overhead passes the dense rewrite) or
            # on the first round. The snapshot is an explicit copy: the
            # fold donates supply_dev, which would invalidate a reference.
            W_sup = supply_dev.shape[1]
            if table is not None and packed_supply is not None \
                    and W_sup % 16 == 0:
                changed = jnp.any(packed_supply != supply_dev, axis=1)
                ids_np = np.nonzero(np.asarray(changed))[0].astype(np.int32)
            else:
                ids_np = None
            if ids_np is None or ids_np.size > (2 * n) // 5:
                # repack INTO the previous round's table buffer (donated) —
                # a fresh multi-GB contiguous alloc into a fragmented heap
                # can fail even where total free memory suffices
                table, Mt = pack_neighbor_table(base_dev, supply_dev,
                                                into=table, bits=bits)
            else:
                table = _repack_changed(table, base_dev, supply_dev,
                                        ids_np, n, Mt, d, bits)
            packed_supply = jnp.copy(supply_dev)
            table.block_until_ready()
            t_pack += _time.perf_counter() - _t0
        # device buffer for this chunk's pruned lists (+1 sentinel row for
        # clamped-window writes that fall outside the chunk)
        chunk_dev = jnp.full((chunk + 1, M), n, jnp.int32)
        _t0 = _time.perf_counter()
        for s in range(r0, r1, sb):
            # clamped full-width window: the tail re-searches a few rows
            # of the previous batch instead of padding (everything stays
            # ON DEVICE — no host round trip of the query block or the
            # expansion history)
            sl = max(0, min(s, n - sb))
            q = jax.lax.dynamic_slice_in_dim(base_dev, sl, sb, 0)
            if engine == "fused":
                seed_ids = seed_d = None
                if seeds:
                    seed_ids, seed_d = seed_scan(samp, samp_sq, samp_ids,
                                                 q, seeds, metric)
                r = _fused_beam(table, base_dev, eps, q, k=1, L=L,
                                metric=metric, max_hops=4 * L + 32,
                                n_base=n, M=Mt, d=d, collect_expanded=H,
                                expand=cfg.connectivity_expand, bits=bits,
                                seed_ids=seed_ids, seed_d=seed_d)
                pool = r[4]
                if s == r0 == 0:  # once per pass: history-cap pressure
                    hops_r = np.asarray(r[3])   # (forces one batch sync)
                    log(f"\rround@{r0}: search hops mean "
                        f"{hops_r.mean():.0f} max {hops_r.max()} "
                        f"(H={H})", end="")
            else:
                # expand>1 amortizes pool maintenance over several pops
                # per lockstep step, like the fused engine (the 1M recipe
                # builds with expand=4); traversal order shifts like the
                # reference under OpenMP interleaving
                r = beam_search(base_dev, supply_dev, eps, q,
                                k=1, L=L, metric=metric,
                                expand=cfg.connectivity_expand,
                                visited_mode="pool", collect_expanded=H)
                pool = r.hist_ids                           # [sb, H] dev
            # NO host sync here: search and prune of consecutive batches
            # pipeline on device while the host enqueues ahead
            # prune over the FULL expanded set (reference full_retset,
            # :1318) — includes expanded-then-dropped far nodes, whose
            # long-range edges the occlusion rule keeps for navigability
            node_ids = jnp.arange(sl, sl + sb, dtype=jnp.int32)
            # seed must not be an existing projection neighbor (:1861-1864)
            proj_rows = proj_slice(sl)
            ns = _membership(pool, proj_rows, n)
            # two_pass=False diverges DELIBERATELY from the reference's
            # second scan (:1897-1931, readmits pre-seed-skipped
            # projection members): reproducing it measured L=100 recall
            # .7883 vs .8038 without, on 1M — the readmitted short
            # edges displace diversity in our batched dynamics
            pruned = _batched_prune_rows(
                base_dev, node_ids, pool, M, metric, prune_batch,
                fill=False, not_seedable=ns, return_device=True)
            slot = jnp.arange(sl - r0, sl - r0 + sb, dtype=jnp.int32)
            slot = jnp.where((slot >= 0) & (slot < chunk), slot, chunk)
            chunk_dev = chunk_dev.at[slot].set(pruned)
        chunk_dev.block_until_ready()
        t_walk += _time.perf_counter() - _t0
        if ckpt is not None:
            _t0 = _time.perf_counter()
            ckpt.save(f"{tag}_r{round_i}", np.asarray(chunk_dev[:chunk]))
            t_ckpt += _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        supply_dev, fit = _fold_and_overflow(
            base_dev, supply_dev, chunk_dev[:chunk], r0, n, M, metric,
            prune_batch)
        supply_dev.block_until_ready()
        t_fold += _time.perf_counter() - _t0
        log(f"\rround {round_i}: cumulative walk {t_walk:.0f}s "
            f"pack {t_pack:.0f}s fold {t_fold:.0f}s "
            f"ckpt {t_ckpt:.0f}s", end="")
        r0 = r1
    log("")
    del table
    log(f"phase D split: walk (search+prune) {t_walk:.1f}s "
        f"pack {t_pack:.1f}s fold {t_fold:.1f}s ckpt {t_ckpt:.1f}s")

    # overflow re-prune: any row > M goes back through the occlusion prune
    # (reference :1224-1248, no fill)
    #
    # Memory discipline at 10M: the one-shot version kept base (5.1 GB)
    # + full-width supply (2.6 GB) + truncated copy (1.3 GB) + the
    # compact's sort scratch resident at once. Order of operations: slab the
    # degree scan, hoist the overflow rows to the HOST while supply is
    # alive, slab the compact-truncate, FREE supply, then prune from the
    # host copies.
    SLAB = min(n, 1 << 20)
    deg = np.empty(n, np.int32)
    for s in range(0, n, SLAB):
        st = min(s, n - SLAB)  # clamped window; overlap recomputed
        sl = jax.lax.dynamic_slice_in_dim(supply_dev, st, SLAB, 0)
        deg[st: st + SLAB] = np.asarray(
            jnp.sum(sl < n, axis=1, dtype=jnp.int32))
    over = np.nonzero(deg > M)[0]
    OB = 1 << 16  # one block shape = one compile
    cand_h = None
    if over.size:
        cand_h = np.empty((int(over.size), W), np.int32)
        for s in range(0, int(over.size), OB):
            blk = over[s: s + OB]
            ids = np.zeros(OB, np.int32)
            ids[: blk.size] = blk
            cand_h[s: s + blk.size] = np.asarray(
                jnp.take(supply_dev, jnp.asarray(ids), axis=0))[: blk.size]
    parts = []
    for s in range(0, n, SLAB):
        st = min(s, n - SLAB)
        sl = jax.lax.dynamic_slice_in_dim(supply_dev, st, SLAB, 0)
        parts.append(_compact_truncate_device(sl, cap=M, n=n)[s - st:])
    final_dev = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    final_dev.block_until_ready()
    del parts, supply_dev, chunk_dev
    if over.size:
        for s in range(0, int(over.size), OB):
            blk = over[s: s + OB]
            over_ids = np.zeros(OB, np.int32)  # pad rows pruned then dropped
            over_ids[: blk.size] = blk
            cand = np.full((OB, W), n, np.int32)
            cand[: blk.size] = cand_h[s: s + blk.size]
            # same prune variant as the in-round pass (reference reuses
            # PruneProjectionBaseSearchCandidates at :1240): projection
            # members can't seed (two_pass off — see the in-round note)
            proj_rows = projection[np.minimum(over_ids, n - 1)]
            ns = _membership(cand, proj_rows, n)
            pruned = _batched_prune_rows(
                base_dev, over_ids, cand, M, metric, prune_batch,
                fill=False, not_seedable=ns, return_device=True)
            scat = np.full(OB, n, np.int32)
            scat[: blk.size] = blk
            final_dev = final_dev.at[jnp.asarray(scat)].set(
                pruned, mode="drop")
    # below 4M the result stays device-resident (the caller's per-pass
    # append/cap runs on device); at >=4M memory discipline wants it
    # off the device
    if n < 4_000_000:
        final_dev.block_until_ready()
        return final_dev
    return np.asarray(final_dev)


def _left_compact(arr: np.ndarray, sentinel: int) -> np.ndarray:
    order = np.argsort(arr == sentinel, axis=1, kind="stable")
    return np.take_along_axis(arr, order, axis=1)


def _ensure_reachability(final: np.ndarray, ep: int, base_dev, metric,
                         log) -> np.ndarray:
    """Phase E: make every node reachable from the entry point.

    The reference carries this as dead code (findroot/dfs/CollectPoints,
    src/index_bipartite.cpp:2521-2604 — the NSG-style tree attach, its
    call commented out at :211): find nodes unreachable from the medoid
    and attach each to its nearest reachable node. Our batched build
    strands a few percent of tail nodes (the reference's racy incremental
    inserts mostly avoid it on its datasets), so we run the repair for
    real: BFS from ep, then per unreachable node append it to its nearest
    reachable neighbor's list (first free slot, else replace the last),
    iterating until the graph is fully reachable.
    """
    from mysteryann_tpu.ops.knn import exact_knn_device

    if not final.flags.writeable:  # np.asarray of a device array is a
        final = final.copy()       # read-only view; the repair mutates
    n, width = final.shape
    for it in range(8):
        # BFS from ep (vectorized frontier waves)
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
                log(f"phase E: reachability repaired in {it} rounds")
            return final
        log(f"phase E round {it}: {stranded.size} unreachable nodes")
        # nearest reachable neighbor for each stranded node. Fixed-size
        # query blocks (padded, one compiled shape): exact_knn_device
        # holds a [B, tile] distance block, so an unchunked B =
        # stranded.size OOMs when a big build strands 100k+ nodes.
        kk = 32
        qb = min(8192, 1 << max(5, (stranded.size - 1).bit_length()))
        cand = np.empty((stranded.size, kk), np.int32)
        for s in range(0, int(stranded.size), qb):
            blk = stranded[s: s + qb]
            pad_ids = np.zeros(qb, np.int32)
            pad_ids[: blk.size] = blk
            q = jnp.take(base_dev, jnp.asarray(pad_ids), axis=0)
            # full f32: TF32 scores would let near-tie anchors depend
            # on the kernel XLA picks for this shape
            _, c = exact_knn_device(q, base_dev, k=kk, metric=metric,
                                    tile=min(131072, n),
                                    precision="highest")
            cand[s: s + blk.size] = np.asarray(c)[: blk.size]
        # attach to the A nearest reachable anchors (a single thin edge
        # leaves repaired nodes hard to find; the reference's tail nodes
        # carry ~M/2 in-edges)
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
        if none_found.any():  # fall back to the entry point itself
            u_all = np.concatenate([u_all, stranded[none_found]])
            v_all = np.concatenate(
                [v_all, np.full(none_found.sum(), ep, np.int64)])
        # append u into v's list; collisions get successive free slots
        order = np.argsort(v_all, kind="stable")
        at_s, u_s = v_all[order], u_all[order]
        counts = np.bincount(at_s, minlength=n)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        rank = np.arange(at_s.size) - offs[at_s]
        free0 = (final[at_s] < n).sum(axis=1)
        slot = np.minimum(free0 + rank, width - 1)
        final[at_s, slot] = u_s.astype(np.int32)
    log("phase E: WARNING — repair did not converge in 8 rounds")
    return final


def _membership(pool: np.ndarray, rows: np.ndarray, n: int) -> np.ndarray:
    """pool[b, l] ∈ rows[b, :] — bool [B, L] (host, small batches)."""
    return (pool[:, :, None] == rows[:, None, :]).any(axis=2) & (pool < n)


def _cap_degree(rows, base_dev, cap: int, metric, batch: int, n: int):
    """Bound every row to ``cap`` edges: rows over the cap go through the
    occlusion prune (fill pass keeps them full); rows within it are
    copied (they are left-compacted, so truncating the width is lossless).
    Used by multi-pass phase D to hold the reference's 2*M degree bound.
    Type-preserving like `_append_novel` (device in → device out; only
    the tiny overfull-row id set touches the host)."""
    if isinstance(rows, jax.Array):
        deg = jnp.sum(rows < n, axis=1, dtype=jnp.int32)
        over = np.nonzero(np.asarray(deg > cap))[0]          # ids only
        out = rows[:, :cap]
        if over.size:
            OB = 1 << 15
            for s in range(0, int(over.size), OB):
                blk = over[s: s + OB]
                ids = np.full(OB, n, np.int32)   # pad rows dropped below
                ids[: blk.size] = blk
                ids_c = jnp.asarray(np.minimum(ids, n - 1))  # gather-safe
                cand = jnp.take(rows, ids_c, axis=0)
                pruned = _batched_prune_rows(
                    base_dev, ids_c, cand, cap, metric, batch,
                    fill=True, return_device=True)
                # pad rows (id n) scatter out of bounds -> dropped
                out = out.at[jnp.asarray(ids)].set(pruned, mode="drop")
        return out
    deg = (rows < n).sum(axis=1)
    out = np.full((rows.shape[0], cap), n, np.int32)
    ok = deg <= cap
    out[ok] = rows[ok][:, :cap]
    over = np.nonzero(~ok)[0]
    if over.size:
        pruned = _batched_prune_rows(
            base_dev, over.astype(np.int32), rows[over], cap, metric,
            batch, fill=True)
        out[over] = pruned
    return out


@partial(jax.jit, static_argnames=("n", "w_add"))
def _append_novel_block(proj_b: jax.Array, sup_b: jax.Array, n: int,
                        w_add: int):
    """One row block of the novel-supply append, on device (same key-sort
    recast as `_merge_fr_block`; the former host version's [N, Ws, M]
    numpy dedup broadcast was single-core time inside every phase-D
    pass)."""
    bs, M = proj_b.shape
    nov_b = sup_b[:, :w_add]
    C = M + w_add
    dup = (nov_b[:, :, None] == proj_b[:, None, :]).any(axis=2)
    posP = jax.lax.broadcasted_iota(jnp.int32, proj_b.shape, 1)
    posN = jax.lax.broadcasted_iota(jnp.int32, nov_b.shape, 1)
    p_key = jnp.where(proj_b < n, posP, 2 * C + posP)
    n_key = jnp.where((nov_b < n) & ~dup, M + posN, 3 * C + posN)
    keys = jnp.concatenate([p_key, n_key], axis=1)
    vals = jnp.concatenate([proj_b, nov_b], axis=1)
    k_s, v_s = jax.lax.sort((keys, vals), dimension=-1, num_keys=1)
    return jnp.where(k_s < 2 * C, v_s, jnp.int32(n))


def _append_novel(projection, supply, cap_add: int, n: int):
    """Append up to cap_add supply edges not already in projection.

    Projection rows are left-compacted, so the stable key sort appends
    each row's novel entries right after its own degree — identical
    output to the former host argsort path (oracle-pinned in
    tests/test_roargraph_build.py), blocked on device. Type-preserving:
    a device ``projection`` yields a device result (no host round trip
    between phase-D passes); host in → host out."""
    N, M = projection.shape
    w_add = min(cap_add, supply.shape[1])
    on_dev = isinstance(projection, jax.Array)
    proj_dev = jnp.asarray(projection, jnp.int32)
    sup_dev = jnp.asarray(supply, jnp.int32)
    bs = max(1024, min(N, (1 << 29) // max(1, supply.shape[1] * M)))
    out = None if on_dev else np.empty((N, M + w_add), np.int32)
    blks = []
    for s in range(0, N, bs):
        st = min(s, max(0, N - bs))
        blk = _append_novel_block(
            jax.lax.dynamic_slice_in_dim(proj_dev, st, min(bs, N), 0),
            jax.lax.dynamic_slice_in_dim(sup_dev, st, min(bs, N), 0),
            n=n, w_add=w_add)
        if on_dev:
            blks.append(blk[s - st:])
        else:
            out[st: st + bs] = np.asarray(blk)
    if on_dev:
        return blks[0] if len(blks) == 1 else jnp.concatenate(blks)
    return out
