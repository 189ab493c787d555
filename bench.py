"""Serving benchmark — one JSON line (stdout).

Metric (BASELINE.md north star): QPS/chip at recall@10 >= 0.95 on a
T2I-like synthetic 1M-vector cross-modal workload (128-d, inner product,
OOD training queries), single device. The framework's best serving mode
at that recall wins (flat scan, int8 flat scan, or the RoarGraph engine;
all rows are reported). ``vs_baseline`` is the ratio
against the reference's measured CPU QPS at the same recall on identical
data (see baseline/ and BASELINE.md), extrapolated to its 16-thread
search config.

Artifacts (synthetic data, GT, train kNN, built index) are cached under
``.bench_cache/`` keyed by the scale config; all progress goes to stderr.
Everything, the index build included, runs in this one process: a JAX
process reserves most of the device's memory, so a second one on the
same device would fail to allocate.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np


CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")

# scale config (T2I-1M slice, BASELINE.json configs[0]).
# v3 = difficulty-calibrated world: v2's in-world eval was too easy (the
# reference graph crossed recall .95 at L_pq=15; on its real T2I
# benchmark that crossing sits near L~100-200). v3's geometry (20k
# concepts, intrinsic dim 48, noise .85 — scripts/calibrate_world.py)
# puts the reference's .95 crossing at L=125 at 1M, measured with its
# own binary: the synthetic proxy now exercises the regime the
# reference was built for. World history in BASELINE.md.
KEY_VERSION = "v3"
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
N_BASE = 1_000_000
N_TRAIN = 200_000
# 4 device batches of 8192 per timed sweep (the reference's own
# protocol sweeps 100k queries per row)
N_EVAL = 32_768
DIM = 128
METRIC = "ip"
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128
# phase-D throughput knobs (measured equal-recall at 1M, BASELINE.md):
# expand=4 amortizes pool maintenance over 4 pops/step, bits=4 halves
# the per-expansion gather bytes of the repacked supply table
BUILD_EXPAND, BUILD_BITS = 4, 4
TARGET_RECALL = 0.95
# median-of-5 trials after the ramp (3 trials let one outlier land as
# the min or the median)
REPEATS = 5
# seeded graph serving (the record config, see BASELINE.md): per-query
# entry points from a strided 1-in-2 bf16 sample scan, 48-wide packed
# rows, 40 seeds. Seed density is the big recall lever at 1M
# (scripts/probe_1m_fused.py): the 1-in-2 scan alone holds ~half the
# true top-10, moving the .95 crossing to L=48. The sweep runs PAST the
# .95 crossing into the ≥.98 high-recall frontier (the reference driver
# sweeps 57 L values).
SEED_SAMPLE, SEED_MAX_DEGREE, SEEDS = 2, 48, 40
# (expand, seeds, L) rows: expand=4 through the .95 crossing; the
# high-recall tail drops expand and rides to recall ≥ .99 (recorded:
# e3 L=176 → .9910, e2 L=224 → .9938 — probe_frontier_99.py). The 1M
# int4 sweep is not in this path (int4 recall is dominated at 1M — its
# regime is 4M, scripts/bench_4m_fused.py).
SEEDED_L_SWEEP = ((4, 40, 40), (4, 40, 44), (4, 40, 48), (4, 40, 56),
                  (4, 40, 64), (4, 40, 80), (4, 40, 112),
                  (3, 48, 144), (3, 48, 176), (2, 48, 224))


def log(*a, **k):
    print(*a, file=sys.stderr, flush=True, **k)


def _cached(name, fn):
    from mysteryann_tpu.utils.cache import npz_cached
    return npz_cached(CACHE, name, fn)


def read_baseline_qps() -> float:
    """Measured reference CPU QPS at target recall (16-thread equivalent)."""
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE.md")) as f:
            m = re.search(r"MEASURED_REFERENCE_QPS_AT_R95_T16\s*=\s*([0-9.]+)",
                          f.read())
        return float(m.group(1)) if m else 0.0
    except OSError:
        return 0.0


def _finish_row(r, gt_i, gt_d, k, metric=METRIC):
    """Attach recall + rderr, strip the bulky ids/dists arrays."""
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr
    r["recall"] = compute_recall(r["ids"], gt_i, k)
    r["rderr"] = compute_rderr(np.asarray(r["dists"]), gt_d, k, metric)
    return {kk: vv for kk, vv in r.items() if kk not in ("ids", "dists")}


def _bench_median(bench_fn, gt_i, gt_d, k, repeats=REPEATS, ramp=2):
    """Median-of-`repeats` timing after a `ramp` discard window.

    The first ramp trial also warms compile. qps is the median of the
    trials after the ramp, qps_min/qps_max their spread."""
    ramp_qps = [round(bench_fn(warmup=1 if t == 0 else 0)["qps"], 1)
                for t in range(ramp)]
    trials = [bench_fn(warmup=0) for _ in range(repeats)]
    qpss = sorted(t["qps"] for t in trials)
    row = _finish_row(trials[-1], gt_i, gt_d, k)
    row["qps"] = qpss[len(qpss) // 2]
    row["qps_trials"] = [round(x, 1) for x in qpss]
    row["qps_min"], row["qps_max"] = qpss[0], qpss[-1]
    row["qps_ramp"] = ramp_qps  # recorded, not medianed
    row["mean_latency_ms"] = trials[-1]["mean_latency_ms"]
    return row


def _fresh_mode():
    """Reset live executables/buffers between serving modes (build-sized
    allocation churn was seen to depress the fused engine). Costs one
    re-trace per mode."""
    import jax
    jax.clear_caches()


def _build_index(base, train_q, knn, index_path, checkpoint_dir):
    """Build + save the graph index, in this process."""
    from mysteryann_tpu.graph import build_roargraph
    from mysteryann_tpu.utils.params import BuildConfig

    # connectivity_passes=2: the second phase-D sweep searches the
    # completed graph (measured at 1M: recall@10 at L=100 .794 -> .865,
    # beating the reference's .838 on identical data)
    cfg = BuildConfig(M_sq=M_SQ, M_pjbp=M_PJBP, L_pjpq=L_PJPQ,
                      metric=METRIC, query_batch=8192, search_batch=8192,
                      connectivity_passes=2,
                      connectivity_expand=BUILD_EXPAND,
                      connectivity_bits=BUILD_BITS)
    # stage the base in device memory before the clock: the reference's
    # build timer starts with data already in RAM (baseline/
    # bench_reference.cpp — load_data precedes t0, BuildRoarGraph
    # gets in-memory pointers)
    import jax
    from mysteryann_tpu.ops.distances import prepare_vectors
    base_staged = jax.block_until_ready(prepare_vectors(base, METRIC))
    t0 = time.time()
    index = build_roargraph(base_staged, train_q, knn, cfg, verbose=True,
                            checkpoint_dir=checkpoint_dir)
    build_secs = time.time() - t0
    log(f"build took {build_secs:.1f}s")
    index.save(index_path)
    with open(index_path + ".build.json", "w") as f:
        json.dump({"build_secs": round(build_secs, 1)}, f)


def _headline(value, base_qps, detail, provisional=False):
    """The compact driver-facing JSON line (< ~600 chars)."""
    result = {
        "metric": f"QPS/chip at recall@{K}>={TARGET_RECALL} on synthetic "
                  f"T2I-1M ({DIM}d, IP, OOD)",
        "value": round(value, 1),
        "unit": "QPS",
        "vs_baseline": round(value / base_qps, 3) if base_qps else 0.0,
        "detail": detail,
    }
    if provisional:
        result["provisional"] = True
    return result


def main():
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import exact_knn
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.graph import RoarGraphIndex
    from mysteryann_tpu.search import Searcher

    from mysteryann_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    t_all = time.time()
    key = f"t2i1m_{KEY_VERSION}_{N_BASE}_{N_TRAIN}_{DIM}"

    log("== data ==")
    base, train_q = _cached(key + "_data", lambda: make_cross_modal(
        N_BASE, N_TRAIN, DIM, metric=METRIC, seed=7, **WORLD))
    # eval queries: SAME world as base/train (query_seed draws a fresh
    # stream inside the seed-7 world). The old `seed=8` eval came from
    # an unrelated synthetic world — near-isotropic w.r.t. this base
    # (measured top-1 IP .49 vs .86 in-world), not the advertised OOD
    # cross-modal workload. New cache keys (_evalw/_gtw) bust the stale
    # artifacts; base/train and the built graph caches stay valid.
    (eval_q,) = _cached(f"{key}_evalw{N_EVAL}", lambda: [make_cross_modal(
        1, N_EVAL, DIM, metric=METRIC, seed=7, query_seed=8, **WORLD)[1]])

    log("== ground truth (exact) ==")
    gt_i, gt_d = _cached(f"{key}_gtw{N_EVAL}", lambda: list(reversed(
        exact_knn(eval_q, base, k=K, metric=METRIC, query_batch=8192,
                  base_tile=131072, precision="highest"))))
    gt_i = gt_i.astype(np.int64)

    tag = f"p2e{BUILD_EXPAND}b{BUILD_BITS}"
    index_path = os.path.join(
        CACHE, f"{key}_{M_SQ}_{M_PJBP}_{L_PJPQ}_{tag}_proj.index")
    ck_dir = os.path.join(CACHE, f"{key}_{M_SQ}_{M_PJBP}_{L_PJPQ}_{tag}_ck")
    base_qps = read_baseline_qps()

    # ---- flat index FIRST -------------------------------------------------
    # Flat needs no index, so it runs before the graph build and its
    # result is flushed to stdout as a PROVISIONAL headline immediately:
    # if a timeout kills the run mid-build, the provisional line is
    # already in the recorded tail. The scan tile is sized from device
    # memory (flat.flat_tile).
    log("== flat index ==")
    flat = FlatIndex(base, metric=METRIC)
    flat_row = _bench_median(
        lambda warmup: flat.benchmark(eval_q, k=K, warmup=warmup),
        gt_i, gt_d, K)
    log(f"flat: QPS={flat_row['qps']:.0f} recall={flat_row['recall']:.4f}")
    del flat  # release the device-resident base copy
    _fresh_mode()

    if flat_row["recall"] >= TARGET_RECALL:
        print(json.dumps(_headline(
            flat_row["qps"], base_qps,
            {"mode": "flat", "recall": round(flat_row["recall"], 4),
             "flat_qps": round(flat_row["qps"], 1),
             "baseline_qps_t16": base_qps,
             "note": "flat rows only; graph rows follow"},
            provisional=True)), flush=True)

    # int8 flat (global-scale scan + exact f32 rerank of the 2k head)
    flat8 = FlatIndex(base, metric=METRIC, precision="int8", oversample=2)
    flat8_row = _bench_median(
        lambda warmup: flat8.benchmark(eval_q, k=K, warmup=warmup),
        gt_i, gt_d, K)
    log(f"flat int8: QPS={flat8_row['qps']:.0f} "
        f"recall={flat8_row['recall']:.4f}")
    del flat8
    _fresh_mode()

    # ---- RoarGraph engine (parity evidence + large-N regime) --------------
    if not os.path.exists(index_path):
        # build AFTER the flat rows (provisional headline already out).
        # The build checkpoints per phase/round, so if a timeout kills
        # it, the next run resumes.
        log("== build ==")
        (knn_b,) = _cached(key + "_knn", lambda: [exact_knn(
            train_q, base, k=M_SQ, metric=METRIC, query_batch=8192,
            base_tile=131072)[1]])
        _build_index(base, train_q, knn_b, index_path, ck_dir)
        _fresh_mode()
    index = RoarGraphIndex.load(index_path)
    build_secs = None
    # build time sidecar: cache hits must still report graph_build_secs
    try:
        with open(index_path + ".build.json") as f:
            build_secs = json.load(f)["build_secs"]
    except (OSError, KeyError, ValueError):
        pass

    log("== graph search sweep (fused int8 engine, seeded) ==")
    from mysteryann_tpu.search.fused import FusedSearcher

    def graph_sweep(bits, rows_spec):
        fused = FusedSearcher(index, base, max_degree=SEED_MAX_DEGREE,
                              seed_sample=SEED_SAMPLE, bits=bits)
        rows = []
        for expand, seeds, L in rows_spec:
            # expand>1: per-step pool-maintenance costs amortize over
            # `expand` expansions; seeds from the dense 1-in-2 sample
            # scan (entry points inside the target neighborhood — the
            # scan replaces the medoid walk, the graph does the
            # precision work)
            r = _bench_median(
                lambda warmup: fused.benchmark(
                    eval_q, k=K, L=L, query_batch=8192, expand=expand,
                    seeds=min(seeds, L),  # search() rejects seeds>L
                    warmup=warmup),
                gt_i, gt_d, K)
            r["expand"], r["seeds"] = expand, seeds
            rows.append(r)
            log(f"bits={bits} e={expand} L={L}: QPS={r['qps']:.0f} "
                f"[{r['qps_min']:.0f},{r['qps_max']:.0f}] "
                f"recall={r['recall']:.4f} cmps={r['avg_cmps']:.0f} "
                f"hops={r['avg_hops']:.0f}")
        del fused
        _fresh_mode()
        return rows

    graph_rows = graph_sweep(8, SEEDED_L_SWEEP)
    at_target = [r for r in graph_rows if r["recall"] >= TARGET_RECALL]
    graph_best = max(at_target, key=lambda r: r["qps"]) if at_target else None

    # refreshed provisional: best mode so far (keep the current best
    # landing on stdout in case a timeout cuts the remaining stages)
    so_far = [r for r in [flat_row, flat8_row, graph_best]
              if r and r["recall"] >= TARGET_RECALL]
    if so_far:
        b = max(so_far, key=lambda r: r["qps"])
        print(json.dumps(_headline(
            b["qps"], base_qps,
            {"mode": ("flat" if b is flat_row else
                      "flat_int8" if b is flat8_row else "roargraph"),
             "recall": round(b["recall"], 4),
             "note": "pre-final; classic row pending"},
            provisional=True)), flush=True)

    # classic engine, one parity row (same graph, f32 vectors)
    searcher = Searcher(index, base)
    classic_row = _bench_median(
        lambda warmup: searcher.benchmark(
            eval_q, k=K, L=100, query_batch=N_EVAL,
            visited_mode="pool", expand=2, warmup=warmup),
        gt_i, gt_d, K)
    log(f"classic L=100: QPS={classic_row['qps']:.0f} "
        f"recall={classic_row['recall']:.4f}")

    # headline: best mode meeting the recall target
    candidates = [row for row in ([flat_row, flat8_row]
                                  + ([graph_best] if graph_best else []))
                  if row and row["recall"] >= TARGET_RECALL]
    best = max(candidates, key=lambda r: r["qps"]) if candidates else None
    value = best["qps"] if best else 0.0

    def _r(row):
        return {kk: (round(vv, 4) if isinstance(vv, float) else vv)
                for kk, vv in (row or {}).items()}

    detail = {
        "mode": ("flat" if best is flat_row else
                 "flat_int8" if best is flat8_row else
                 "roargraph" if best else "none"),
        "recall": round(best["recall"], 4) if best else 0.0,
        "flat": _r(flat_row),
        "flat_int8": _r(flat8_row),
        "graph_rows": [_r(r) for r in graph_rows],
        "classic_graph_row": _r(classic_row),
        "graph_build_secs": (None if build_secs is None
                             else round(build_secs, 1)),
        "baseline_qps_t16": base_qps,
        "wall_secs": round(time.time() - t_all, 1),
    }
    gbest = _r(graph_best) if graph_best else None
    # compact summary only — a bounded stdout tail must still hold the
    # headline. Full rows: bench_detail.json.
    result = _headline(value, base_qps, {
        "mode": detail["mode"], "recall": detail["recall"],
        "flat_qps": detail["flat"].get("qps"),
        "graph_best": ({"qps": gbest["qps"], "recall": gbest["recall"],
                        "L": gbest.get("L_pq")} if gbest else None),
        "graph_build_secs": detail["graph_build_secs"],
        "baseline_qps_t16": base_qps,
        "detail_file": "bench_detail.json",
    })
    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "bench_detail.json")
    with open(detail_path, "w") as f:
        json.dump({**result, "detail": detail}, f, indent=1)
    log(json.dumps(detail))  # full rows on stderr for interactive runs
    # the headline line is LAST on stdout and compact (< ~600 chars)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
