"""10M-scale serving benchmark (the reference's headline T2I-10M regime).

Measures the device-timed QPS/recall of the flat f32 scan, the int8
global-scale scan, and the IVF index on a 10M x 128-d synthetic
cross-modal corpus (same family as bench.py's 1M slice) with exact
ground truth. Methodology matches bench.py: queries pre-staged in HBM,
results blocked on device, 4 chained 8192-query batches per host sync.

Artifacts cache under .bench_cache/ keyed by scale; results feed the 10M
table in BASELINE.md. Run: `python scripts/bench_10m.py`.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".cache", "jax"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "5")
# env var alone is ignored by this JAX build — the config route
# must initialize the cache (utils/cache.py)
from mysteryann_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".bench_cache")
N_BASE = 10_000_000
N_EVAL = 32_768
DIM = 128
K = 10
# must match scripts/build_10m.py (the graph/eval caches are shared)
KEY_VERSION = "v3"
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cached(name, fn):
    from mysteryann_tpu.utils.cache import npz_cached
    return npz_cached(CACHE, name, fn)



def med3(bench_fn):
    """Plateau median-of-3 after a 2-trial ramp discard (row convention
    shared with bench.py; ramp rationale: BASELINE.md variance root
    cause, probe_variance.py 2026-08-20)."""
    for t in range(2):
        bench_fn(warmup=1 if t == 0 else 0)
    trials = [bench_fn(warmup=0) for _ in range(3)]
    qpss = sorted(t["qps"] for t in trials)
    r = trials[-1]
    r["qps"], r["qps_min"], r["qps_max"] = qpss[1], qpss[0], qpss[2]
    return r


def main():
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import exact_knn
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.utils.metrics import compute_recall

    key = f"t2i10m_{KEY_VERSION}_{N_BASE}_{DIM}"
    log("== data ==")
    (base,) = cached(key + "_base", lambda: [make_cross_modal(
        N_BASE, 10, DIM, metric="ip", seed=17, **WORLD)[0]])
    # eval queries: SAME seed-17 world as the base (the old `seed=18`
    # eval was an unrelated synthetic world — near-isotropic w.r.t.
    # this base, not the advertised cross-modal workload). Reuse
    # build_10m.py's held-out eval split when its cache exists (the
    # graph serving rows below were built against that same world).
    gkey = f"{key}_graph1000000"
    q_path = os.path.join(CACHE, f"{gkey}_queries.npz")
    if os.path.exists(q_path):
        with np.load(q_path) as z:
            eval_q = z["eval"]
    else:
        (eval_q,) = cached(f"{key}_evalw{N_EVAL}", lambda: [make_cross_modal(
            1, N_EVAL, DIM, metric="ip", seed=17, query_seed=18,
            **WORLD)[1]])

    log("== exact GT ==")
    # exact top_k does not fuse with the matmul, so the [qb, tile] f32
    # block materializes — keep it ~1 GB next to the 5.1 GB base
    gt_i, _ = cached(f"{gkey}_gt" if os.path.exists(q_path)
                     else f"{key}_gtw{N_EVAL}",
                     lambda: list(reversed(exact_knn(
                         eval_q, base, k=K, metric="ip", query_batch=2048,
                         base_tile=131072, precision="highest"))))
    gt_i = gt_i.astype(np.int64)

    rows = []
    only_ivf = "--only-ivf" in sys.argv  # re-run the IVF rows alone
    if only_ivf:
        return _ivf_rows(base, eval_q, gt_i, rows, only_ivf=True)
    if "--sharded-fused" in sys.argv:
        mp = int(sys.argv[sys.argv.index("--sharded-fused") + 1])
        return _sharded_fused_rows(base, eval_q, gt_i, key, mp)
    skip_flat = "--skip-flat" in sys.argv  # graph/IVF-focused re-run
    skip_ivf = "--skip-ivf" in sys.argv

    def flat_row(precision, oversample):
        idx = FlatIndex(base, metric="ip", precision=precision,
                        oversample=oversample)
        r = med3(lambda warmup: idx.benchmark(eval_q, k=K, warmup=warmup))
        r["recall"] = compute_recall(r["ids"], gt_i, K)
        rows.append({"mode": f"flat_{precision}", "qps": round(r["qps"], 1),
                     "qps_min": round(r["qps_min"], 1),
                     "qps_max": round(r["qps_max"], 1),
                     "recall": round(r["recall"], 4)})
        log(rows[-1])

    if not skip_flat:
        log("== flat f32 ==")
        flat_row("f32", 2)
        # bf16-RESIDENT table: the 39-tile 10M sweep is HBM-bound
        # (unlike single-tile 1M) — 2.56 GB/batch vs f32's 5.1 GB
        log("== flat bf16-resident (half the sweep bytes) + f32 rerank ==")
        flat_row("bf16", 2)
        log("== flat int8 (global scale) ==")
        flat_row("int8", 4)

    # ---- RoarGraph (built by scripts/build_10m.py; cached index) ----------
    # The reference's headline regime is the 10M *graph* build + search
    # (reference run_roargraph_test.sh:5-10). build_10m.py owns the
    # multi-hour build; this sweep reports its serving rows whenever the
    # cached index is present so the 10M table carries graph rows.
    from mysteryann_tpu.graph import RoarGraphIndex
    from mysteryann_tpu.search import Searcher
    gkey = f"{key}_graph1000000"
    for passes in (2, 1):
        index_path = os.path.join(CACHE, f"{gkey}_p{passes}_proj.index")
        if not os.path.exists(index_path):
            continue
        build_secs = None
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
        log(f"== RoarGraph (cached {passes}-pass index, seeded classic) ==")
        index = RoarGraphIndex.load(index_path)
        s = Searcher(index, base, seed_sample=8)
        for L in (100, 150, 250):
            r = med3(lambda warmup: s.benchmark(
                eval_q, k=K, L=L, query_batch=8192,
                visited_mode="merge", expand=4, seeds=32, warmup=warmup))
            rows.append({"mode": f"graph_p{passes}_seeded_L{L}",
                         "qps": round(r["qps"], 1),
                         "qps_min": round(r["qps_min"], 1),
                         "qps_max": round(r["qps_max"], 1),
                         "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                         "build_s": build_secs})
            log(rows[-1])
        del s, index
        break

    if skip_ivf:
        print(json.dumps({"scale": N_BASE, "rows": rows,
                          "skipped": ["ivf"] + (["flat"] if skip_flat
                                                else [])}))
        return
    _ivf_rows(base, eval_q, gt_i, rows)


def _sharded_fused_rows(base, eval_q, gt_i, key, mp):
    """10M graph serving through the mp-sharded fused byte-row engine
    A bits=4 M=32 table is 3 KB/row -> 28.6+ GB at 10M; row-sharded over ``mp`` chips each shard is
    (n/mp + 1) x 3 KB ~= 3.84 GB at mp=8 (shape math pinned in
    tests/test_sharded_fused.py::test_10m_shard_packing_math). On real
    multi-chip hardware this is the one command that lands the 10M
    sublinear graph row:

        python scripts/bench_10m.py --sharded-fused 8

    On a single-chip rig it degrades gracefully (mesh creation fails
    with a clear device-count error)."""
    import jax
    from mysteryann_tpu.graph import RoarGraphIndex
    from mysteryann_tpu.parallel import ShardedFusedSearcher, make_mesh
    from mysteryann_tpu.utils.metrics import compute_recall

    gkey = f"{key}_graph1000000"
    index_path = next((p for p in (
        os.path.join(CACHE, f"{gkey}_p{ps}_proj.index") for ps in (2, 1))
        if os.path.exists(p)), None)
    if index_path is None:
        log("no cached 10M index — run scripts/build_10m.py first")
        sys.exit(2)
    n_dev = len(jax.devices())
    dp = n_dev // mp
    mesh = make_mesh(dp=max(1, dp), mp=mp)
    log(f"== sharded fused serve (mesh dp={max(1, dp)} x mp={mp}, "
        f"bits=4, M=32) ==")
    index = RoarGraphIndex.load(index_path)
    sf = ShardedFusedSearcher(mesh, index, base, max_degree=32,
                              seed_sample=2, bits=4)
    rows = []
    for L in (48, 64, 96, 128):
        r = med3(lambda warmup: sf.benchmark(
            eval_q, k=K, L=L, expand=4, seeds=min(40, L), warmup=warmup))
        rows.append({"mode": f"sharded_fused_mp{mp}_L{L}",
                     "qps": round(r["qps"], 1),
                     "qps_min": round(r["qps_min"], 1),
                     "qps_max": round(r["qps_max"], 1),
                     "recall": round(compute_recall(r["ids"], gt_i, K), 4)})
        log(rows[-1])
    print(json.dumps({"scale": N_BASE, "rows": rows, "sharded_fused": mp}))


def _ivf_rows(base, eval_q, gt_i, rows, only_ivf=False):
    from mysteryann_tpu.ivf import IVFIndex
    from mysteryann_tpu.utils.metrics import compute_recall

    log("== IVF (4096 clusters) ==")
    t0 = time.time()
    # cap_factor bounds the padded-block HBM (1.2 → ~6.2 GB at 10M)
    ivf = IVFIndex(base, metric="ip", n_clusters=4096, cap_factor=1.2,
                   verbose=True)
    build_s = time.time() - t0
    log(f"ivf build: {build_s:.0f}s")
    for nprobe in (64, 128, 256):
        r = med3(lambda warmup: ivf.benchmark(
            eval_q, k=K, nprobe=nprobe, query_batch=8192, warmup=warmup))
        r["recall"] = compute_recall(r["ids"], gt_i, K)
        rows.append({"mode": f"ivf_np{nprobe}", "qps": round(r["qps"], 1),
                     "qps_min": round(r["qps_min"], 1),
                     "qps_max": round(r["qps_max"], 1),
                     "recall": round(r["recall"], 4),
                     "build_s": round(build_s, 1)})
        log(rows[-1])

    payload = {"scale": N_BASE, "rows": rows}
    if only_ivf:
        # partial run: a results-refresh step must not mistake this for
        # a full sweep and overwrite flat/graph rows (ADVICE r4)
        payload["only_ivf"] = True
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
