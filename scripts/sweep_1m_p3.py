"""3-pass RoarGraph at 1M: build + seeded-fused recall/QPS frontier.

Round-1 measurements showed each extra phase-D pass keeps lifting the
recall frontier (1-pass .794, 2-pass .865, 3-pass .889 at L=100; see
BASELINE.md). A better graph needs a smaller L for the same recall, and
the fused engine's cost is ~L-proportional — so the 3-pass index may
move the graph-engine QPS-at-.95 point past the 2-pass index's.
This script builds the 3-pass index (cached) and sweeps the seeded
fused searcher to find that point.

Run: `python scripts/sweep_1m_p3.py`. Emits one JSON line.
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
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--seed_sample", type=int, default=4)
    ap.add_argument("--expand", type=int, default=4)
    ap.add_argument("--max_degree", type=int, default=48)
    ap.add_argument("--exit_f", type=float, default=None,
                    help="early-termination factor (see fused.py); cuts "
                         "tail hops for easy queries at a small recall cost")
    ap.add_argument("--visited_mode", default="auto",
                    choices=("auto", "merge", "pool", "bitmask"),
                    help="fused pool-maintenance strategy (see fused.py)")
    ap.add_argument("--query_batch", type=int, default=8192)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="traversal-row quantization (4 halves DMA bytes)")
    ap.add_argument("--rerank", type=int, default=0,
                    help="exact-rerank head depth override (recall lever "
                         "at fixed L; 0 = engine default)")
    ap.add_argument("--L", type=int, nargs="+",
                    default=[40, 50, 60, 75, 90, 110, 130, 160, 200])
    args = ap.parse_args()

    from mysteryann_tpu.graph import build_roargraph, RoarGraphIndex
    from mysteryann_tpu.search.fused import FusedSearcher
    from mysteryann_tpu.utils.params import BuildConfig
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    key = "t2i1m_v3_1000000_200000_128"

    def loadz(name):
        with np.load(os.path.join(CACHE, name + ".npz")) as z:
            return [z[k] for k in z.files]

    base, train_q = loadz(key + "_data")
    # in-world eval + GT (bench.py writes these under the w keys)
    (eval_q,) = loadz(key + "_evalw32768")
    gt_i, gt_d = loadz(key + "_gtw32768")
    gt_i = gt_i.astype(np.int64)
    (knn,) = loadz(key + "_knn")

    p = args.passes
    index_path = os.path.join(
        CACHE, f"{key}_{M_SQ}_{M_PJBP}_{L_PJPQ}_p{p}_proj.index")
    build_secs = None
    if os.path.exists(index_path):
        index = RoarGraphIndex.load(index_path)
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
    else:
        log(f"== build ({p}-pass) ==")
        cfg = BuildConfig(M_sq=M_SQ, M_pjbp=M_PJBP, L_pjpq=L_PJPQ,
                          metric="ip", query_batch=8192, search_batch=8192,
                          connectivity_passes=p)
        t0 = time.time()
        index = build_roargraph(
            base, train_q, np.asarray(knn, np.int32), cfg, verbose=True,
            checkpoint_dir=os.path.join(
                CACHE, f"{key}_{M_SQ}_{M_PJBP}_{L_PJPQ}_p{p}_ck"))
        build_secs = time.time() - t0
        log(f"build took {build_secs:.1f}s")
        index.save(index_path)
        with open(index_path + ".build.json", "w") as f:
            json.dump({"build_secs": round(build_secs, 1)}, f)
    log(f"degree: {index.graph.degree_stats()}")

    fused = FusedSearcher(index, base, max_degree=args.max_degree,
                          seed_sample=args.seed_sample, bits=args.bits)
    rows = []
    for L in args.L:
        for _ in range(2):
            r = fused.benchmark(eval_q, k=K, L=L,
                                query_batch=args.query_batch,
                                expand=args.expand, seeds=args.seeds,
                                visited_mode=args.visited_mode,
                                exit_f=args.exit_f, rerank=args.rerank)
        rows.append({
            "L": L, "qps": round(r["qps"], 1),
            "recall": round(compute_recall(r["ids"], gt_i, K), 4),
            "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"), 6),
            "avg_hops": round(r["avg_hops"], 1),
        })
        log(rows[-1])
    best = max((x for x in rows if x["recall"] >= 0.95),
               key=lambda x: x["qps"], default=None)
    print(json.dumps({"passes": p, "build_secs": build_secs,
                      "seeds": args.seeds, "seed_sample": args.seed_sample,
                      "expand": args.expand, "max_degree": args.max_degree,
                      "visited_mode": args.visited_mode,
                      "query_batch": args.query_batch, "bits": args.bits,
                      "rows": rows, "best_at_95": best}))


if __name__ == "__main__":
    main()
