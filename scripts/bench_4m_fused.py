"""4M-class single-device fused-graph serving run.

The fused byte-row engine is the sublinear serving mode at 1M; at 10M
its table grows to 28.6 GB (bits=4, M=32) and serving can shard over
``mp`` (parallel/sharded_fused.py). This script serves the single-device
engine at 4M nodes: 12.3 GB table (bits=4, max_degree=32) + 2 GB f32
rerank base + seed sample ≈ 14.6 GB.

Pipeline: v3-difficulty world at 4M (seed 23) → exact GT → train kNN →
RoarGraph build (classic phase D — the supply-width fused table does not
fit at 4M either) → seeded fused L-sweep, median-of-3 rows vs exact GT.

Run: python scripts/bench_4m_fused.py [--skip_build] [--max_degree 32]
Emits one JSON line; artifacts cache under .bench_cache.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")

from mysteryann_tpu.utils.cache import enable_compile_cache, npz_cached
enable_compile_cache()

DIM = 128
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128
N_EVAL = 32_768
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_base", type=int, default=4_000_000)
    ap.add_argument("--n_train", type=int, default=400_000)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--max_degree", type=int, default=32)
    ap.add_argument("--seed_sample", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--Ls", default="48,56,64,80,112")
    ap.add_argument("--skip_serve", action="store_true")
    args = ap.parse_args()

    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import exact_knn
    from mysteryann_tpu.graph import build_roargraph, RoarGraphIndex
    from mysteryann_tpu.search.fused import FusedSearcher
    from mysteryann_tpu.utils.params import BuildConfig
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    n, ntr = args.n_base, args.n_train
    key = f"t2i4m_v3_{n}_{DIM}"
    gkey = f"{key}_graph{ntr}"

    log("== data ==")
    t0 = time.time()
    base, queries = npz_cached(CACHE, f"{key}_all", lambda: list(
        make_cross_modal(n, ntr + N_EVAL, DIM, metric="ip", seed=23,
                         **WORLD)))
    train_q, eval_q = queries[:ntr], queries[ntr:]
    log(f"data in {time.time()-t0:.0f}s")

    log("== exact GT ==")
    gt_i, gt_d = npz_cached(CACHE, f"{gkey}_gt", lambda: list(exact_knn(
        eval_q, base, k=K, metric="ip", query_batch=4096,
        base_tile=131072, precision="highest"))[::-1])
    gt_i = gt_i.astype(np.int64)

    log("== train kNN ==")
    (knn,) = npz_cached(CACHE, f"{gkey}_knn", lambda: [exact_knn(
        train_q, base, k=M_SQ, metric="ip", query_batch=8192,
        base_tile=131072)[1].astype(np.int32)])

    index_path = os.path.join(CACHE, f"{gkey}_p{args.passes}_proj.index")
    build_secs = None
    if os.path.exists(index_path):
        index = RoarGraphIndex.load(index_path)
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
    else:
        log("== build ==")
        cfg = BuildConfig(M_sq=M_SQ, M_pjbp=M_PJBP, L_pjpq=L_PJPQ,
                          metric="ip", query_batch=8192, search_batch=8192,
                          connectivity_passes=args.passes,
                          connectivity_expand=4)
        from mysteryann_tpu.ops.distances import prepare_vectors
        base_staged = jax.block_until_ready(prepare_vectors(base, "ip"))
        t0 = time.time()
        index = build_roargraph(
            base_staged, train_q, knn, cfg, verbose=True,
            checkpoint_dir=os.path.join(CACHE, f"{gkey}_ck"))
        build_secs = time.time() - t0
        del base_staged
        log(f"build took {build_secs:.1f}s")
        index.save(index_path)
        with open(index_path + ".build.json", "w") as f:
            json.dump({"build_secs": round(build_secs, 1)}, f)

    rows = []
    if not args.skip_serve:
        log(f"== fused serve (bits=4, max_degree={args.max_degree}, "
            f"1-in-{args.seed_sample} sample, seeds={args.seeds}) ==")
        fused = FusedSearcher(index, base, max_degree=args.max_degree,
                              seed_sample=args.seed_sample, bits=4)
        for L in (int(x) for x in args.Ls.split(",")):
            # ramp-discard protocol (BASELINE.md variance root cause):
            # 2 warm-up trials discarded, median over the next 3
            for t in range(2):
                fused.benchmark(eval_q, k=K, L=L, query_batch=8192,
                                expand=4, seeds=min(args.seeds, L),
                                warmup=1 if t == 0 else 0)
            trials = [fused.benchmark(eval_q, k=K, L=L, query_batch=8192,
                                      expand=4, seeds=min(args.seeds, L),
                                      warmup=0)
                      for t in range(3)]
            qpss = sorted(t["qps"] for t in trials)
            r = trials[-1]
            row = {"L_pq": L, "qps": round(qpss[1], 1),
                   "qps_min": round(qpss[0], 1), "qps_max": round(qpss[2], 1),
                   "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                   "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"),
                                  5),
                   "avg_hops": round(r["avg_hops"], 1)}
            log(json.dumps(row))
            rows.append(row)

    print(json.dumps({"scale": n, "passes": args.passes,
                      "build_secs": build_secs,
                      "max_degree": args.max_degree, "bits": 4,
                      "rows": rows}))


if __name__ == "__main__":
    main()
