"""Probe phase-D build-speed knobs at 1M (goal: beat the
reference's 768 s single-core v3 build at an equal-or-better frontier).

Builds the bench workload's 2-pass index with configurable
``connectivity_expand`` / ``connectivity_bits`` (utils/params.py), times
the build, then measures the record serving config (seeded fused graph,
1-in-2 sample, seeds=40, 48-wide rows, expand=4) over an L sweep with
median-of-3 timing — so a faster build is only accepted with the recall
frontier intact.

Usage: python scripts/probe_build_1m.py [--expand 4] [--bits 4]
           [--passes 2] [--Ls 40,44,48,52,56]
Artifacts cache under .bench_cache keyed by the knob values; a cached
index skips the build (delete the _proj.index file to force a rebuild).
"""

import argparse
import json
import os
import statistics
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")
KEY = "t2i1m_v3_1000000_200000_128"
N_EVAL = 32768
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, ".cache", "jax"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "5")
# env var alone is ignored by this JAX build — the config route
# must initialize the cache (utils/cache.py)
from mysteryann_tpu.utils.cache import enable_compile_cache
enable_compile_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def loadz(name):
    with np.load(os.path.join(CACHE, name + ".npz")) as z:
        return [z[k] for k in z.files]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--expand", type=int, default=4)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--Ls", default="40,44,48,52,56")
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--seed_sample", type=int, default=2)
    ap.add_argument("--max_degree", type=int, default=48)
    ap.add_argument("--skip_serve", action="store_true")
    ap.add_argument("--build_seeds", type=int, default=0,
                    help="phase-D entry seeding (0 = medoid walk)")
    ap.add_argument("--build_seed_sample", type=int, default=4)
    args = ap.parse_args()

    from mysteryann_tpu.graph import build_roargraph, RoarGraphIndex
    from mysteryann_tpu.search.fused import FusedSearcher
    from mysteryann_tpu.utils.params import BuildConfig
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    base, train_q = loadz(KEY + "_data")
    (eval_q,) = loadz(f"{KEY}_evalw{N_EVAL}")
    gt_i, gt_d = loadz(f"{KEY}_gtw{N_EVAL}")
    gt_i = gt_i.astype(np.int64)
    (knn,) = loadz(KEY + "_knn")

    tag = f"p{args.passes}e{args.expand}b{args.bits}"
    if args.build_seeds:
        tag += f"s{args.build_seeds}r{args.build_seed_sample}"
    index_path = os.path.join(
        CACHE, f"{KEY}_{M_SQ}_{M_PJBP}_{L_PJPQ}_{tag}_proj.index")
    build_secs = None
    if os.path.exists(index_path):
        index = RoarGraphIndex.load(index_path)
        try:
            with open(index_path + ".build.json") as f:
                build_secs = json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            pass
        log(f"loaded cached index {index_path} (build {build_secs}s)")
    else:
        cfg = BuildConfig(M_sq=M_SQ, M_pjbp=M_PJBP, L_pjpq=L_PJPQ,
                          metric="ip", query_batch=8192, search_batch=8192,
                          connectivity_passes=args.passes,
                          connectivity_expand=args.expand,
                          connectivity_bits=args.bits,
                          connectivity_seeds=args.build_seeds,
                          connectivity_seed_sample=args.build_seed_sample)
        # reference timer parity: data staged in device memory before
        # the clock, like bench_reference.cpp loads into RAM before
        # BuildRoarGraph
        from mysteryann_tpu.ops.distances import prepare_vectors
        base_staged = jax.block_until_ready(prepare_vectors(base, "ip"))
        t0 = time.time()
        index = build_roargraph(
            base_staged, train_q, knn, cfg, verbose=True,
            checkpoint_dir=os.path.join(CACHE, f"{KEY}_{tag}_ck"))
        build_secs = time.time() - t0
        log(f"build[{tag}] took {build_secs:.1f}s")
        index.save(index_path)
        with open(index_path + ".build.json", "w") as f:
            json.dump({"build_secs": round(build_secs, 1),
                       "expand": args.expand, "bits": args.bits,
                       "passes": args.passes,
                       "build_seeds": args.build_seeds,
                       "build_seed_sample": args.build_seed_sample}, f)

    result = {"tag": tag, "build_secs": (None if build_secs is None
                                         else round(build_secs, 1)),
              "rows": []}
    if not args.skip_serve:
        fused = FusedSearcher(index, base, max_degree=args.max_degree,
                              seed_sample=args.seed_sample)
        for L in (int(x) for x in args.Ls.split(",")):
            trials = [fused.benchmark(eval_q, k=K, L=L, query_batch=8192,
                                      expand=4, seeds=min(args.seeds, L),
                                      warmup=1 if t == 0 else 0)
                      for t in range(3)]
            qpss = sorted(t["qps"] for t in trials)
            r = trials[-1]
            row = {"L_pq": L, "qps": round(qpss[1], 1),
                   "qps_min": round(qpss[0], 1), "qps_max": round(qpss[2], 1),
                   "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                   "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"), 5),
                   "avg_hops": round(r["avg_hops"], 1)}
            log(json.dumps(row))
            result["rows"].append(row)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
