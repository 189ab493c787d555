"""Measure the CPU reference (baseline/bench_reference) at 4M.

The 4M fused-graph row (BASELINE.md "4M scale") was compared against
nothing: the reference bar had only ever been measured at 1M. This
script produces the missing 4M reference column on IDENTICAL data to
scripts/bench_4m_fused.py (same cached v3 world, seed 23): exports the
cached artifacts to fbin/ibin, computes the train kNN + eval GT on
device if the cache lacks them (the reference outsources this step to
DiskANN; we feed it ours, same as the 1M protocol), builds the
reference index single-core, and runs its OMP search sweep. The QPS at
recall ≥ .95 × 16-thread extrapolation gives the 4M `vs_baseline`
ratio, same convention as the 1M bar.

Run: `python scripts/run_baseline_4m.py [--workdir DIR] [--threads N]`.
The build+sweep are CPU-only and can run while the chip is busy; only
the (cached) kNN/GT steps touch the device.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")
KEY = "t2i4m_v3_4000000_128"
GKEY = KEY + "_graph400000"
N_TRAIN = 400_000
N_EVAL = 32768
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from mysteryann_tpu.io import write_fbin
    from mysteryann_tpu.io.formats import write_knn_ibin
    from mysteryann_tpu.utils.cache import npz_cached

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/baseline_4m")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--Ls", default="50,100,150,200,250,400,700")
    ap.add_argument("--prep-only", action="store_true",
                    help="compute/caches kNN+GT and export fbin, skip the "
                         "reference build/search (device part only)")
    args = ap.parse_args()
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)

    exe = os.path.join(REPO, "baseline", "bench_reference")
    if not os.path.exists(exe):
        log("building baseline/bench_reference ...")
        subprocess.run(["make", "-C", os.path.join(REPO, "baseline")],
                       check=True)

    with np.load(os.path.join(CACHE, KEY + "_all.npz")) as z:
        base, queries = z[z.files[0]], z[z.files[1]]
    train_q, eval_q = queries[:N_TRAIN], queries[N_TRAIN:]

    # device steps (cached; same keys as scripts/bench_4m_fused.py)
    from mysteryann_tpu.ops import exact_knn
    gt_i, _ = npz_cached(CACHE, f"{GKEY}_gt", lambda: list(exact_knn(
        eval_q, base, k=K, metric="ip", query_batch=4096,
        base_tile=131072, precision="highest"))[::-1])
    (knn,) = npz_cached(CACHE, f"{GKEY}_knn", lambda: [exact_knn(
        train_q, base, k=M_SQ, metric="ip", query_batch=8192,
        base_tile=131072)[1].astype(np.int32)])

    def export(path, fn):
        if not os.path.exists(path):
            fn()
            log(f"exported {path}")

    base_p = os.path.join(wd, "base.fbin")
    train_p = os.path.join(wd, "train.fbin")
    knn_p = os.path.join(wd, "train_knn.ibin")
    eval_p = os.path.join(wd, "evalw.fbin")
    gt_p = os.path.join(wd, "evalw_gt.ibin")

    export(base_p, lambda: write_fbin(base_p, base))
    export(train_p, lambda: write_fbin(train_p, train_q))
    export(knn_p, lambda: write_knn_ibin(knn_p, np.asarray(knn, np.int32)))
    export(eval_p, lambda: write_fbin(eval_p, eval_q))
    export(gt_p, lambda: write_knn_ibin(
        gt_p, np.asarray(gt_i, np.int32)))
    if args.prep_only:
        log("prep done (kNN/GT cached, fbin exported)")
        return

    index_p = os.path.join(wd, "ref4m.index")
    if not os.path.exists(index_p):
        log(f"== reference build (M_sq={M_SQ} M_pjbp={M_PJBP} "
            f"L_pjpq={L_PJPQ}, {args.threads} threads) ==")
        subprocess.run([exe, "build", base_p, train_p, knn_p, index_p,
                        str(M_SQ), str(M_PJBP), str(L_PJPQ),
                        str(args.threads)], check=True)

    log(f"== reference search sweep ({args.threads} threads) ==")
    subprocess.run([exe, "search", base_p, index_p, eval_p, gt_p,
                    str(K), str(args.threads), args.Ls], check=True)


if __name__ == "__main__":
    main()
