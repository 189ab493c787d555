"""Calibrate the synthetic world's difficulty against the reference binary.

The v1/v2 synthetic worlds were too easy: the reference graph crossed
recall@10 = .95 at L_pq=15, where on its real T2I benchmark the crossing
sits near L~100-200 (run_roargraph_search_test.sh sweeps L to 2000). A
.95 target every mode saturates at L=15 discriminates nothing — so the
world generator's difficulty knobs (concept count, intrinsic dimension,
concept noise) are CALIBRATED against the reference's own binary: pick
the config whose recall@10-vs-L_pq frontier, measured by the unmodified
reference (compiled via baseline/), crosses .95 in the target L band.

v3 (the recorded calibration, BASELINE.md): ``--n_concepts 20000
--intrinsic_dim 48 --noise 0.85`` at 1M puts the reference's crossing at
**L_pq = 125** (frontier .712/.874/.936/.950/.961/.973/.981/.991 at
L=15/50/100/125/150/200/250/400). Re-running this script with the
defaults reproduces that row (one ~768 s single-core reference build,
then the L sweep; pass --Ls to refine around the crossing).

Pipeline per config: generate world (io/synthetic.make_cross_modal, the
same generator bench.py uses) -> exact train kNN + in-world eval GT on
the device (ops/knn) -> export fbin/ibin -> reference build + search sweep
(baseline/bench_reference) -> report the .95 crossing. Artifacts land in
--workdir keyed by the config, so re-runs reuse the build. When the
config matches bench.py's v3 constants, cached .bench_cache npz
artifacts are reused instead of regenerating.
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


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def world_key(args) -> str:
    return (f"cal_n{args.n_base}_t{args.n_train}_d{args.dim}"
            f"_c{args.n_concepts}_h{args.intrinsic_dim}"
            f"_z{args.noise:g}_s{args.seed}")


def is_bench_v3(args) -> bool:
    return (args.n_base == 1_000_000 and args.n_train == 200_000
            and args.dim == 128 and args.n_concepts == 20_000
            and args.intrinsic_dim == 48 and abs(args.noise - 0.85) < 1e-9
            and args.seed == 7 and args.n_eval == 32768)


def load_or_make(args):
    """(base, train, eval_q, train_knn, gt_i) — from bench cache or fresh."""
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import exact_knn
    from mysteryann_tpu.utils.cache import npz_cached

    world = dict(n_concepts=args.n_concepts, intrinsic_dim=args.intrinsic_dim,
                 noise=args.noise)
    if is_bench_v3(args):
        key = f"t2i1m_v3_{args.n_base}_{args.n_train}_{args.dim}"
        log(f"config == bench.py v3; reusing .bench_cache/{key}_* artifacts")
    else:
        key = world_key(args)
    base, train = npz_cached(CACHE, key + "_data", lambda: make_cross_modal(
        args.n_base, args.n_train, args.dim, metric="ip", seed=args.seed,
        **world))
    (eval_q,) = npz_cached(
        CACHE, f"{key}_evalw{args.n_eval}",
        lambda: [make_cross_modal(1, args.n_eval, args.dim, metric="ip",
                                  seed=args.seed, query_seed=args.seed + 1,
                                  **world)[1]])
    gt_i, _ = npz_cached(CACHE, f"{key}_gtw{args.n_eval}", lambda: list(
        reversed(exact_knn(eval_q, base, k=10, metric="ip", query_batch=8192,
                           base_tile=131072, precision="highest"))))
    (knn,) = npz_cached(CACHE, key + "_knn", lambda: [exact_knn(
        train, base, k=args.M_sq, metric="ip", query_batch=8192,
        base_tile=131072)[1]])
    return key, base, train, eval_q, knn, gt_i.astype(np.int32)


def main():
    ap = argparse.ArgumentParser()
    # world knobs (defaults = the recorded v3 calibration)
    ap.add_argument("--n_concepts", type=int, default=20_000)
    ap.add_argument("--intrinsic_dim", type=int, default=48)
    ap.add_argument("--noise", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=7)
    # scale knobs (1M = the recorded calibration scale; smaller scales
    # shift the crossing left — calibrate at the scale you will bench)
    ap.add_argument("--n_base", type=int, default=1_000_000)
    ap.add_argument("--n_train", type=int, default=200_000)
    ap.add_argument("--n_eval", type=int, default=32768)
    ap.add_argument("--dim", type=int, default=128)
    # reference build/search params (bench.py's)
    ap.add_argument("--M_sq", type=int, default=64)
    ap.add_argument("--M_pjbp", type=int, default=32)
    ap.add_argument("--L_pjpq", type=int, default=128)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--Ls", default="15,50,100,125,150,200,250,400")
    ap.add_argument("--target", type=float, default=0.95)
    ap.add_argument("--workdir", default="/tmp/calibrate_world")
    args = ap.parse_args()

    from mysteryann_tpu.io import write_fbin
    from mysteryann_tpu.io.formats import write_knn_ibin

    exe = os.path.join(REPO, "baseline", "bench_reference")
    if not os.path.exists(exe):
        log("building baseline/bench_reference ...")
        subprocess.run(["make", "-C", os.path.join(REPO, "baseline")],
                       check=True)

    key, base, train, eval_q, knn, gt_i = load_or_make(args)
    wd = os.path.join(args.workdir, key)
    os.makedirs(wd, exist_ok=True)

    def export(path, fn):
        if not os.path.exists(path):
            fn()
            log(f"exported {path}")

    paths = {n: os.path.join(wd, n) for n in
             ("base.fbin", "train.fbin", "knn.ibin", "eval.fbin", "gt.ibin")}
    export(paths["base.fbin"], lambda: write_fbin(paths["base.fbin"], base))
    export(paths["train.fbin"], lambda: write_fbin(paths["train.fbin"], train))
    export(paths["knn.ibin"], lambda: write_knn_ibin(
        paths["knn.ibin"], knn.astype(np.int32)))
    export(paths["eval.fbin"], lambda: write_fbin(paths["eval.fbin"], eval_q))
    export(paths["gt.ibin"], lambda: write_knn_ibin(paths["gt.ibin"], gt_i))

    index_p = os.path.join(
        wd, f"ref_{args.M_sq}_{args.M_pjbp}_{args.L_pjpq}.index")
    if not os.path.exists(index_p):
        log(f"== reference build (M_sq={args.M_sq} M_pjbp={args.M_pjbp} "
            f"L_pjpq={args.L_pjpq}, {args.threads} thread(s)) ==")
        subprocess.run(
            [exe, "build", paths["base.fbin"], paths["train.fbin"],
             paths["knn.ibin"], index_p, str(args.M_sq), str(args.M_pjbp),
             str(args.L_pjpq), str(args.threads)], check=True)

    log(f"== reference search sweep ({args.threads} thread(s)) ==")
    out = subprocess.run(
        [exe, "search", paths["base.fbin"], index_p, paths["eval.fbin"],
         paths["gt.ibin"], "10", str(args.threads), args.Ls],
        check=True, capture_output=True, text=True).stdout
    sys.stderr.write(out)

    rows = []
    for line in out.splitlines():
        parts = line.strip().split(",")
        if len(parts) == 3 and parts[0].isdigit():
            rows.append({"L_pq": int(parts[0]), "qps": float(parts[1]),
                         "recall": float(parts[2])})
    crossing = next((r for r in rows if r["recall"] >= args.target), None)
    print(json.dumps({
        "world": {"n_concepts": args.n_concepts,
                  "intrinsic_dim": args.intrinsic_dim, "noise": args.noise,
                  "seed": args.seed},
        "scale": {"n_base": args.n_base, "n_train": args.n_train,
                  "dim": args.dim, "n_eval": args.n_eval},
        "rows": rows,
        "crossing_L": crossing["L_pq"] if crossing else None,
        "crossing_qps": crossing["qps"] if crossing else None,
        "target": args.target,
    }, indent=1))


if __name__ == "__main__":
    main()
