"""Build + serve a RoarGraph at the reference's headline 10M scale.

The reference's flagship regime is T2I-10M graph build + search
(reference run_roargraph_test.sh:5-10, run_roargraph_search_test.sh).
This script produces the equivalent rows on the synthetic 10M corpus:

1. data: generate (or reuse cached) the 10M v3-difficulty base (seed
   17) together with a 1M-query train set and 32k eval set drawn from
   the SAME synthetic manifold — the reference's premise (train
   queries predict the eval query distribution; prepare_data.sh
   samples both from the real query pool). The RNG consumes base
   draws before query draws, so re-generation is bit-stable against
   the cached artifact (asserted on first 1000 rows).
2. exact train kNN (the input the reference outsources to DiskANN).
3. build: M_sq=64, M_pjbp=32, L_pjpq=128 (the 1M bench family, scaled);
   phase D auto-selects the classic engine (the fused byte-row table
   would need ~92 GB at 10M). Phase-level checkpoints under
   .bench_cache/ make the multi-hour build resumable.
4. serve: classic engine + coarse-scan seeding (the fused table does
   not fit at 10M), L-sweep rows with recall/rderr vs exact GT; flat
   rows come from scripts/bench_10m.py.

Run: `python scripts/build_10m.py [--passes N]`. Emits one JSON line.
"""

import argparse
import json
import os
import sys
import time

import jax
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
DIM = 128
K = 10
M_SQ, M_PJBP, L_PJPQ = 64, 32, 128
N_EVAL = 32_768
# v3 = the difficulty-calibrated world (same geometry as bench.py's 1M
# slice; see BASELINE.md "Workload history") — the 10M regime should
# exercise the reference's real difficulty band too
KEY_VERSION = "v3"
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cached(name, fn):
    from mysteryann_tpu.utils.cache import npz_cached
    return npz_cached(CACHE, name, fn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_base", type=int, default=10_000_000)
    ap.add_argument("--n_train", type=int, default=1_000_000)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "fused", "classic"))
    ap.add_argument("--search_batch", type=int, default=8192)
    ap.add_argument("--skip_serve", action="store_true")
    args = ap.parse_args()

    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import exact_knn
    from mysteryann_tpu.graph import build_roargraph, RoarGraphIndex
    from mysteryann_tpu.search import Searcher
    from mysteryann_tpu.utils.params import BuildConfig
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    n, ntr = args.n_base, args.n_train
    key = f"t2i10m_{KEY_VERSION}_{n}_{DIM}"
    gkey = f"{key}_graph{ntr}"

    log("== data (regenerate base manifold + same-distribution queries) ==")
    t0 = time.time()
    q_path = os.path.join(CACHE, f"{gkey}_queries.npz")
    base_path = os.path.join(CACHE, f"{key}_base.npz")
    if os.path.exists(q_path) and os.path.exists(base_path):
        with np.load(base_path) as z:
            base = z[z.files[0]]
        with np.load(q_path) as z:
            train_q, eval_q = z["train"], z["eval"]
    else:
        base, queries = make_cross_modal(n, ntr + N_EVAL, DIM, metric="ip",
                                         seed=17, **WORLD)
        if os.path.exists(base_path):
            with np.load(base_path) as z:
                ref = z[z.files[0]]
            assert np.array_equal(base[:1000], ref[:1000]), \
                "regenerated base diverges from cached artifact"
            base = ref
        else:
            np.savez(base_path, base)
        train_q, eval_q = queries[:ntr], queries[ntr:]
        np.savez(q_path, train=train_q, eval=eval_q)
        del queries
    log(f"data ready in {time.time()-t0:.0f}s "
        f"(base {base.shape}, train {train_q.shape}, eval {eval_q.shape})")

    log("== exact eval GT ==")
    gt_i, gt_d = cached(f"{gkey}_gt", lambda: list(exact_knn(
        eval_q, base, k=K, metric="ip", query_batch=2048,
        base_tile=131072, precision="highest"))[::-1])
    gt_i = gt_i.astype(np.int64)

    log("== train kNN (build input) ==")
    t0 = time.time()
    (knn,) = cached(f"{gkey}_knn", lambda: [exact_knn(
        train_q, base, k=M_SQ, metric="ip", query_batch=8192,
        base_tile=131072)[1].astype(np.int32)])
    log(f"train kNN in {time.time()-t0:.0f}s")

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
        # expand=4: four pops per lockstep phase-D step (the 1M recipe's
        # knob, now honored by the classic engine too) — the v3 world's
        # ~130-hop searches made expand=1 a ~4 h/pass build at 10M
        cfg = BuildConfig(M_sq=M_SQ, M_pjbp=M_PJBP, L_pjpq=L_PJPQ,
                          metric="ip", query_batch=8192,
                          search_batch=args.search_batch,
                          connectivity_passes=args.passes,
                          connectivity_expand=4,
                          connectivity_engine=args.engine)
        # stage the 5.1 GB base in device memory BEFORE the clock
        # (reference timer parity: data in working memory at t0)
        from mysteryann_tpu.ops.distances import prepare_vectors
        base_staged = jax.block_until_ready(prepare_vectors(base, "ip"))
        t0 = time.time()
        # shared checkpoint dir: connectivity_passes is fingerprint-neutral,
        # so a later --passes 2 run resumes from the 1-pass phaseD
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
        log("== serve sweep (classic engine, seeded) ==")
        s = Searcher(index, base, seed_sample=8)
        for L in (100, 150, 250):
            r = s.benchmark(eval_q, k=K, L=L, query_batch=8192,
                            visited_mode="merge", expand=4, seeds=32)
            rows.append({
                "mode": f"graph_seeded_L{L}", "qps": round(r["qps"], 1),
                "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"), 6),
                "avg_hops": round(r["avg_hops"], 1),
            })
            log(rows[-1])

    print(json.dumps({"scale": n, "n_train": ntr, "passes": args.passes,
                      "build_secs": build_secs, "rows": rows}))


if __name__ == "__main__":
    main()
