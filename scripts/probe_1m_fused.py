"""One-load multi-config fused-engine probe at 1M (v3 world, p3 index).

This probe sweeps the recall levers of the seeded fused engine (denser
seed sample, more seeds, expand=3 with a wider L, pool-mode
bitonic maintenance) sharing one table pack + one index load, so each
config costs only its compile + timed runs.

Run: python scripts/probe_1m_fused.py [--configs a,b,...]
Emits one JSON line per config (stderr progress), then a summary line.
"""

import json
import os
import sys

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
KEY = "t2i1m_v3_1000000_200000_128"

# name -> (seed_sample, dict(benchmark kwargs), L list)
CONFIGS = {
    # denser entry-point sample: the 1-in-2 scan alone holds ~half the
    # true top-10; costs ~2x seed-scan FLOPs (noise vs the walk)
    "ss2_s48": (2, dict(expand=4, seeds=48), [58, 60, 62, 64]),
    "ss2_s64": (2, dict(expand=4, seeds=64), [64]),
    "ss3_s48": (3, dict(expand=4, seeds=48), [60, 64]),
    # expand=3 frees 48 pool lanes inside the 256 tile: L up to 112
    "e3_ss4": (4, dict(expand=3, seeds=48), [90, 100, 112]),
    "e3_ss2": (2, dict(expand=3, seeds=48), [100, 112]),
    # pool-mode bitonic maintenance past the cliff (merge pays two full
    # [B, L+F] lax.sorts per hop there)
    "pool_ss4": (4, dict(expand=4, seeds=48, visited_mode="pool"),
                 [64, 80, 100]),
    # expand=2: F=96, L up to 160 in-tile; hops ~L/2
    "e2_ss2": (2, dict(expand=2, seeds=48), [120, 144, 160]),
    # fast-side fine sweep (pairs with --passes 2: the 2-pass graph's
    # lower degree truncates less under 48-wide rows)
    "s48_fine": (4, dict(expand=4, seeds=48), [60, 62, 64, 66]),
    # 1-in-2 sample crosses .95 far below L=58 — find the knee
    "ss2_low": (2, dict(expand=4, seeds=40), [40, 44, 48, 52, 56]),
    "ss2_s24_low": (2, dict(expand=4, seeds=24), [32, 36, 40]),
    # 1-in-3 sample: 2/3 the scan FLOPs of ss2 at (maybe) similar recall
    "ss3_low": (3, dict(expand=4, seeds=40), [44, 48, 52, 56, 60]),
    # int4 traversal rows (bits=4 table): half the per-expansion gather
    # bytes for coarser traversal
    # distances; rerank=4k keeps the reported head exact
    "b4_ss2": (2, dict(expand=4, seeds=48, _bits=4), [48, 56, 64]),
    "b4_ss4": (4, dict(expand=4, seeds=48, _bits=4), [64, 80, 100]),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--max_degree", type=int, default=48)
    ap.add_argument("--passes", type=int, default=3,
                    help="which cached index to serve (p2 keeps lower "
                         "degree — less edge loss under row truncation)")
    args = ap.parse_args()

    from mysteryann_tpu.graph import RoarGraphIndex
    from mysteryann_tpu.search.fused import FusedSearcher
    from mysteryann_tpu.search.seeding import make_seed_sample
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    def loadz(name):
        with np.load(os.path.join(CACHE, name + ".npz")) as z:
            return [z[k] for k in z.files]

    base, _ = loadz(KEY + "_data")
    (eval_q,) = loadz(KEY + "_evalw32768")
    gt_i, gt_d = loadz(KEY + "_gtw32768")
    gt_i = gt_i.astype(np.int64)

    index = RoarGraphIndex.load(os.path.join(
        CACHE, f"{KEY}_{M_SQ}_{M_PJBP}_{L_PJPQ}_p{args.passes}_proj.index"))
    log(f"degree: {index.graph.degree_stats()}")
    searchers = {8: FusedSearcher(index, base, max_degree=args.max_degree,
                                  seed_sample=4)}
    samples = {(8, 4): searchers[8]._samp}

    results = {}
    for name in args.configs.split(","):
        ss, kw, Ls = CONFIGS[name]
        kw = dict(kw)
        bits = kw.pop("_bits", 8)
        if bits not in searchers:
            searchers[bits] = FusedSearcher(
                index, base, max_degree=args.max_degree, seed_sample=ss,
                bits=bits)
            samples[(bits, ss)] = searchers[bits]._samp
        fused = searchers[bits]
        if (bits, ss) not in samples:
            samples[(bits, ss)] = make_seed_sample(fused.base, ss)
        fused._samp = samples[(bits, ss)]
        rows = []
        for L in Ls:
            for _ in range(2):
                r = fused.benchmark(eval_q, k=K, L=L, query_batch=8192, **kw)
            rows.append({
                "L": L, "qps": round(r["qps"], 1),
                "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                "rderr": round(compute_rderr(r["dists"], gt_d, K, "ip"), 6),
                "avg_hops": round(r["avg_hops"], 1)})
            log(name, rows[-1])
        results[name] = {"seed_sample": ss, "bits": bits,
                         **{k: str(v) for k, v in kw.items()}, "rows": rows}
        print(json.dumps({name: results[name]}), flush=True)

    best = None
    for name, res in results.items():
        for row in res["rows"]:
            if row["recall"] >= 0.95 and (best is None
                                          or row["qps"] > best[1]["qps"]):
                best = (name, row)
    print(json.dumps({"best_at_95": best}), flush=True)


if __name__ == "__main__":
    main()
