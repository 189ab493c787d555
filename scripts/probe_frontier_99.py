"""High-recall frontier probe: extend the seeded fused-graph sweep to
recall@10 >= .99 on the v3 1M world.

Loads the cached 2-pass p2e4b4 index and walks configs upward in L until
the frontier crosses .99, median-of-3 per row. Reference sweep protocol:
/root/reference/run_roargraph_search_test.sh:1-15 (57 L values to 2000).

Run on an idle chip AFTER scripts/probe_build_1m.py has built the index:
  python scripts/probe_frontier_99.py
Emits one JSON line with every row measured.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, ".cache", "jax"))
from mysteryann_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

KEY = "t2i1m_v3_1000000_200000_128"
INDEX = f"{KEY}_64_32_128_p2e4b4_proj.index"
N_EVAL, K = 32768, 10

# (label, max_degree, expand, seeds, seed_sample, rerank, Ls) — expand
# shrinks as L grows to stay near the pool-tile budget; rerank deepens
# the exact-rerank head where traversal-order loss caps recall
CONFIGS = [
    ("e4_hi", 48, 4, 40, 2, 0, (112, 128)),
    ("e3_hi", 48, 3, 48, 2, 0, (144, 176)),
    ("e2_hi", 48, 2, 48, 2, 0, (224, 320)),
    ("e2_rr", 48, 2, 48, 2, 96, (320, 448)),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def loadz(name):
    with np.load(os.path.join(CACHE, name + ".npz")) as z:
        return [z[k] for k in z.files]


def main():
    from mysteryann_tpu.graph import RoarGraphIndex
    from mysteryann_tpu.search.fused import FusedSearcher
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    base, _ = loadz(KEY + "_data")
    (eval_q,) = loadz(f"{KEY}_evalw{N_EVAL}")
    gt_i, gt_d = loadz(f"{KEY}_gtw{N_EVAL}")
    gt_i = gt_i.astype(np.int64)
    index = RoarGraphIndex.load(os.path.join(CACHE, INDEX))

    rows, done = [], False
    last_key = None
    fused = None
    for label, md, expand, seeds, ss, rerank, Ls in CONFIGS:
        if done:
            break
        if (md, ss) != last_key:
            del fused
            fused = FusedSearcher(index, base, max_degree=md, seed_sample=ss)
            last_key = (md, ss)
        for L in Ls:
            trials = [fused.benchmark(eval_q, k=K, L=L, query_batch=8192,
                                      expand=expand, seeds=min(seeds, L),
                                      rerank=rerank,
                                      warmup=1 if t == 0 else 0)
                      for t in range(3)]
            qpss = sorted(t["qps"] for t in trials)
            r = trials[-1]
            row = {"config": label, "L_pq": L, "expand": expand,
                   "seeds": seeds, "rerank": rerank,
                   "qps": round(qpss[1], 1), "qps_min": round(qpss[0], 1),
                   "qps_max": round(qpss[2], 1),
                   "recall": round(compute_recall(r["ids"], gt_i, K), 4),
                   "rderr": round(
                       compute_rderr(r["dists"], gt_d, K, "ip"), 6),
                   "avg_hops": round(r["avg_hops"], 1)}
            log(json.dumps(row))
            rows.append(row)
            if row["recall"] >= 0.992:
                done = True
                break
    print(json.dumps({"rows": rows}, indent=1))


if __name__ == "__main__":
    main()
