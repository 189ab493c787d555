"""Bipartite-variant benchmark at 1M — the reference's NeurIPS-track pair.

Builds the bipartite index (BuildBipartite/qbaseNNbipartite, reference
src/index_bipartite.cpp:42-141, 235-280) on the 1M bench corpus and
sweeps the two-hop search (SearchBipartiteGraph, :282-356) with the
chunked hop-2 expansion. Rows feed BASELINE.md's bipartite section.

Run: `python scripts/bench_bipartite.py`. Emits one JSON line.
`--smoke` runs the identical path on a tiny in-process synthetic world
(CPU-friendly) to validate the script before an expensive device run.
"""

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
K = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from mysteryann_tpu.graph.bipartite import (BipartiteSearcher,
                                                build_bipartite)
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr
    from mysteryann_tpu.utils.params import BuildConfig

    smoke = "--smoke" in sys.argv[1:]
    if smoke:
        from mysteryann_tpu.io import make_cross_modal
        from mysteryann_tpu.ops import exact_knn
        base, train_q = make_cross_modal(4_000, 2_000, 32, metric="ip",
                                         seed=11)
        eval_q = make_cross_modal(1, 256, 32, metric="ip", seed=11,
                                  query_seed=12)[1]
        gt_d, gt_i = (np.asarray(a) for a in
                      exact_knn(eval_q, base, k=K, metric="ip",
                                precision="highest"))
        knn = np.asarray(exact_knn(train_q, base, k=64, metric="ip",
                                   precision="highest")[1])
        cap, Ls, qbmax = 24, (50, 100), 256
    else:
        cap, Ls, qbmax = 64, (50, 100, 200, 400), 4096
        key = "t2i1m_v3_1000000_200000_128"

        def loadz(name):
            with np.load(os.path.join(CACHE, name + ".npz")) as z:
                return [z[k] for k in z.files]

        base, train_q = loadz(key + "_data")
        # the in-world eval set + exact GT (bench.py writes these; the
        # old _eval32768/_gt32768 entries were a different-world eval)
        (eval_q,) = loadz(key + "_evalw32768")
        gt_i, gt_d = loadz(key + "_gtw32768")
        (knn,) = loadz(key + "_knn")
    gt_i = gt_i.astype(np.int64)

    log("== build bipartite (M_pjbp=32) ==")
    t0 = time.time()
    index = build_bipartite(base, train_q, np.asarray(knn, np.int32),
                            BuildConfig(M_sq=64, M_pjbp=32, metric="ip"),
                            base_row_cap=cap)
    build_secs = time.time() - t0
    log(f"build {build_secs:.1f}s")

    s = BipartiteSearcher(index, base)
    rows = []
    for L in Ls:
        qb = min(qbmax, eval_q.shape[0])
        # warm (compile), then device-timed: results stay on device
        jax.block_until_ready(s.search(eval_q[:qb], k=K, L=L,
                                       query_batch=qb, device_out=True))
        t0 = time.time()
        out = s.search(eval_q, k=K, L=L, query_batch=qb, device_out=True)
        jax.block_until_ready(out)
        dt = time.time() - t0
        ids, dists, cmps, hops = (np.asarray(o) for o in out)
        rows.append({
            "mode": f"bipartite_two_hop_L{L}",
            "qps": round(eval_q.shape[0] / dt, 1),
            "recall": round(compute_recall(ids, gt_i, K), 4),
            "rderr": round(compute_rderr(dists, gt_d, K, "ip"), 6),
            "avg_hops": round(float(hops.mean()), 1),
            "avg_cmps": round(float(cmps.mean()), 1),
        })
        log(rows[-1])
    print(json.dumps({"scale": base.shape[0], "build_secs": round(build_secs, 1),
                      "rows": rows}))


if __name__ == "__main__":
    main()
