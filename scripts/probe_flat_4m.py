"""Measure the flat serving modes at 4M (completes the 4M story).

BASELINE.md's 4M section has the fused-graph recall and the measured CPU
reference bar (run_baseline_4m.py); this probe adds the flat rows on the
same cached world (the f32 corpus is 2 GB at 4M). Rows: flat f32, flat
bf16-resident. Ramp-discarded median-of-5, identical protocol to
bench.py.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")

from mysteryann_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

KEY = "t2i4m_v3_4000000_128"
N_TRAIN = 400_000
K = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.utils.metrics import compute_recall

    with np.load(os.path.join(CACHE, KEY + "_all.npz")) as z:
        base, queries = z[z.files[0]], z[z.files[1]]
    eval_q = queries[N_TRAIN:]
    with np.load(os.path.join(CACHE, KEY + "_graph400000_gt.npz")) as z:
        gt_i = z[z.files[0]].astype(np.int64)

    rows = []
    for precision in ("f32", "bf16"):
        idx = FlatIndex(base, metric="ip", precision=precision,
                        tile=base.shape[0], oversample=2)
        for t in range(2):
            idx.benchmark(eval_q, k=K, warmup=1 if t == 0 else 0)
        trials = [idx.benchmark(eval_q, k=K, warmup=0) for _ in range(5)]
        qpss = sorted(t["qps"] for t in trials)
        rec = compute_recall(trials[-1]["ids"], gt_i, K)
        rows.append({"mode": f"flat_{precision}",
                     "qps": round(qpss[2], 1), "qps_min": round(qpss[0], 1),
                     "qps_max": round(qpss[-1], 1),
                     "recall": round(float(rec), 4)})
        log(rows[-1])
        del idx
        import jax
        jax.clear_caches()

    print(json.dumps({"probe": "flat_4m", "rows": rows}))


if __name__ == "__main__":
    main()
