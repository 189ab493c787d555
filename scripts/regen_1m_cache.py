"""Regenerate the 1M bench workload artifacts into .bench_cache
(data / eval queries / exact GT / train kNN) — exactly the arrays
bench.py caches, so a subsequent bench.py run skips straight to timing.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache")

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, ".cache", "jax"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "5")
from mysteryann_tpu.utils.cache import enable_compile_cache, npz_cached
enable_compile_cache()

KEY = "t2i1m_v3_1000000_200000_128"
WORLD = dict(n_concepts=20_000, intrinsic_dim=48, noise=0.85)
N_BASE, N_TRAIN, N_EVAL, DIM, K, M_SQ = 1_000_000, 200_000, 32_768, 128, 10, 64
METRIC = "ip"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import exact_knn

    t0 = time.time()
    base, train_q = npz_cached(CACHE, KEY + "_data", lambda: make_cross_modal(
        N_BASE, N_TRAIN, DIM, metric=METRIC, seed=7, **WORLD))
    log(f"data: {time.time() - t0:.1f}s")

    t0 = time.time()
    (eval_q,) = npz_cached(CACHE, f"{KEY}_evalw{N_EVAL}", lambda: [
        make_cross_modal(1, N_EVAL, DIM, metric=METRIC, seed=7,
                         query_seed=8, **WORLD)[1]])
    log(f"eval: {time.time() - t0:.1f}s")

    t0 = time.time()
    gt_i, gt_d = npz_cached(CACHE, f"{KEY}_gtw{N_EVAL}", lambda: list(reversed(
        exact_knn(eval_q, base, k=K, metric=METRIC, query_batch=8192,
                  base_tile=131072, precision="highest"))))
    log(f"gt: {time.time() - t0:.1f}s")

    t0 = time.time()
    (knn,) = npz_cached(CACHE, KEY + "_knn", lambda: [exact_knn(
        train_q, base, k=M_SQ, metric=METRIC, query_batch=8192,
        base_tile=131072)[1]])
    log(f"train knn: {time.time() - t0:.1f}s")
    log("done")


if __name__ == "__main__":
    main()
