"""npz compute-or-load cache used by the benchmark scripts.

One shared implementation (bench.py, scripts/bench_10m.py and
scripts/build_10m.py each carried a copy). Writes are atomic
(tmp + rename) so an interrupted run can't leave a truncated .npz that
poisons every later run.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence

import numpy as np


def enable_compile_cache(path: str | None = None,
                         min_compile_secs: float = 1.0) -> None:
    """Turn on JAX's persistent compilation cache (call before first jit).

    The directory is ``path``, else ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else <repo>/.cache/jax. It is set through the config route,
    which initializes the cache whether or not the environment variable
    was read at import.
    """
    import jax
    if path is None:
        path = os.environ.get(
            "JAX_COMPILATION_CACHE_DIR",
            os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), ".cache", "jax"))
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only install: run without the persistent cache
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)


def npz_cached(cache_dir: str, name: str,
               fn: Callable[[], Sequence[np.ndarray]]) -> List[np.ndarray]:
    """Return fn()'s arrays, loading from ``cache_dir/name.npz`` when present."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, name + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[k] for k in z.files]
    out = [np.asarray(a) for a in fn()]
    # np.savez appends ".npz" unless the name already ends with it
    tmp = path[:-4] + f".tmp{os.getpid()}.npz"
    np.savez(tmp, *out)
    os.replace(tmp, path)
    return out
