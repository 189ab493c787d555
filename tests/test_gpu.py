"""Checks that need an NVIDIA GPU (marker ``gpu``).

They skip on other machines and run on the card from chip_smoke.py's
kernel phase (``python chip_smoke.py``), in the process that holds it.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; the first device is "
                    f"{dev.platform}")
    return dev


@pytest.mark.parametrize("k", [10, 64])
def test_min_k_matches_top_k(gpu, k):
    """Exact selection on the card: the chunk-min prefilter returns the
    same values as a full top-k of the same block."""
    import jax
    import jax.numpy as jnp
    from mysteryann_tpu.ops.knn import min_k
    x = jax.random.normal(jax.random.key(0), (1024, 131072 + 77))
    v, p = jax.jit(min_k, static_argnums=1)(x, k)
    nv, _ = jax.jit(jax.lax.top_k, static_argnums=1)(-x, k)
    np.testing.assert_array_equal(np.asarray(v), -np.asarray(nv))
    np.testing.assert_array_equal(
        np.take_along_axis(np.asarray(x), np.asarray(p), axis=1),
        np.asarray(v))


def test_int8_dot_is_exact(gpu):
    """s8 x s8 -> s32 accumulates exactly, as the int8 scans assume."""
    import jax.numpy as jnp
    from mysteryann_tpu.ops.knn import _s8_dot
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (512, 128), dtype=np.int8)
    b = rng.integers(-127, 128, (4096, 128), dtype=np.int8)
    got = np.asarray(_s8_dot(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        got, a.astype(np.int64) @ b.astype(np.int64).T)


def test_matmul_precisions(gpu):
    """"highest" is full f32 (the GT and rerank precision); "default"
    may run in TF32 and stays within its ~1e-3 relative error."""
    import jax.numpy as jnp
    from mysteryann_tpu.ops.distances import pairwise_dist
    rng = np.random.default_rng(1)
    q = rng.standard_normal((256, 128)).astype(np.float32)
    b = rng.standard_normal((4096, 128)).astype(np.float32)
    ref = -(q.astype(np.float64) @ b.astype(np.float64).T)
    scale = np.abs(ref).max()
    hi = np.asarray(pairwise_dist(jnp.asarray(q), jnp.asarray(b),
                                  precision="highest"))
    lo = np.asarray(pairwise_dist(jnp.asarray(q), jnp.asarray(b)))
    assert np.abs(hi - ref).max() < 1e-5 * scale
    assert np.abs(lo - ref).max() < 1e-2 * scale


def test_row_gather(gpu):
    """`jnp.take` of byte rows from a 3-D table, as the fused engine
    gathers them."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    table = rng.integers(0, 256, (20001, 8, 128), dtype=np.uint8)
    idx = rng.integers(0, table.shape[0], 5000).astype(np.int32)
    got = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(got, table[idx])
