import numpy as np

from mysteryann_tpu.ops import Metric, exact_knn, compute_ground_truth
from mysteryann_tpu.io import make_cross_modal


def _brute(q, b, k, metric):
    if metric == "l2":
        d = ((q[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    else:
        d = -(q @ b.T)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, axis=1), ids


def test_exact_knn_matches_numpy_ip(rng):
    b = rng.standard_normal((500, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    d, i = exact_knn(q, b, k=10, metric="ip", query_batch=16, base_tile=128,
                     precision="highest")
    gd, gi = _brute(q, b, 10, "ip")
    np.testing.assert_allclose(d, gd, rtol=1e-4, atol=1e-4)
    assert (i == gi).mean() > 0.99  # ties may reorder


def test_exact_knn_matches_numpy_l2(rng):
    b = rng.standard_normal((300, 17)).astype(np.float32)
    q = rng.standard_normal((25, 17)).astype(np.float32)
    d, i = exact_knn(q, b, k=5, metric="l2", query_batch=32, base_tile=64,
                     precision="highest")
    gd, gi = _brute(q, b, 5, "l2")
    np.testing.assert_allclose(d, gd, rtol=1e-3, atol=1e-3)
    assert (i == gi).mean() > 0.99


def test_exact_knn_uneven_tiles(rng):
    # N not divisible by tile: padding must never be selected
    b = rng.standard_normal((101, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    d, i = exact_knn(q, b, k=101, metric="l2", base_tile=33, precision="highest")
    assert np.all(i >= 0) and np.all(i < 101)
    assert np.all(np.isfinite(d))
    # all ids present exactly once
    for row in i:
        assert len(set(row.tolist())) == 101


def test_compute_ground_truth_sorted(rng):
    base, q = make_cross_modal(800, 50, 24, metric="ip", seed=3)
    ids, dists = compute_ground_truth(q, base, k=10, metric="ip")
    assert ids.dtype == np.uint32
    assert np.all(np.diff(dists, axis=1) >= -1e-6)  # ascending


# ---- the exact selection every scan goes through ---------------------------

import pytest  # noqa: E402

from mysteryann_tpu.ops.knn import (exact_knn_device,  # noqa: E402
                                    int8_global_knn_device, int8_knn_device,
                                    min_k, quantize_global_int8,
                                    quantize_rows_int8)


def _oracle(q, b, k, metric):
    """float64 numpy distances + argsort (cosine on normalized rows)."""
    q, b = q.astype(np.float64), b.astype(np.float64)
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
    if metric == "l2":
        d = ((q[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    else:
        d = -(q @ b.T)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, axis=1), ids


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
@pytest.mark.parametrize("n,tile", [(4096, 1024), (4096 + 389, 1024)],
                         ids=["tile_divides_n", "remainder_tile"])
def test_scan_selection_matches_argsort(rng, metric, n, tile):
    """`min_k` inside the tiled scan (rows of 1024 = 8 chunks, so the
    chunk prefilter runs for k=3; the remainder tile takes the plain
    top-k) returns the numpy argsort's top-k."""
    import jax.numpy as jnp
    from mysteryann_tpu.ops.distances import prepare_vectors
    b = rng.standard_normal((n, 24)).astype(np.float32)
    q = rng.standard_normal((33, 24)).astype(np.float32)
    d, i = exact_knn_device(prepare_vectors(q, metric),
                            prepare_vectors(b, metric), k=3, metric=metric,
                            tile=tile, precision="highest")
    gd, gi = _oracle(q, b, 3, metric)
    np.testing.assert_allclose(np.asarray(d), gd, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(i), gi)
    # and the helper alone on one ragged block
    blk = jnp.asarray(rng.standard_normal((5, n)).astype(np.float32))
    v, p = min_k(blk, 7)
    ref = np.sort(np.asarray(blk), axis=1)[:, :7]
    np.testing.assert_array_equal(np.asarray(v), ref)
    np.testing.assert_array_equal(
        np.take_along_axis(np.asarray(blk), np.asarray(p), axis=1), ref)


@pytest.mark.parametrize("scale", ["global", "row"])
def test_int8_scans_with_remainder_tile(rng, scale):
    """Both int8 scans over N = 3 tiles + a remainder: ids rank by the
    exact integer scores (global) or the dequantized ones (row)."""
    import jax.numpy as jnp
    n, tile, k = 3 * 512 + 77, 512, 5
    b = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((17, 32)).astype(np.float32)
    bj, qj = jnp.asarray(b), jnp.asarray(q)
    q8, qs = quantize_rows_int8(qj)
    if scale == "global":
        b8, _ = quantize_global_int8(bj)
        d, i = int8_global_knn_device(q8, b8, k=k, tile=tile)
        s = -(np.asarray(q8, np.int64) @ np.asarray(b8, np.int64).T)
    else:
        b8, bs = quantize_rows_int8(bj)
        d, i = int8_knn_device(qj, b8, bs, k=k, tile=tile)
        s = -((np.asarray(q8, np.float64) @ np.asarray(b8, np.float64).T)
              * np.asarray(qs, np.float64)[:, None]
              * np.asarray(bs, np.float64)[None, :])
    want = np.sort(s, axis=1)[:, :k]
    np.testing.assert_allclose(np.asarray(d), want, rtol=1e-5, atol=1e-3)
    got = np.take_along_axis(s, np.asarray(i).astype(np.int64), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert np.all((np.asarray(i) >= 0) & (np.asarray(i) < n))
