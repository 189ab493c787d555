"""Flat index: exactness, metrics, benchmark schema."""

import numpy as np
import pytest

from mysteryann_tpu.flat import FlatIndex
from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.utils.metrics import compute_recall


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_flat_exactness(metric, rng):
    base, q = make_cross_modal(3000, 200, 32, metric=metric, seed=51)
    idx = FlatIndex(base, metric=metric, tile=1024)
    ids, dists = idx.search(q, k=10)
    _, gt = exact_knn(q, base, k=10, metric=metric, precision="highest")
    assert compute_recall(ids, gt, 10) > 0.99
    assert np.all(np.diff(dists, axis=1) >= -1e-5)


def test_flat_uneven_batches(rng):
    base, q = make_cross_modal(500, 77, 16, metric="ip", seed=52)
    idx = FlatIndex(base, metric="ip", tile=128)
    ids, _ = idx.search(q, k=5, query_batch=50)  # 77 -> 50 + 27 padded
    assert ids.shape == (77, 5)
    _, gt = exact_knn(q, base, k=5, metric="ip", precision="highest")
    assert compute_recall(ids, gt, 5) > 0.99


def test_flat_benchmark_schema():
    base, q = make_cross_modal(1000, 64, 16, metric="ip", seed=53)
    idx = FlatIndex(base, metric="ip", tile=512)
    r = idx.benchmark(q, k=5, query_batch=64)
    assert r["qps"] > 0 and r["avg_cmps"] == 1000.0
    assert r["ids"].shape == (64, 5)


def test_flat_int8_matches_exact():
    import numpy as np
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.ops import compute_ground_truth
    from mysteryann_tpu.utils.metrics import compute_recall

    base, queries = make_cross_modal(4000, 200, 48, metric="ip", seed=5)
    gt_i, _ = compute_ground_truth(queries, base, k=10, metric="ip")
    idx = FlatIndex(base, metric="ip", precision="int8", oversample=4)
    ids, dists = idx.search(queries, k=10, query_batch=200)
    rec = compute_recall(ids, gt_i.astype(np.int64), 10)
    assert rec >= 0.99, rec
    # reported dists are exact f32 (match GT head where ids agree)
    assert dists.dtype == np.float32


def test_flat_int8_l2():
    import numpy as np
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.ops import compute_ground_truth
    from mysteryann_tpu.utils.metrics import compute_recall

    base, queries = make_cross_modal(3000, 100, 32, metric="l2", seed=6)
    gt_i, _ = compute_ground_truth(queries, base, k=10, metric="l2")
    idx = FlatIndex(base, metric="l2", precision="int8", oversample=4)
    ids, _ = idx.search(queries, k=10, query_batch=100)
    rec = compute_recall(ids, gt_i.astype(np.int64), 10)
    assert rec >= 0.98, rec


def test_flat_k_exceeds_corpus_raises():
    # the reference throws when search returns < k results; a silently
    # narrower result breaks [Q, k] consumers
    import pytest
    rng = np.random.default_rng(0)
    base = rng.standard_normal((7, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="corpus"):
        FlatIndex(base, metric="ip").search(q, k=10)


def test_flat_bf16_matches_exact():
    import numpy as np
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.ops import compute_ground_truth
    from mysteryann_tpu.utils.metrics import compute_recall

    base, queries = make_cross_modal(4000, 200, 48, metric="ip", seed=5)
    gt_i, gt_d = compute_ground_truth(queries, base, k=10, metric="ip")
    idx = FlatIndex(base, metric="ip", precision="bf16", oversample=4)
    ids, dists = idx.search(queries, k=10, query_batch=200)
    rec = compute_recall(ids, gt_i.astype(np.int64), 10)
    assert rec >= 0.99, rec
    # the bf16 table only drives SELECTION; reported dists are exact f32
    assert dists.dtype == np.float32
    agree = ids == gt_i
    np.testing.assert_allclose(np.where(agree, dists, 0),
                               np.where(agree, gt_d, 0), rtol=1e-5)


def test_flat_bf16_l2():
    import numpy as np
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.ops import compute_ground_truth
    from mysteryann_tpu.utils.metrics import compute_recall

    base, queries = make_cross_modal(3000, 100, 32, metric="l2", seed=6)
    gt_i, _ = compute_ground_truth(queries, base, k=10, metric="l2")
    idx = FlatIndex(base, metric="l2", precision="bf16", oversample=4)
    ids, _ = idx.search(queries, k=10, query_batch=100)
    rec = compute_recall(ids, gt_i.astype(np.int64), 10)
    assert rec >= 0.98, rec


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_rerank_is_exact_f32_at_dim_200(metric):
    """The head rerank runs at Precision.HIGHEST: at d=200 its distances
    match float64 numpy to f32 rounding (a TF32 or bf16 pass would miss
    by ~1e-3 relative)."""
    import jax.numpy as jnp
    from mysteryann_tpu.flat import _rerank_f32
    from mysteryann_tpu.ops.distances import Metric
    rng = np.random.default_rng(4)
    base = rng.standard_normal((2000, 200)).astype(np.float32)
    q = rng.standard_normal((16, 200)).astype(np.float32)
    cand = rng.integers(0, 2000, (16, 30)).astype(np.int32)
    d, i = _rerank_f32(jnp.asarray(base), jnp.asarray(q), jnp.asarray(cand),
                       5, Metric.parse(metric))
    b64, q64 = base.astype(np.float64), q.astype(np.float64)
    vec = b64[cand]
    if metric == "ip":
        full = -np.einsum("bd,bkd->bk", q64, vec)
    else:
        full = ((q64[:, None, :] - vec) ** 2).sum(-1)
    order = np.argsort(full, axis=1, kind="stable")[:, :5]
    np.testing.assert_allclose(np.asarray(d),
                               np.take_along_axis(full, order, axis=1),
                               rtol=2e-6, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(i),
                                  np.take_along_axis(cand, order, axis=1))
