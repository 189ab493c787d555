"""mp-sharded fused-table serving vs the single-chip engine (8-device
virtual CPU mesh): results must be BIT-IDENTICAL — same packed rows,
same traced scoring helper, owner-masked psum adds exact zeros."""

import jax
import numpy as np
import pytest

from mysteryann_tpu.graph import build_roargraph
from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.parallel import ShardedFusedSearcher, make_mesh
from mysteryann_tpu.search.fused import FusedSearcher
from mysteryann_tpu.utils.metrics import compute_recall
from mysteryann_tpu.utils.params import BuildConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def built():
    base, train_q = make_cross_modal(4000, 800, 32, metric="ip", seed=11)
    _, eval_q = make_cross_modal(1, 64, 32, metric="ip", seed=11,
                                 query_seed=5)
    _, knn = exact_knn(train_q, base, k=24, metric="ip",
                       precision="highest")
    cfg = BuildConfig(M_sq=24, M_pjbp=8, L_pjpq=32, metric="ip")
    index = build_roargraph(base, train_q, np.asarray(knn, np.int32), cfg,
                            verbose=False)
    _, gt = exact_knn(eval_q, base, k=10, metric="ip", precision="highest")
    return base, eval_q, index, np.asarray(gt)


@pytest.mark.parametrize("bits,expand", [(8, 1), (8, 2), (4, 2)])
def test_sharded_matches_single_chip(built, bits, expand):
    base, eval_q, index, gt = built
    mesh = make_mesh(dp=2, mp=4)
    ref = FusedSearcher(index, base, bits=bits)
    a = ref.search(eval_q, k=10, L=24, query_batch=64, expand=expand,
                   visited_mode="merge")
    sh = ShardedFusedSearcher(mesh, index, base, bits=bits)
    b = sh.search(eval_q, k=10, L=24, expand=expand)
    np.testing.assert_array_equal(a[0], b[0])          # ids
    np.testing.assert_array_equal(a[1], b[1])          # exact f32 dists
    np.testing.assert_array_equal(a[2], b[2])          # cmps
    np.testing.assert_array_equal(a[3], b[3])          # hops
    assert compute_recall(b[0], gt, 10) > 0.85


def test_sharded_seeded_matches_single_chip(built):
    base, eval_q, index, gt = built
    mesh = make_mesh(dp=2, mp=4)
    ref = FusedSearcher(index, base, bits=8, seed_sample=4)
    a = ref.search(eval_q, k=10, L=24, query_batch=64, expand=2, seeds=8,
                   visited_mode="merge")
    sh = ShardedFusedSearcher(mesh, index, base, bits=8, seed_sample=4)
    b = sh.search(eval_q, k=10, L=24, expand=2, seeds=8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert compute_recall(b[0], gt, 10) > 0.9


def test_sharded_l2_matches_single_chip(built):
    base, eval_q, index, _ = built
    # metric override: serve the same adjacency under L2 on both engines
    import dataclasses
    from mysteryann_tpu.ops.distances import Metric
    idx_l2 = dataclasses.replace(index, metric=Metric.L2)
    mesh = make_mesh(dp=2, mp=4)
    ref = FusedSearcher(idx_l2, base, bits=8)
    a = ref.search(eval_q, k=10, L=24, query_batch=64, expand=2,
                   visited_mode="merge")
    sh = ShardedFusedSearcher(mesh, idx_l2, base, bits=8)
    b = sh.search(eval_q, k=10, L=24, expand=2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_sharded_fused_arg_validation(built):
    base, eval_q, index, _ = built
    mesh = make_mesh(dp=2, mp=4)
    sh = ShardedFusedSearcher(mesh, index, base)
    with pytest.raises(ValueError, match="seeds"):
        sh.search(eval_q, k=10, L=24, seeds=8)   # no seed_sample at init
    with pytest.raises(ValueError, match="k"):
        sh.search(eval_q, k=30, L=24)


def test_10m_shard_packing_math():
    """Pin the 10M-shape packing arithmetic (VERDICT r4 #8): row bytes,
    shard row counts/offsets, per-shard table bytes, and the global-id ->
    (owner, local) mapping at the exact numbers scripts/bench_10m.py
    --sharded-fused serves — no 10M allocation, just the math the real
    run depends on."""
    from mysteryann_tpu.search.fused import _row_bytes

    n, d, M, bits, mp = 10_000_000, 128, 32, 4, 8
    R = _row_bytes(M, d, bits)
    # 32 int4 neighbors x 128d = 2048 B payload + 32 ids x 8 B = 2304 B,
    # padded to the 1 KB row multiple
    assert R == 3072
    sn = -(-n // mp)
    assert sn == 1_250_000                    # rows per shard (exact split)
    shard_bytes = (sn + 1) * R                # +1 local sentinel row
    assert shard_bytes == 3_840_003_072       # ~3.84 GB/shard
    assert shard_bytes < 11 << 30             # well inside one device
    assert mp * sn >= n
    # global-id -> owner/local round trip at the shard edges
    for gid in (0, sn - 1, sn, n - 1):
        owner, local = gid // sn, gid % sn
        assert owner * sn + local == gid
        assert 0 <= owner < mp and 0 <= local < sn
    # rerank base shards: [mp, sn, d] f32 = 5.12 GB total, 640 MB/shard
    assert sn * d * 4 == 640_000_000


def test_pack_shard_host_tail_padding():
    """A non-divisible n: the tail shard's out-of-corpus rows must pack
    as sentinel rows (all-invalid ids -> zero contribution), so the
    mp-padded table serves identically to the unpadded corpus."""
    import jax.numpy as jnp
    from mysteryann_tpu.parallel.sharded_fused import _pack_shard_host
    from mysteryann_tpu.search.fused import _pack_chunk, _row_bytes

    n, d, M, bits, mp = 10, 16, 4, 8, 4
    sn = -(-n // mp)  # 3 rows/shard -> shard 3 owns rows 9..11, 10/11 pad
    rng = np.random.default_rng(0)
    base = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    nb = rng.integers(0, n, size=(n, M)).astype(np.int32)
    shard = _pack_shard_host(base, nb, 3 * sn, sn, n, M, d, bits)
    assert shard.shape == (sn + 1, _row_bytes(M, d, bits) // 128, 128)
    sent = np.asarray(_pack_chunk(base, jnp.asarray(
        np.full((1, M), n, np.int32)), n_base=n, M=M, d=d, bits=bits))[0]
    # row 9 is real; rows 10, 11 and the sentinel slot pack as sentinel
    real = np.asarray(_pack_chunk(base, jnp.asarray(nb[9:10]),
                                  n_base=n, M=M, d=d, bits=bits))[0]
    np.testing.assert_array_equal(shard[0], real)
    for i in (1, 2, sn):
        np.testing.assert_array_equal(shard[i], sent)
