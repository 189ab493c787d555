"""Fused int8 neighbor-block search: recall parity with the f32 engine."""

import numpy as np
import pytest

from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.graph import build_roargraph
from mysteryann_tpu.search import Searcher
from mysteryann_tpu.search.fused import FusedSearcher
from mysteryann_tpu.utils.params import BuildConfig
from mysteryann_tpu.utils.metrics import compute_recall


@pytest.fixture(scope="module")
def built():
    base, train_q = make_cross_modal(4000, 1500, 48, metric="ip", seed=11)
    _, eval_q = make_cross_modal(10, 300, 48, metric="ip", seed=99)
    _, knn = exact_knn(train_q, base, k=32, metric="ip", precision="highest")
    cfg = BuildConfig(M_sq=32, M_pjbp=12, L_pjpq=64, metric="ip",
                      query_batch=512, search_batch=512,
                      connectivity_iters=4)
    index = build_roargraph(base, train_q, knn, cfg, verbose=False)
    _, gt = exact_knn(eval_q, base, k=10, metric="ip", precision="highest")
    return base, eval_q, index, gt


def test_fused_recall_close_to_f32(built):
    base, eval_q, index, gt = built
    f32 = Searcher(index, base)
    fused = FusedSearcher(index, base)
    ids_a, *_ = f32.search(eval_q, k=10, L=128, query_batch=300,
                           visited_mode="pool")
    ids_b, dists_b, cmps, hops = fused.search(eval_q, k=10, L=128,
                                              query_batch=300)
    ra = compute_recall(ids_a, gt, 10)
    rb = compute_recall(ids_b, gt, 10)
    assert rb > ra - 0.03, f"fused {rb} vs f32 {ra}"
    assert np.all(np.diff(dists_b, axis=1) >= -1e-5)  # reranked exact order
    assert np.all(cmps > 0) and np.all(hops > 0)


def test_fused_seeded_search(built):
    base, eval_q, index, gt = built
    fused = FusedSearcher(index, base, seed_sample=8)
    ids, dists, cmps, hops = fused.search(eval_q, k=10, L=64,
                                          query_batch=300, seeds=16)
    plain, *_ = fused.search(eval_q, k=10, L=64, query_batch=300)
    rs = compute_recall(ids, gt, 10)
    rp = compute_recall(plain, gt, 10)
    # per-query seeds replace the medoid walk: recall never collapses and
    # typically improves (the beam starts inside the target neighborhood)
    assert rs > rp - 0.02, f"seeded {rs} vs medoid {rp}"
    assert np.all(np.diff(dists, axis=1) >= -1e-5)


def test_fused_seed_validation(built):
    base, eval_q, index, gt = built
    plain = FusedSearcher(index, base)  # no sample kept
    with pytest.raises(ValueError):
        plain.search(eval_q[:4], k=5, L=32, seeds=8)
    seeded = FusedSearcher(index, base, seed_sample=8)
    with pytest.raises(ValueError):
        seeded.search(eval_q[:4], k=5, L=32, seeds=64)  # seeds > L
    with pytest.raises(ValueError):
        plain.search(eval_q[:4], k=40, L=32)  # k > L: pool holds only L


def test_fused_early_exit_trades_hops_for_recall(built):
    base, eval_q, index, gt = built
    fused = FusedSearcher(index, base, seed_sample=8)
    full = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16)
    fast = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16,
                        exit_f=0.5)
    assert float(fast[3].mean()) < float(full[3].mean())  # fewer hops
    rf = compute_recall(fast[0], gt, 10)
    assert rf > compute_recall(full[0], gt, 10) - 0.1  # bounded recall cost


def test_fused_dists_are_exact(built):
    base, eval_q, index, gt = built
    fused = FusedSearcher(index, base)
    ids, dists, *_ = fused.search(eval_q[:50], k=5, L=64, query_batch=50)
    # reported distances must be exact f32 (rerank), not int8 approximations
    qn = eval_q[:50] / np.linalg.norm(eval_q[:50], axis=1, keepdims=True)
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    want = -(qn[:, None, :] * bn[ids]).sum(-1)
    np.testing.assert_allclose(dists, want, rtol=1e-4, atol=1e-4)


def test_fused_int4_recall_close_to_int8(built):
    base, eval_q, index, gt = built
    f8 = FusedSearcher(index, base, seed_sample=8)
    f4 = FusedSearcher(index, base, seed_sample=8, bits=4)
    a, da, *_ = f8.search(eval_q, k=10, L=96, query_batch=300, seeds=16)
    b, db, *_ = f4.search(eval_q, k=10, L=96, query_batch=300, seeds=16)
    ra, rb = compute_recall(a, gt, 10), compute_recall(b, gt, 10)
    # int4 coarsens only traversal order; the exact f32 rerank bounds
    # the end-to-end recall cost to pool-boundary candidates
    assert rb > ra - 0.03, f"int4 {rb} vs int8 {ra}"
    assert np.all(np.diff(db, axis=1) >= -1e-5)  # reranked exact order


def test_fused_int4_dim_validation(built):
    base, eval_q, index, gt = built
    # d=48 is 16-aligned so the ctor path works; pack_neighbor_table
    # itself must reject a 4-bit pack of a non-16-aligned dim
    import jax.numpy as jnp
    from mysteryann_tpu.search.fused import pack_neighbor_table
    with pytest.raises(ValueError, match="dim % 16"):
        pack_neighbor_table(jnp.zeros((64, 24), jnp.float32),
                            np.zeros((64, 16), np.int32), bits=4)
    with pytest.raises(ValueError, match="bits"):
        pack_neighbor_table(jnp.zeros((64, 32), jnp.float32),
                            np.zeros((64, 16), np.int32), bits=2)


def test_fused_pool_mode_matches_merge(built):
    base, eval_q, index, gt = built
    fused = FusedSearcher(index, base, seed_sample=8)
    a = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16,
                     visited_mode="merge")
    b = fused.search(eval_q, k=10, L=96, query_batch=300, seeds=16,
                     visited_mode="pool")
    ra = compute_recall(a[0], gt, 10)
    rb = compute_recall(b[0], gt, 10)
    # pool membership vs merge dedup: same soundness argument (beam.py);
    # results may differ by ulp-level traversal ties only
    assert abs(ra - rb) < 0.01, (ra, rb)


@pytest.mark.parametrize("bits", [8, 4])
def test_incremental_repack_bit_identical(bits):
    """Scatter-repacking only changed supply rows must produce a table
    byte-identical to a full repack (the build's per-round fast path —
    graph/roargraph.py _repack_changed)."""
    import jax.numpy as jnp
    from mysteryann_tpu.search.fused import pack_neighbor_table
    from mysteryann_tpu.graph.roargraph import _repack_changed

    rng = np.random.default_rng(5)
    n, d, W = 512, 128, 32
    base = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    sup0 = rng.integers(0, n + 1, size=(n, W)).astype(np.int32)
    table, Mt = pack_neighbor_table(base, jnp.asarray(sup0), bits=bits)

    # mutate a sparse set of rows (incl. row 0 and the last row)
    sup1 = sup0.copy()
    changed = np.asarray([0, 3, 17, 100, n - 1], np.int32)
    sup1[changed] = rng.integers(0, n + 1, size=(changed.size, W))

    full, _ = pack_neighbor_table(base, jnp.asarray(sup1), bits=bits)
    inc = _repack_changed(jnp.copy(table), base, jnp.asarray(sup1),
                          changed, n, Mt, d, bits, blk=4)
    np.testing.assert_array_equal(np.asarray(inc), np.asarray(full))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_seed_scan_matches_oracle(rng, metric):
    """The tiled seed scan (3 tiles + remainder) returns the sample
    members nearest to each query under its bf16 scores."""
    import jax.numpy as jnp
    from mysteryann_tpu.search.seeding import make_seed_sample, seed_scan
    base = rng.standard_normal((3000, 16)).astype(np.float32)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    samp, samp_sq, samp_ids = make_seed_sample(jnp.asarray(base), 2)
    ids, dists = seed_scan(samp, samp_sq, samp_ids, jnp.asarray(q),
                           n_seeds=6, metric=metric, tile=400)
    sb = np.asarray(samp.astype(jnp.float32), np.float64)
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32),
                    np.float64)
    ip = qb @ sb.T
    if metric == "ip":
        d = -ip
    else:
        d = np.maximum((q.astype(np.float64) ** 2).sum(1)[:, None] - 2 * ip
                       + np.asarray(samp_sq, np.float64)[None, :], 0)
    want = np.argsort(d, axis=1, kind="stable")[:, :6] * 2   # sample ids
    np.testing.assert_array_equal(np.sort(np.asarray(ids), 1),
                                  np.sort(want, 1))
    np.testing.assert_allclose(np.asarray(dists),
                               np.sort(d, axis=1)[:, :6], rtol=1e-3,
                               atol=1e-3)


def test_fused_at_dim_200_exact_recall():
    """d=200 (the reference's T2I width, not a multiple of 128): the
    fused engine packs 200-byte rows and its exact f32 rerank reports
    distances equal to float64 numpy's for the returned ids."""
    base, train_q = make_cross_modal(3000, 1200, 200, metric="ip", seed=5)
    _, eval_q = make_cross_modal(10, 200, 200, metric="ip", seed=5,
                                 query_seed=6)
    _, knn = exact_knn(train_q, base, k=24, metric="ip", precision="highest")
    cfg = BuildConfig(M_sq=24, M_pjbp=12, L_pjpq=48, metric="ip",
                      query_batch=512, search_batch=512,
                      connectivity_iters=4)
    index = build_roargraph(base, train_q, knn, cfg, verbose=False)
    _, gt = exact_knn(eval_q, base, k=10, metric="ip", precision="highest")
    fused = FusedSearcher(index, base, seed_sample=2)
    ids, dists, _, _ = fused.search(eval_q, k=10, L=64, query_batch=200,
                                    expand=2, seeds=16)
    assert compute_recall(ids, gt, 10) > 0.9
    ref = -np.einsum("bd,bkd->bk", eval_q.astype(np.float64),
                     base.astype(np.float64)[ids])
    np.testing.assert_allclose(dists, ref, rtol=1e-5, atol=1e-5)
