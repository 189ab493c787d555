"""Sharded build: exact agreement with the single-device build.

The sharded build (parallel/sharded_build.py) must produce the SAME
adjacency as graph.build_roargraph — the only arithmetic difference is
owner-masked psum gathers, which add zeros to the owner's value and are
therefore bit-exact on the CPU (module docstring; GPUs round some
distances differently). These tests pin that contract on the 8-device
virtual CPU mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mysteryann_tpu.io import make_cross_modal
from mysteryann_tpu.ops import exact_knn
from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.graph import build_roargraph
from mysteryann_tpu.graph.roargraph import _connectivity_pass
from mysteryann_tpu.parallel import make_mesh
from mysteryann_tpu.parallel.sharded_build import (
    sharded_build_roargraph, sharded_prune_rows, take_rows_sharded,
    scatter_rows_sharded)
from mysteryann_tpu.parallel.sharded_search import distributed_beam_search
from mysteryann_tpu.search.beam import beam_search
from mysteryann_tpu.utils.params import BuildConfig

N, NQ, D = 1024, 512, 32
# classic engine on both sides: the sharded phase D mirrors the classic
# traversal (the fused byte-row engine is a single-chip serving accel)
CFG = BuildConfig(M_sq=24, M_pjbp=8, L_pjpq=32, metric="ip",
                  query_batch=256, search_batch=128, connectivity_iters=4,
                  connectivity_engine="classic")


@pytest.fixture(scope="module")
def world():
    base, train_q = make_cross_modal(N, NQ, D, metric="ip", seed=21)
    _, knn = exact_knn(train_q, base, k=CFG.M_sq, metric="ip",
                       precision="highest")
    return base, train_q, np.asarray(knn, np.int32)


def test_sharded_prune_matches_local(world):
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    base_dev = prepare_vectors(base, Metric.IP)
    from jax.sharding import NamedSharding, PartitionSpec as P
    base_sh = jax.device_put(base_dev, NamedSharding(mesh, P("mp", None)))

    from mysteryann_tpu.graph.roargraph import _batched_prune_rows
    tgt = knn[:, 0].astype(np.int32)
    cand = np.where(knn == tgt[:, None], N, knn).astype(np.int32)
    want = _batched_prune_rows(base_dev, tgt, cand, CFG.M_pjbp, Metric.IP,
                              256, fill=True)
    got = np.asarray(sharded_prune_rows(
        mesh, base_sh, tgt, cand, CFG.M_pjbp, Metric.IP, 256, fill=True,
        n=N))
    np.testing.assert_array_equal(got, want)


def test_distributed_pool_search_hist_matches(world):
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    base_dev = prepare_vectors(base, Metric.IP)
    # a kNN graph as the traversal structure
    _, ids = exact_knn(base, base, k=9, metric="ip", precision="highest")
    nb = np.asarray(ids[:, 1:], np.int32)
    eps = jnp.asarray([3], jnp.int32)
    q = base_dev[:64]
    H = 3 * 32
    want = beam_search(base_dev, jnp.asarray(nb), eps, q, k=1, L=32,
                       metric=Metric.IP, visited_mode="pool",
                       collect_expanded=H)
    got = distributed_beam_search(mesh, base_dev, jnp.asarray(nb), eps, q,
                                  k=1, L=32, metric=Metric.IP,
                                  visited_mode="pool", collect_expanded=H)
    np.testing.assert_array_equal(np.asarray(got.hist_ids),
                                  np.asarray(want.hist_ids))
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids))


def test_distributed_search_expand_matches(world):
    # expand>1: multi-pop selection must mirror the single-chip engine
    # bit-for-bit (VERDICT r3 #7 — the 1M recipe builds with expand=4)
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    base_dev = prepare_vectors(base, Metric.IP)
    _, ids = exact_knn(base, base, k=9, metric="ip", precision="highest")
    nb = np.asarray(ids[:, 1:], np.int32)
    eps = jnp.asarray([3], jnp.int32)
    q = base_dev[:64]
    H = 3 * 32
    for e in (2, 4):
        want = beam_search(base_dev, jnp.asarray(nb), eps, q, k=1, L=32,
                           metric=Metric.IP, visited_mode="pool",
                           collect_expanded=H, expand=e)
        got = distributed_beam_search(mesh, base_dev, jnp.asarray(nb), eps,
                                      q, k=1, L=32, metric=Metric.IP,
                                      visited_mode="pool",
                                      collect_expanded=H, expand=e)
        np.testing.assert_array_equal(np.asarray(got.hist_ids),
                                      np.asarray(want.hist_ids))
        np.testing.assert_array_equal(np.asarray(got.ids),
                                      np.asarray(want.ids))
        np.testing.assert_array_equal(np.asarray(got.hops),
                                      np.asarray(want.hops))


def test_sharded_build_expand4_matches_single_device(world):
    # the recommended 1M recipe's knobs (expand=4, 2 passes) through the
    # sharded build — dryrun stage 5 runs this same config
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    import dataclasses
    cfg = dataclasses.replace(CFG, connectivity_expand=4,
                              connectivity_passes=2)
    want = build_roargraph(base, train_q, knn, cfg, verbose=False)
    got = sharded_build_roargraph(mesh, base, train_q, knn, cfg)
    assert got.graph.ep == want.graph.ep
    np.testing.assert_array_equal(got.graph.neighbors, want.graph.neighbors)


def test_take_scatter_rows_sharded():
    mesh = make_mesh(dp=2, mp=4)
    from jax.sharding import NamedSharding, PartitionSpec as P
    arr = np.arange(64 * 6, dtype=np.int32).reshape(64, 6)
    arr_sh = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("mp", None)))
    ids = np.array([0, 17, 33, 63, 5, 48], np.int32)
    got = np.asarray(take_rows_sharded(mesh, arr_sh, ids))
    np.testing.assert_array_equal(got, arr[ids])
    rows = jnp.asarray(-np.ones((6, 6), np.int32))
    arr_sh2 = scatter_rows_sharded(mesh, arr_sh, ids, rows)
    full = np.asarray(arr_sh2)
    want = arr.copy()
    want[ids] = -1
    np.testing.assert_array_equal(full, want)


def test_sharded_build_matches_single_device(world):
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    want = build_roargraph(base, train_q, knn, CFG, verbose=False)
    got = sharded_build_roargraph(mesh, base, train_q, knn, CFG)
    assert got.graph.ep == want.graph.ep
    a, b = got.graph.neighbors, want.graph.neighbors
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_sharded_build_two_pass_matches_single_device(world):
    # the recommended recipe (connectivity_passes=2, BASELINE.md) must
    # hold the exactness contract too: the second phase-D sweep re-enters
    # _append_novel + overflow prune, which the 1-pass test never reaches
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    import dataclasses
    cfg = dataclasses.replace(CFG, connectivity_passes=2)
    want = build_roargraph(base, train_q, knn, cfg, verbose=False)
    got = sharded_build_roargraph(mesh, base, train_q, knn, cfg)
    assert got.graph.ep == want.graph.ep
    np.testing.assert_array_equal(got.graph.neighbors, want.graph.neighbors)


def test_sharded_build_rejects_fused_engine(world):
    base, train_q, knn = world
    mesh = make_mesh(dp=2, mp=4)
    import dataclasses
    cfg = dataclasses.replace(CFG, connectivity_engine="fused")
    with pytest.raises(ValueError, match="classic"):
        sharded_build_roargraph(mesh, base, train_q, knn, cfg)
