#!/usr/bin/env python3
"""Smoke test of the RoarGraph build and serving path on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py                # one card, phases 1-6 below
    python chip_smoke.py --four-cards   # four cards: the sharded path only

One process drives the card(s). Phases run in order and each prints its
results on lines of its own:

1. device   — the first JAX device must be a GPU (no CPU fallback); its
               kind, the device count and ``nvidia-smi``'s name and power
               limit are printed;
2. data     — the bench world: 1M x 128-d IP base with 200k OOD training
               queries (BASELINE.json configs[0] scale), 10k eval queries,
               exact ground truth at full f32 precision;
3. build    — training-query kNN (k=64) and `build_roargraph` with the
               bench recipe, saved and loaded back through the registry;
4. serve    — recall@10 and rderr of flat f32/bf16/int8, the seeded fused
               engine, the classic engine and the ``msann-search-roargraph``
               CLI, each held to the recall recorded in BASELINE.md;
5. kernels  — the exact selection and the row gathers against plain
               references at real widths, compiled memory analyses, the
               int8 matmul's lowering, and the tests marked ``gpu``;
6. the last stdout line: ``{"ok": true, "device": {...}}``.

No phase catches its own failure: any exception ends the run with a
non-zero exit code and no ok line. Times printed on the way are findings
for the record, each beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 10


@dataclasses.dataclass(frozen=True)
class World:
    """Data, recipe and serving settings of one smoke run."""

    n_base: int = 1_000_000
    n_train: int = 200_000
    n_eval: int = 10_000
    dim: int = 128
    n_concepts: int = 20_000
    intrinsic_dim: int = 48
    noise: float = 0.85
    # build recipe (bench.py): M_sq, M_pjbp, L_pjpq, passes, expand, bits
    knn_k: int = 64
    M_pjbp: int = 32
    L_pjpq: int = 128
    passes: int = 2
    build_expand: int = 4
    build_bits: int = 4
    batch: int = 8192
    # serving (bench.py): fused (expand, seeds, L) rows and the classic row
    seed_sample: int = 2
    max_degree: int = 48
    fused_rows: tuple = ((4, 40, 48), (3, 48, 176))
    classic_L: int = 100
    # score-block widths of the selection check (phase 5)
    select_widths: tuple = (65536, 131072, 262144)
    # recall@10 floors: the BASELINE.md records less 0.01 (None: no floor)
    floors: tuple = (("flat_f32", 0.9766), ("flat_int8", 0.9808),
                     ("fused_e4_L48", 0.9438), ("classic_L100", 0.9511))


FULL = World()


def say(phase: str, **fields) -> None:
    """One result line: ``[phase] key=value ...``."""
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def _ms(fn, *args, reps: int = 5) -> float:
    """Median wall ms of ``fn(*args)`` to completion, after one warm call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(1000.0 * (time.perf_counter() - t0))
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(n_cards: int = 1) -> dict:
    """Require ``n_cards`` GPUs; print what JAX and nvidia-smi report."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform}"
                         f" ({devs[0].device_kind}); this smoke test never "
                         "falls back to the CPU")
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    from mysteryann_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    say("device", platform=devs[0].platform,
        kind=json.dumps(devs[0].device_kind), count=len(devs),
        jax=jax.__version__)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": smi[0].strip()}


# ---------------------------------------------------------------------------
# phase 2: data
# ---------------------------------------------------------------------------

def phase_data(w: World) -> dict:
    """The bench world (seed 7), eval queries (query_seed 8), exact GT."""
    from mysteryann_tpu.io import make_cross_modal
    from mysteryann_tpu.ops import compute_ground_truth
    world = dict(n_concepts=w.n_concepts, intrinsic_dim=w.intrinsic_dim,
                 noise=w.noise)
    t0 = time.perf_counter()
    base, train_q = make_cross_modal(w.n_base, w.n_train, w.dim,
                                     metric="ip", seed=7, **world)
    eval_q = make_cross_modal(1, w.n_eval, w.dim, metric="ip", seed=7,
                              query_seed=8, **world)[1]
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt_i, gt_d = compute_ground_truth(eval_q, base, k=K, metric="ip",
                                      query_batch=min(w.batch, w.n_eval),
                                      base_tile=131072)
    t_gt = time.perf_counter() - t0
    gt_i = gt_i.astype(np.int64)
    if not (np.isfinite(gt_d).all() and gt_i.shape == (w.n_eval, K)
            and gt_i.min() >= 0 and gt_i.max() < w.n_base):
        raise AssertionError("ground truth is malformed")
    say("data", base=base.shape, train=train_q.shape, eval=eval_q.shape,
        gen_s=f"{t_gen:.1f}", gt_s=f"{t_gt:.1f}")
    return dict(base=base, train_q=train_q, eval_q=eval_q, gt_i=gt_i,
                gt_d=gt_d)


# ---------------------------------------------------------------------------
# phase 3: build
# ---------------------------------------------------------------------------

def build_config(w: World, engine: str = "auto"):
    from mysteryann_tpu.utils.params import BuildConfig
    return BuildConfig(M_sq=w.knn_k, M_pjbp=w.M_pjbp, L_pjpq=w.L_pjpq,
                       metric="ip", query_batch=w.batch,
                       search_batch=w.batch,
                       connectivity_passes=w.passes,
                       connectivity_expand=w.build_expand,
                       connectivity_bits=w.build_bits,
                       connectivity_engine=engine)


def phase_build(w: World, data: dict, workdir: str, card: str):
    """kNN + build in this process; save, then load through the registry."""
    from mysteryann_tpu import get_index_cls
    from mysteryann_tpu.graph import build_roargraph
    from mysteryann_tpu.ops import exact_knn
    t0 = time.perf_counter()
    _, knn = exact_knn(data["train_q"], data["base"], k=w.knn_k,
                       metric="ip", query_batch=min(w.batch, w.n_train),
                       base_tile=131072, precision="highest")
    t_knn = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_roargraph(data["base"], data["train_q"], knn,
                            build_config(w), verbose=True)
    t_build = time.perf_counter() - t0
    path = os.path.join(workdir, "roargraph.index")
    index.save(path)
    loaded = get_index_cls("roargraph").load(path)
    if not np.array_equal(np.asarray(loaded.graph.neighbors),
                          np.asarray(index.graph.neighbors)):
        raise AssertionError("index did not survive save/load")
    st = loaded.graph.degree_stats()
    say("build", knn_s=f"{t_knn:.1f}", build_s=f"{t_build:.1f}",
        degree_avg=f"{st['avg']:.1f}", degree_max=st["max"],
        zero=st["zero"], card=json.dumps(card))
    return loaded, path


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def _score(name: str, r: dict, data: dict, floors: dict, card: str) -> float:
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr
    ids, dists = np.asarray(r["ids"]), np.asarray(r["dists"])
    if ids.shape != (data["eval_q"].shape[0], K) or \
            not np.isfinite(dists).all():
        raise AssertionError(f"{name}: malformed result {ids.shape}")
    recall = compute_recall(ids, data["gt_i"], K)
    rderr = compute_rderr(dists, data["gt_d"], K, "ip")
    say("serve", mode=name, recall=f"{recall:.4f}", rderr=f"{rderr:.6f}",
        qps=f"{r['qps']:.0f}", cmps=f"{r.get('avg_cmps', 0):.0f}",
        hops=f"{r.get('avg_hops', 0):.1f}", card=json.dumps(card))
    if name in floors and recall < floors[name]:
        raise AssertionError(f"{name}: recall {recall:.4f} under the "
                             f"floor {floors[name]}")
    return recall


def run_cli(w: World, data: dict, index_path: str, workdir: str,
            floors: dict) -> float:
    """``msann-search-roargraph`` through its ``main(argv)``, in-process."""
    from mysteryann_tpu.cli import search_roargraph
    from mysteryann_tpu.io import write_fbin
    from mysteryann_tpu.io.formats import write_gt_with_dist
    base_p = os.path.join(workdir, "base.fbin")
    q_p = os.path.join(workdir, "query.fbin")
    gt_p = os.path.join(workdir, "gt.bin")
    csv_p = os.path.join(workdir, "cli.csv")
    write_fbin(base_p, data["base"])
    write_fbin(q_p, data["eval_q"])
    write_gt_with_dist(gt_p, data["gt_i"].astype(np.uint32), data["gt_d"])
    rc = search_roargraph.main([
        "--base_data_path", base_p, "--query_path", q_p, "--gt_path", gt_p,
        "--projection_index_save_path", index_path, "--dist", "ip",
        "--k", str(K), "--L_pq", str(w.classic_L),
        "--query_batch", "2048", "--csv_path", csv_p])
    if rc != 0:
        raise AssertionError(f"msann-search-roargraph returned {rc}")
    with open(csv_p) as f:
        rows = f.read().strip().splitlines()
    recall = float(rows[-1].split(",")[4])
    say("serve", mode="cli_classic", L=w.classic_L, recall=f"{recall:.4f}")
    floor = floors.get(f"classic_L{w.classic_L}")
    if floor is not None and recall < floor:
        raise AssertionError(f"cli: recall {recall:.4f} under {floor}")
    return recall


def phase_serve(w: World, data: dict, index, index_path: str, workdir: str,
                card: str) -> dict:
    """Every serving mode against the exact GT; returns the fused engine
    and the recalls."""
    import jax
    from mysteryann_tpu.flat import FlatIndex
    from mysteryann_tpu.search import Searcher
    from mysteryann_tpu.search.fused import FusedSearcher
    floors = dict(w.floors)
    base, eval_q = data["base"], data["eval_q"]
    recalls = {}
    for prec in ("f32", "bf16", "int8"):
        flat = FlatIndex(base, metric="ip", precision=prec, oversample=2)
        r = flat.benchmark(eval_q, k=K, query_batch=min(w.batch, w.n_eval))
        recalls[f"flat_{prec}"] = _score(f"flat_{prec}", r, data, floors,
                                         card)
        del flat
    fused = FusedSearcher(index, base, seed_sample=w.seed_sample,
                          max_degree=w.max_degree, bits=8)
    for expand, seeds, L in w.fused_rows:
        r = fused.benchmark(eval_q, k=K, L=L, query_batch=w.batch,
                            expand=expand, seeds=min(seeds, L))
        name = f"fused_e{expand}_L{L}"
        recalls[name] = _score(name, r, data, floors, card)
    searcher = Searcher(index, base)
    r = searcher.benchmark(eval_q, k=K, L=w.classic_L,
                           query_batch=w.n_eval, visited_mode="pool",
                           expand=2)
    name = f"classic_L{w.classic_L}"
    recalls[name] = _score(name, r, data, floors, card)
    del searcher
    recalls["cli_classic"] = run_cli(w, data, index_path, workdir, floors)
    jax.block_until_ready(fused.table)
    return {"fused": fused, "recalls": recalls}


# ---------------------------------------------------------------------------
# phase 5: kernels
# ---------------------------------------------------------------------------

def check_selection(w: World, data: dict, card: str) -> None:
    """`min_k` against `lax.top_k` on the same f32 score block at each
    width: values must agree EXACTLY (both select from one array), and
    every returned position must hold its value (ties may pick other
    positions). The reference runs on row blocks of at most 2^30
    elements: XLA's GPU sort-based top-k fails on a block of 2^31
    (8192 x 262144) with an overflowed dimension size."""
    import jax
    import jax.numpy as jnp
    from mysteryann_tpu.ops.knn import min_k
    base = jnp.asarray(data["base"])
    q = jnp.asarray(data["train_q"][: w.batch])
    for width in w.select_widths:
        width = min(width, w.n_base)
        s = jax.block_until_ready(-(q @ base[:width].T))  # [B, width] f32
        for k in (K, 2 * K, w.knn_k):
            f_ours = jax.jit(lambda x, k=k: min_k(x, k))
            f_ref = jax.jit(lambda x, k=k: jax.lax.top_k(-x, k))
            v, p = f_ours(s)
            rows = max(1, (1 << 30) // width)
            nv = np.concatenate([np.asarray(f_ref(s[r: r + rows])[0])
                                 for r in range(0, s.shape[0], rows)])
            if not np.array_equal(np.asarray(v), -nv):
                raise AssertionError(f"min_k values differ at {width}/{k}")
            held = np.take_along_axis(np.asarray(s), np.asarray(p), axis=1)
            if not np.array_equal(held, np.asarray(v)):
                raise AssertionError(f"min_k positions wrong at {width}/{k}")
            say("select", width=width, k=k, tol="exact f32",
                precision="matmul DEFAULT (block shared by both)",
                min_k_ms=f"{_ms(f_ours, s):.2f}",
                top_k_ms=f"{_ms(f_ref, s[:rows]) * s.shape[0] / rows:.2f}",
                card=json.dumps(card))
        del s


def check_gathers(data: dict, fused, card: str) -> None:
    """`jnp.take` on the fused byte table and on the f32 base against
    independent references, with its rate beside a plain copy of the
    same bytes."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    table = fused.table
    n_rows = table.shape[0]
    n_idx = min(32768, n_rows)
    idx = jnp.asarray(rng.integers(0, n_rows, n_idx, dtype=np.int32))
    take = jax.jit(lambda t, i: jnp.take(t, i, axis=0))
    got = take(table, idx)
    n_ref = min(2048, n_idx)
    ref = jax.jit(lambda t, i: jax.lax.map(
        lambda r: jax.lax.dynamic_index_in_dim(t, r, keepdims=False), i))(
        table, idx[:n_ref])
    if not np.array_equal(np.asarray(got[:n_ref]), np.asarray(ref)):
        raise AssertionError("fused-table gather differs from row slices")
    copy = jax.jit(lambda t, s: jax.lax.dynamic_slice_in_dim(t, s, n_idx, 0))
    nbytes = got.size * got.dtype.itemsize
    t_take = _ms(take, table, idx)
    t_copy = _ms(copy, table, jnp.int32(0))
    say("gather", table="fused_u8", shape=tuple(table.shape),
        rows=idx.shape[0], tol="exact",
        take_gbs=f"{nbytes / t_take / 1e6:.1f}",
        copy_gbs=f"{nbytes / t_copy / 1e6:.1f}", card=json.dumps(card))
    base = jnp.asarray(data["base"])
    rows = min(8192 * 20, base.shape[0])
    idx = rng.integers(0, base.shape[0], rows, dtype=np.int32)
    got = take(base, jnp.asarray(idx))
    if not np.array_equal(np.asarray(got), data["base"][idx]):
        raise AssertionError("f32 row gather differs from numpy")
    nbytes = got.size * 4
    t_take = _ms(take, base, jnp.asarray(idx))
    copy = jax.jit(lambda t, s: jax.lax.dynamic_slice_in_dim(t, s, rows, 0))
    t_copy = _ms(copy, base, jnp.int32(0))
    say("gather", table="base_f32", shape=tuple(base.shape),
        rows=idx.shape[0], tol="exact",
        take_gbs=f"{nbytes / t_take / 1e6:.1f}",
        copy_gbs=f"{nbytes / t_copy / 1e6:.1f}", card=json.dumps(card))


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes}"
            f" temp={m.temp_size_in_bytes}"
            f" code={m.generated_code_size_in_bytes}")


def _hlo_op(line: str) -> str:
    """Result type, opcode and backend target of one compiled HLO line."""
    _, rhs = line.split(" = ", 1)
    rtype, rest = rhs.split(" ", 1)
    out = f"{rtype} {rest.split('(', 1)[0]}"
    for key in ("custom_call_target=", "kind=", '"kind":'):
        if key in rest:
            out += " " + rest.split(key, 1)[1].split(",", 1)[0]
    return out


def check_compiled(w: World, data: dict, fused) -> None:
    """Memory analyses of the flat scan step and of one fused beam batch,
    and the op the s8 x s8 -> s32 scan lowers to."""
    import jax.numpy as jnp
    from mysteryann_tpu.flat import flat_tile
    from mysteryann_tpu.ops.distances import Metric
    from mysteryann_tpu.ops.knn import (exact_knn_device,
                                        int8_global_knn_device,
                                        quantize_global_int8,
                                        quantize_rows_int8)
    from mysteryann_tpu.search.fused import _fused_beam
    base = jnp.asarray(data["base"])
    q = jnp.asarray(data["eval_q"][: min(w.batch, w.n_eval)])
    tile = min(flat_tile(q.shape[0]), w.n_base)
    c = exact_knn_device.lower(q, base, k=K, metric=Metric.IP,
                               tile=tile).compile()
    say("memory", step="flat_f32_scan", batch=q.shape[0], tile=tile,
        analysis=_mem(c))
    expand, seeds, L = w.fused_rows[0]
    seed_ids = jnp.zeros((q.shape[0], seeds), jnp.int32)
    seed_d = jnp.zeros((q.shape[0], seeds), jnp.float32)
    c = _fused_beam.lower(
        fused.table, fused.base, fused.eps, q, k=K, L=L, metric=fused.metric,
        max_hops=4 * L + 32, n_base=fused.n_base, M=fused.M, d=fused.d,
        visited_mode="merge", expand=expand, seed_ids=seed_ids,
        seed_d=seed_d, bits=fused.bits).compile()
    say("memory", step="fused_beam_batch", batch=q.shape[0], L=L,
        analysis=_mem(c))
    base_i8, _ = quantize_global_int8(base)
    q_i8, _ = quantize_rows_int8(q)
    hlo = int8_global_knn_device.lower(q_i8, base_i8, k=2 * K,
                                       tile=tile).compile().as_text()
    ops = sorted({_hlo_op(line) for line in hlo.splitlines()
                  if '/dot_general"' in line and " = " in line
                  and any(f" {op}(" in line
                          for op in ("dot", "fusion", "custom-call"))})
    for op in ops:
        say("int8_dot", op=json.dumps(op))
    if not ops:
        raise AssertionError("no s8 x s8 -> s32 op found in the int8 scan")


def run_gpu_tests() -> None:
    """The tests marked ``gpu``, in this process (the card is held here)."""
    import pytest
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "test_gpu.py")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", tests])
    say("gpu_tests", exit_code=int(rc))
    if rc != 0:
        raise AssertionError(f"gpu tests failed (pytest exit {int(rc)})")


def phase_kernels(w: World, data: dict, served: dict, card: str) -> None:
    import jax
    check_selection(w, data, card)
    check_gathers(data, served["fused"], card)
    check_compiled(w, data, served["fused"])
    stats = jax.devices()[0].memory_stats() or {}
    say("memory", peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        bytes_limit=stats.get("bytes_limit"))


# ---------------------------------------------------------------------------
# sharded kNN, fused serving and build against one card
# ---------------------------------------------------------------------------

def _same_knn(d_a, i_a, d_b, i_b, what: str) -> None:
    """Same kNN up to near-ties: distances within 1e-5 relative (full f32
    matmuls whose summation order may differ between tile shapes), and
    ids equal except where such a tie reorders them (at most 1e-3)."""
    if not np.allclose(d_a, d_b, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"{what}: distances differ")
    frac = float((i_a != i_b).mean())
    say("sharded", check=what, id_mismatch=f"{frac:.2e}",
        tol="1e-5 rel, precision HIGHEST")
    if frac > 1e-3:
        raise AssertionError(f"{what}: {frac:.2e} of ids differ")


# the sharded build against one card on GPUs: 4x H100 at 1M read .997174
# and .997260 of rows identical, recall 1e-4 apart (PERF.md)
BUILD_ROWS = 0.995
BUILD_RECALL = 0.002


def run_sharded(w: World, card: str, cards: int = 4) -> None:
    """Sharded kNN, fused serving and build on a dp=1 x mp=``cards``
    mesh, each against one card on the same data. The kNN may swap ids
    at near-ties (its tiles differ); fused serving must be identical, as
    its module promises. The build must keep ``BUILD_ROWS`` of its
    adjacency rows identical and its recall within ``BUILD_RECALL``
    (parallel/sharded_build.py says why GPUs part at near-ties); on the
    CPU it is identical."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mysteryann_tpu.graph import build_roargraph
    from mysteryann_tpu.ops.knn import exact_knn_device
    from mysteryann_tpu.parallel import make_mesh, sharded_build_roargraph
    from mysteryann_tpu.parallel.sharded_fused import ShardedFusedSearcher
    from mysteryann_tpu.parallel.sharded_knn import sharded_exact_knn
    from mysteryann_tpu.search.fused import FusedSearcher
    from mysteryann_tpu.utils.metrics import compute_recall

    mesh = make_mesh(dp=1, mp=cards)
    data = phase_data(w)
    base, train_q = data["base"], data["train_q"]
    base_1 = jax.device_put(base, jax.devices()[0])
    base_4 = jax.device_put(base, NamedSharding(mesh, P("mp", None)))

    # sharded exact kNN of the training queries vs one card
    t_sh = t_one = 0.0
    knn_1 = np.empty((w.n_train, w.knn_k), np.int32)
    knn_4 = np.empty_like(knn_1)
    d_1 = np.empty((w.n_train, w.knn_k), np.float32)
    d_4 = np.empty_like(d_1)
    for s in range(0, w.n_train, w.batch):
        e = min(s + w.batch, w.n_train)
        qb = np.zeros((w.batch, w.dim), np.float32)
        qb[: e - s] = train_q[s:e]
        t0 = time.perf_counter()
        d, i = jax.block_until_ready(sharded_exact_knn(
            mesh, jnp.asarray(qb), base_4, k=w.knn_k, tile=131072,
            precision="highest"))
        t_sh += time.perf_counter() - t0
        d_4[s:e], knn_4[s:e] = np.asarray(d)[: e - s], np.asarray(i)[: e - s]
        t0 = time.perf_counter()
        d, i = jax.block_until_ready(exact_knn_device(
            jax.device_put(qb, jax.devices()[0]), base_1, k=w.knn_k,
            tile=131072, precision="highest"))
        t_one += time.perf_counter() - t0
        d_1[s:e], knn_1[s:e] = np.asarray(d)[: e - s], np.asarray(i)[: e - s]
    _same_knn(d_4, knn_4, d_1, knn_1, "knn")
    say("sharded", stage="knn", sharded_s=f"{t_sh:.1f}",
        one_card_s=f"{t_one:.1f}", card=json.dumps(card))
    knn = knn_1
    del base_1, base_4

    # the one-card classic build: the reference for the sharded build and
    # the graph both fused engines serve
    cfg = build_config(w, engine="classic")
    t0 = time.perf_counter()
    one = build_roargraph(base, train_q, knn, cfg, verbose=True)
    t_one = time.perf_counter() - t0

    # mp-sharded fused serving vs the one-card fused engine, same graph
    expand, seeds, L = w.fused_rows[0]
    kw = dict(seed_sample=w.seed_sample, max_degree=w.max_degree, bits=8)
    single = FusedSearcher(one, base, **kw)
    r1 = single.search(data["eval_q"], k=K, L=L, expand=expand, seeds=seeds,
                       query_batch=w.n_eval)
    del single
    sfs = ShardedFusedSearcher(mesh, one, base, **kw)
    # nothing the sharded engine holds may sit wholly on the first card
    for name in ("table", "base_sh"):
        n_dev = len(getattr(sfs, name).sharding.device_set)
        if n_dev != cards:
            raise AssertionError(f"sharded {name} is on {n_dev} device(s)")
    used = [(d.memory_stats() or {}).get("bytes_in_use")
            for d in jax.devices()[:cards]]
    say("sharded", stage="placement", table_devices=cards,
        base_devices=cards, bytes_in_use=used)
    r4 = sfs.search(data["eval_q"], k=K, L=L, expand=expand, seeds=seeds)
    del sfs
    rec = [compute_recall(np.asarray(r[0]), data["gt_i"], K) for r in (r1, r4)]
    same = (np.asarray(r1[0]) == np.asarray(r4[0])).all(axis=1).mean()
    same_d = bool(np.array_equal(np.asarray(r1[1]), np.asarray(r4[1])))
    say("sharded", stage="fused", queries_identical=f"{same:.6f}",
        dists_identical=same_d, recall_one=f"{rec[0]:.4f}",
        recall_sharded=f"{rec[1]:.4f}", tol="identical ids and distances")
    if same != 1.0 or not same_d:
        raise AssertionError("sharded fused serving differs from one card")

    # the sharded build vs the one-card build (the exactness contract of
    # parallel/sharded_build.py), after its primitives one by one
    split_phases(mesh, w, data, knn, one, cfg)
    t0 = time.perf_counter()
    sh = sharded_build_roargraph(mesh, base, train_q, knn, cfg, verbose=True)
    t_sh = time.perf_counter() - t0
    a, b = np.asarray(one.graph.neighbors), np.asarray(sh.graph.neighbors)
    if a.shape != b.shape or one.graph.ep != sh.graph.ep:
        raise AssertionError("sharded build differs in shape or entry")
    rows = float((a == b).all(axis=1).mean())
    rec = [_classic_recall(w, g, data) for g in (one, sh)]
    say("sharded", stage="build", identical=bool(rows == 1.0),
        rows_equal=f"{rows:.6f}", ep_equal=True,
        recall_one=f"{rec[0]:.4f}", recall_sharded=f"{rec[1]:.4f}",
        tol=f"rows >= {BUILD_ROWS}, recall within {BUILD_RECALL}",
        one_card_s=f"{t_one:.1f}", sharded_s=f"{t_sh:.1f}",
        card=json.dumps(card))
    if rows < BUILD_ROWS or abs(rec[0] - rec[1]) > BUILD_RECALL:
        raise AssertionError("sharded build differs from the one-card build")


def split_phases(mesh, w: World, data: dict, knn: np.ndarray, one,
                 cfg) -> None:
    """Each sharded build primitive against its one-card twin on the same
    inputs: phase A's prune of one query batch, then a phase-D search
    batch over the one-card graph and the prune of its pool. Prints the
    share of identical rows of each, so a build that parts from the
    one-card build shows where."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mysteryann_tpu.graph.roargraph import (_batched_prune_rows,
                                                _prune_batch)
    from mysteryann_tpu.ops.distances import Metric
    from mysteryann_tpu.parallel.sharded_build import sharded_prune_rows
    from mysteryann_tpu.parallel.sharded_search import (
        distributed_beam_search)
    from mysteryann_tpu.search.beam import beam_search

    def same(x, y) -> str:
        return f"{float((np.asarray(x) == np.asarray(y)).all(axis=1).mean()):.6f}"

    n, M, ip = w.n_base, w.M_pjbp, Metric.IP
    base_1 = jax.device_put(data["base"], jax.devices()[0])
    base_sh = jax.device_put(data["base"], NamedSharding(mesh, P("mp", None)))
    qb = cfg.query_batch
    tgt = knn[:qb, 0].astype(np.int32)
    cand = np.where(knn[:qb] == tgt[:, None], n, knn[:qb]).astype(np.int32)
    a1 = _batched_prune_rows(base_1, tgt, cand, M, ip, qb, fill=True)
    a4 = sharded_prune_rows(mesh, base_sh, tgt, cand, M, ip, qb, fill=True,
                            n=n)
    nb = np.asarray(one.graph.neighbors)
    eps = jnp.asarray([one.graph.ep], jnp.int32)
    hw = cfg.history_mult * cfg.L_pjpq
    sb = cfg.search_batch
    kw = dict(k=1, L=cfg.L_pjpq, metric=ip, visited_mode="pool",
              collect_expanded=hw, expand=cfg.connectivity_expand)
    r1 = beam_search(base_1, jnp.asarray(nb), eps, base_1[:sb], **kw)
    r4 = distributed_beam_search(
        mesh, base_sh, jax.device_put(nb, NamedSharding(mesh, P("mp", None))),
        eps, data["base"][:sb], **kw)
    pool = np.asarray(r1.hist_ids)
    ids = np.arange(sb, dtype=np.int32)
    pb = _prune_batch(cfg, n)
    d1 = _batched_prune_rows(base_1, ids, pool, M, ip, pb, fill=False)
    d4 = sharded_prune_rows(mesh, base_sh, ids, pool, M, ip, pb, fill=False,
                            n=n)
    say("sharded", stage="split", prune_a_rows=same(a1, a4),
        search_d_pools=same(r1.hist_ids, r4.hist_ids),
        search_d_dists=same(r1.hist_d, r4.hist_d),
        prune_d_rows=same(d1, d4), mp=mesh.shape["mp"])


def _classic_recall(w: World, index, data: dict) -> float:
    """recall@10 of a graph through the classic engine at the smoke's
    classic row (one card)."""
    from mysteryann_tpu.search import Searcher
    from mysteryann_tpu.utils.metrics import compute_recall
    ids = Searcher(index, data["base"]).search(
        data["eval_q"], k=K, L=w.classic_L, query_batch=w.n_eval,
        visited_mode="pool", expand=2)[0]
    return compute_recall(ids, data["gt_i"], K)

# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on 4 cards against the "
                        "one-card results")
    args = p.parse_args(argv)
    w = FULL
    dev = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        run_sharded(w, dev["card"])
    else:
        data = phase_data(w)
        with tempfile.TemporaryDirectory() as workdir:
            index, path = phase_build(w, data, workdir, dev["card"])
            served = phase_serve(w, data, index, path, workdir, dev["card"])
        phase_kernels(w, data, served, dev["card"])
        run_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
