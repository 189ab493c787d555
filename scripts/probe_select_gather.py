"""Probe: what `chip_smoke.py` does not time — selection variants at the
flat shapes, and the row gathers' index mode end to end.

``select`` times, on the first device, ways of reducing an 8192 x T f32
score block (T in 64k/128k/256k) to its k smallest, the matmul included,
beyond the `min_k` / `lax.top_k` pair the smoke already times:

- ``two_stage``  : top-k inside 1024-column chunks, then top-k of those;
- ``approx``     : `lax.approx_min_k` (a sort fallback on the GPU), where
                   it fits;
- ``matmul_min`` : matmul + row minimum, a floor for any selection;

then the f32 matmul alone per precision (and the op it compiles to), and
the full 1M scans per 8192-query batch at each tile.

``take_mode`` builds the smoke's 1M index and times the seeded fused
engine and the classic engine with every `jnp.take` forced to
``mode="fill"`` or ``mode="clip"`` (runs in the order fill, clip, clip,
fill; median of 5 timed searches each). The callers clamp their ids, so
both modes return the same results; the probe checks that.

Prints one JSON object per measurement.

    PYTHONPATH=. python scripts/probe_select_gather.py [select] [take_mode]

(both parts when none is named).
"""

from __future__ import annotations

import json
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from mysteryann_tpu.ops.distances import Metric
from mysteryann_tpu.ops.knn import (exact_knn_device, int8_global_knn_device,
                                    quantize_global_int8, quantize_rows_int8)

B, N, D = 8192, 1_000_000, 128


def emit(**row):
    print(json.dumps(row), flush=True)


def two_stage(s, k, c=1024):
    b, t = s.shape
    g = s.reshape(b, t // c, c)
    nv, pos = jax.lax.top_k(-g, k)                        # [b, t/c, k]
    pos = pos + (jnp.arange(t // c, dtype=jnp.int32) * c)[None, :, None]
    nv2, p2 = jax.lax.top_k(nv.reshape(b, -1), k)
    return -nv2, jnp.take_along_axis(pos.reshape(b, -1), p2, axis=1)


VARIANTS = {
    "two_stage": two_stage,
    "approx": lambda s, k: jax.lax.approx_min_k(s, k),
    "matmul_min": lambda s, k: jnp.min(s, axis=1),
}


def main():
    card = cs.phase_device()["card"]
    emit(card=card)
    parts = sys.argv[1:] or ["select", "take_mode"]
    if "select" in parts:
        select_part()
    if "take_mode" in parts:
        take_mode_part()


def select_part():
    kq, kb = jax.random.split(jax.random.key(0))
    base = jax.random.normal(kb, (N, D), jnp.float32)
    base = base / jnp.linalg.norm(base, axis=1, keepdims=True)
    q = jax.random.normal(kq, (B, D), jnp.float32)
    for t in (65536, 131072, 262144):
        for k in (20, 64):
            for name, sel in VARIANTS.items():
                f = jax.jit(lambda q, b, sel=sel, k=k: sel(-(q @ b.T), k))
                try:
                    emit(select=name, tile=t, k=k,
                         ms=round(cs._ms(f, q, base[:t]), 3))
                except Exception as e:  # noqa: BLE001 — report, go on
                    emit(select=name, tile=t, k=k,
                         error=f"{type(e).__name__}: {str(e)[:200]}")
    # the f32 matmul alone, per precision, and the op it compiles to
    for prec in ("default", "high", "highest"):
        f = jax.jit(lambda q, b, prec=prec: jnp.min(jnp.dot(
            q, b.T, precision=prec, preferred_element_type=jnp.float32),
            axis=1))
        emit(matmul="f32", precision=prec, tile=262144,
             ms=round(cs._ms(f, q, base[:262144]), 3))
        g = jax.jit(lambda q, b, prec=prec: jnp.dot(
            q, b.T, precision=prec, preferred_element_type=jnp.float32))
        hlo = g.lower(q, base[:262144]).compile().as_text()
        emit(matmul="f32", precision=prec, hlo=[
            line.strip()[:240] for line in hlo.splitlines()
            if "custom-call" in line or "fusion(" in line
            or " dot(" in line][:4])
        emit(matmul="f32_full_block", precision=prec, tile=262144,
             ms=round(cs._ms(g, q, base[:262144]), 3))
    f = jax.jit(lambda q, b: jnp.min(jnp.dot(
        q.astype(jnp.bfloat16), b.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32), axis=1))
    emit(matmul="bf16", tile=262144,
         ms=round(cs._ms(f, q, base[:262144]), 3))
    q_i8, _ = quantize_rows_int8(q)
    base_i8, _ = quantize_global_int8(base)
    base_bf = base.astype(jnp.bfloat16)
    for t in (65536, 131072, 262144):
        emit(scan="f32", tile=t, k=10, ms=round(cs._ms(
            lambda: exact_knn_device(q, base, k=10, metric=Metric.IP,
                                     tile=t)), 3))
        emit(scan="bf16", tile=t, k=20, ms=round(cs._ms(
            lambda: exact_knn_device(q.astype(jnp.bfloat16), base_bf, k=20,
                                     metric=Metric.IP, tile=t)), 3))
        emit(scan="int8", tile=t, k=20, ms=round(cs._ms(
            lambda: int8_global_knn_device(q_i8, base_i8, k=20, tile=t)), 3))


def take_mode_part(w: cs.World = cs.FULL):
    from mysteryann_tpu.search import Searcher
    from mysteryann_tpu.search.fused import FusedSearcher
    data = cs.phase_data(w)
    with tempfile.TemporaryDirectory() as workdir:
        index, _ = cs.phase_build(w, data, workdir, "")
    fused = FusedSearcher(index, data["base"], seed_sample=w.seed_sample,
                          max_degree=w.max_degree, bits=8)
    classic = Searcher(index, data["base"])
    q = jnp.asarray(data["eval_q"])
    expand, seeds, L = w.fused_rows[0]
    runs = {
        f"fused_e{expand}_L{L}": lambda: fused.search(
            q, k=cs.K, L=L, query_batch=w.batch, expand=expand,
            seeds=seeds, device_out=True),
        f"classic_L{w.classic_L}": lambda: classic.search(
            q, k=cs.K, L=w.classic_L, query_batch=w.n_eval,
            visited_mode="pool", expand=2, device_out=True),
    }
    take = jnp.take
    first = {}
    try:
        for mode in ("fill", "clip", "clip", "fill"):
            jnp.take = lambda *a, mode_=mode, **k: take(
                *a, **dict(k, mode=mode_))
            jax.clear_caches()
            for name, fn in runs.items():
                ms = cs._ms(fn)
                ids = np.asarray(fn()[0])
                same = bool(np.array_equal(first.setdefault(name, ids), ids))
                emit(take_mode=mode, engine=name,
                     qps=round(w.n_eval / ms * 1000.0, 1), ms=round(ms, 3),
                     same_ids_as_first=same)
    finally:
        jnp.take = take


if __name__ == "__main__":
    main()
