"""50M-scale serving: the regime where int8 IVF cluster blocks win.

At 50M x 128d the f32 corpus is 25.6 GB. This script compares two
int8-resident single-device modes on the device-generated
corpus (io/synthetic.py CrossModalDeviceSpec — no host copy of the
corpus ever exists; every row is a function of its index):

  flat-int8: streamed global-int8 quantization into a resident
             [N, d] s8 table (6.4 GB at 50M), full scan per batch
             (ops/knn.int8_global_knn_device).
  ivf-int8:  build_ivf_streaming cluster blocks (~8 GB with capacity
             padding), grouped cluster-major scan at nprobe
             (ivf._ivf_scan_grouped_i8).

Both modes rerank the merged candidate head with exact f32 rows
REGENERATED from ids on device, inside the timed region — reported
distances are exact f32 and recall is vs exact streamed GT.

The reference has no >16M run (its largest is T2I-10M,
run_roargraph_test.sh); this is surface beyond it.

Run: python scripts/bench_50m.py [--n_base 50000000]. One JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".cache", "jax"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "5")
# env var alone is ignored by this JAX build — the config route
# must initialize the cache (utils/cache.py)
from mysteryann_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".bench_cache")
DIM = 128
K = 10
SEED = 23


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_base", type=int, default=50_000_000)
    ap.add_argument("--n_eval", type=int, default=16_384)
    ap.add_argument("--tile", type=int, default=1 << 20)
    ap.add_argument("--query_batch", type=int, default=2048)
    ap.add_argument("--rerank", type=int, default=100)
    ap.add_argument("--nprobes", type=int, nargs="+",
                    default=[32, 64, 128, 256])
    ap.add_argument("--qb_ivf", type=int, default=4096)
    ap.add_argument("--slot_budget", type=int, default=4)
    ap.add_argument("--skip_flat", action="store_true")
    args = ap.parse_args()
    n = args.n_base
    N_EVAL = args.n_eval

    import jax
    import jax.numpy as jnp
    from functools import partial
    from mysteryann_tpu.io.synthetic import CrossModalDeviceSpec
    from mysteryann_tpu.ivf import build_ivf_streaming
    from mysteryann_tpu.ops.knn import (exact_knn_device,
                                        int8_global_knn_device,
                                        quantize_rows_int8)
    from mysteryann_tpu.utils.metrics import compute_recall, compute_rderr

    # v3 world geometry (difficulty calibrated at 1M against the
    # reference binary — BASELINE.md "Workload history"); the
    # device-spec draws are a threefry sibling of the host family
    spec = CrossModalDeviceSpec(DIM, n_concepts=20_000, intrinsic_dim=48,
                                noise=0.85, metric="ip", seed=SEED)
    tile = min(args.tile, n)
    eval_q = spec.rows(jnp.arange(N_EVAL, dtype=jnp.int32), query_side=True)
    eval_q = jax.device_put(eval_q)

    @partial(jax.jit, static_argnames=("k",))
    def merge_topk(bd, bi, nd, ni, k):
        cd = jnp.concatenate([bd, nd], axis=1)
        ci = jnp.concatenate([bi, ni], axis=1)
        # drop duplicate ids before selection (clamped tail windows feed
        # their overlap rows into the merge twice): keep the first copy,
        # push the rest to +inf. Width is 2K, so the pairwise mask is tiny.
        w = ci.shape[1]
        later = jnp.arange(w)[None, :, None] > jnp.arange(w)[None, None, :]
        dup = ((ci[:, :, None] == ci[:, None, :]) & later).any(axis=2)
        cd = jnp.where(dup, jnp.inf, cd)
        neg, pos = jax.lax.top_k(-cd, k)
        return -neg, jnp.take_along_axis(ci, pos, axis=1)

    # ---- exact GT, streamed over generated tiles ---------------------------
    # v2: clamped full-stride windows + id-dedup merge. The previous
    # full-stride-and-mask-after scheme let PHANTOM rows (generator
    # indices >= n in the unclamped tail tile, drawn from the same
    # distribution) win per-tile top-K slots before the gid>=n mask,
    # evicting true tail-resident neighbors from the cached GT.
    os.makedirs(CACHE, exist_ok=True)
    gt_path = os.path.join(CACHE, f"synth50m_v3_{n}_{DIM}_gtv2_{N_EVAL}.npz")
    if os.path.exists(gt_path):
        with np.load(gt_path) as z:
            gt_i, gt_d = z["ids"].astype(np.int64), z["dists"]
    else:
        log("== exact GT (streamed) ==")
        t0 = time.time()
        bd = jnp.full((N_EVAL, K), jnp.inf, jnp.float32)
        bi = jnp.full((N_EVAL, K), n, jnp.int32)
        for it, s in enumerate(range(0, n, tile)):
            st = min(s, n - tile)  # clamped window: one compiled shape,
            rows = spec.base_tile(st, tile)  # no phantom rows ever
            nd, ni = exact_knn_device(eval_q, rows, k=K, metric="ip",
                                      tile=min(tile, 131072),
                                      precision="highest")
            bd, bi = merge_topk(bd, bi, nd, ni + st, K)
            if it % 4 == 3:
                # bound in-flight tiles (same fix as the fill loop —
                # queued generate+scan iterations exhaust memory)
                jax.block_until_ready(bd)
        bd.block_until_ready()
        gt_i, gt_d = np.asarray(bi).astype(np.int64), np.asarray(bd)
        np.savez(gt_path, ids=gt_i, dists=gt_d)
        log(f"GT in {time.time()-t0:.0f}s")

    # exact-f32 rerank via row REGENERATION (no f32 corpus resident)
    @partial(jax.jit, static_argnames=("k",))
    def regen_rerank(q, ids, vals, k):
        flat = jnp.minimum(ids.reshape(-1), n - 1)
        rows = spec.rows(flat).reshape(ids.shape[0], ids.shape[1], DIM)
        ip = jnp.einsum("bd,brd->br", q, rows,
                        preferred_element_type=jnp.float32)
        dist = jnp.where(jnp.isfinite(vals), -ip, jnp.inf)
        neg, pos = jax.lax.top_k(-dist, k)
        return jnp.take_along_axis(ids, pos, axis=1), -neg

    def bench(search_fn, label, qb=None):
        """Device-timed loop over all eval batches; returns row dict."""
        qb = qb or args.query_batch
        if N_EVAL % qb:
            # a clamped last slice would re-run overlap queries (ids
            # outnumber gt rows -> compute_recall broadcast error) and
            # overstate QPS
            raise ValueError(f"n_eval ({N_EVAL}) must divide the query "
                             f"batch ({qb})")
        outs = [search_fn(jax.lax.dynamic_slice_in_dim(eval_q, 0, qb))]
        jax.block_until_ready(outs[0])                  # warmup + compile
        outs = []
        t0 = time.perf_counter()
        for s in range(0, N_EVAL, qb):
            outs.append(search_fn(
                jax.lax.dynamic_slice_in_dim(eval_q, s, qb)))
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        ids = np.concatenate([np.asarray(o[0]) for o in outs])
        dists = np.concatenate([np.asarray(o[1]) for o in outs])
        row = {"mode": label, "qps": round(N_EVAL / dt, 1),
               "recall": round(compute_recall(ids.astype(np.int64),
                                              gt_i, K), 4),
               "rderr": round(compute_rderr(dists, gt_d, K, "ip"), 6)}
        log(row)
        return row

    rows = []

    # ---- IVF int8 (cluster blocks) -----------------------------------------
    log("== ivf-int8 streamed build ==")
    t0 = time.time()
    idx = build_ivf_streaming(spec.base_tile, n, DIM, metric="ip",
                              tile=tile, seed=SEED, rows_fn=spec.rows,
                              assign_cache=os.path.join(CACHE, "synth50m_v3"),
                              verbose=True)
    ivf_build_s = round(time.time() - t0, 1)

    def ivf_search(qs, nprobe):
        ids, vals = idx._search_grouped(qs, k=args.rerank, nprobe=nprobe,
                                        slot_budget=args.slot_budget)
        return regen_rerank(qs, ids, vals, K)

    for p in args.nprobes:
        # large batches amortize the whole-table DMA; shrink for large
        # nprobe to bound the stacked [nc, qmax, kk] candidate tensor
        # (~1.5 GB) next to the 8.3 GB table
        qb_p = max(1024, args.qb_ivf * 64 // max(p, 64))
        r = bench(lambda qs, p=p: ivf_search(qs, p), f"ivf_i8_p{p}",
                  qb=qb_p)
        r["nprobe"] = p
        rows.append(r)
    waste = idx.n_clusters * idx.cap / n
    idx.free()

    # ---- flat int8 (full scan) ---------------------------------------------
    flat_build_s = None
    if args.skip_flat:
        print(json.dumps({"scale": n, "dim": DIM, "n_eval": N_EVAL,
                          "ivf_build_secs": ivf_build_s,
                          "ivf_waste": round(waste, 3),
                          "rerank": args.rerank, "rows": rows}))
        return
    log("== flat-int8 streamed build ==")

    @partial(jax.jit, donate_argnums=(0,))
    def fill(tbl, rows, start, gscale):
        # fused quantize+store: an eager rint/clip chain would stack
        # tile-sized f32 temporaries next to the 6.4 GB table
        r8 = jnp.clip(jnp.rint(rows * gscale), -127, 127).astype(jnp.int8)
        return jax.lax.dynamic_update_slice_in_dim(tbl, r8, start, 0)

    t0 = time.time()
    gmax = 0.0
    for s in range(0, n, tile):          # pass 1: global scale
        st = min(s, n - tile)
        gmax = max(gmax, float(jnp.max(jnp.abs(spec.base_tile(st, tile)))))
    gscale = 127.0 / max(gmax, 1e-30)
    tbl = jnp.zeros((n, DIM), jnp.int8)
    for it, s in enumerate(range(0, n, tile)):   # pass 2: quantize + fill
        st = min(s, n - tile)
        tbl = fill(tbl, spec.base_tile(st, tile), st, gscale)
        if it % 4 == 3:
            np.asarray(tbl[0, 0])        # bound in-flight tiles
    np.asarray(tbl[0, 0])
    flat_build_s = round(time.time() - t0, 1)
    log(f"flat-int8 table in {flat_build_s}s")

    def flat_search(qs):
        q_i8, _ = quantize_rows_int8(qs)
        _, ii = int8_global_knn_device(q_i8, tbl, k=args.rerank, tile=131072)
        vals = jnp.zeros(ii.shape, jnp.float32)  # ids-only scan; all valid
        return regen_rerank(qs, jnp.maximum(ii, 0), vals, K)

    r = bench(flat_search, "flat_i8")
    rows.append(r)

    print(json.dumps({"scale": n, "dim": DIM, "n_eval": N_EVAL,
                      "ivf_build_secs": ivf_build_s,
                      "ivf_waste": round(waste, 3),
                      "flat_build_secs": flat_build_s,
                      "rerank": args.rerank, "rows": rows}))


if __name__ == "__main__":
    main()
