"""High-level query API over a built index.

Equivalent of the reference's search drivers: load index + base, then
``SearchRoarGraph`` per query (reference src/index_bipartite.cpp:2311-2420,
driven by tests/test_search_roargraph.cpp:203-209). Here a Searcher holds
device-resident base vectors + adjacency and streams fixed-shape query
batches through the jitted lockstep beam search.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mysteryann_tpu.ops.distances import Metric, prepare_vectors
from mysteryann_tpu.search.beam import beam_search, run_query_batches
from mysteryann_tpu.search.seeding import make_seed_sample, seed_scan

if TYPE_CHECKING:  # avoid circular import (graph.roargraph uses search.beam)
    from mysteryann_tpu.graph.roargraph import RoarGraphIndex


class Searcher:
    def __init__(self, index: "RoarGraphIndex", base: np.ndarray,
                 seed_sample: int = 0):
        """``seed_sample=r`` keeps a strided 1-in-r bf16 base sample
        resident for per-query entry-point scans (`search(seeds=S)`) —
        see search.seeding."""
        self.metric = index.metric
        self.base = prepare_vectors(base, self.metric)   # device
        self.neighbors = jnp.asarray(index.graph.neighbors)
        self.eps = jnp.asarray([index.graph.ep], jnp.int32)
        self._samp = (make_seed_sample(self.base, seed_sample)
                      if seed_sample else None)

    def search(
        self, queries: np.ndarray, k: int, L: int,
        query_batch: int = 1024, expand: int = 1,
        visited_mode: str = "bitmask", device_out: bool = False,
        seeds: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Returns (ids [Q,k], dists [Q,k], cmps [Q], hops [Q]).

        Queries stay device-resident between batches — no host round trip.
        ``device_out=True`` leaves results on device.
        """
        if seeds and self._samp is None:
            raise ValueError("seeds > 0 needs Searcher(seed_sample=r)")
        if seeds > L:
            raise ValueError(f"seeds ({seeds}) must be <= L ({L})")
        if not isinstance(queries, jax.Array):
            queries = np.asarray(queries, np.float32)
        q = prepare_vectors(queries, self.metric)
        nq, d = q.shape
        qb = min(query_batch, nq)

        def run(qs):
            seed_ids = None
            if seeds:
                # seed_d stays None: the scan's distances carry
                # bf16-matmul error and (unlike the fused engine) there
                # is no final rerank here — beam_search rescores the
                # seeds in f32, so reported dists stay exact
                seed_ids, _ = seed_scan(
                    *self._samp, qs, n_seeds=seeds, metric=self.metric)
            r = beam_search(self.base, self.neighbors, self.eps, qs,
                            k=k, L=L, metric=self.metric, expand=expand,
                            visited_mode=visited_mode, seed_ids=seed_ids)
            return r.ids, r.dists, r.cmps, r.hops

        return run_query_batches(q, nq, qb, run, device_out)

    def benchmark(self, queries: np.ndarray, k: int, L: int,
                  query_batch: int = 1024, warmup: int = 1,
                  expand: int = 1, visited_mode: str = "bitmask",
                  seeds: int = 0) -> dict:
        """Timed sweep entry — the reference driver's per-L_pq row
        (tests/test_search_roargraph.cpp:190,231-236). Device-timed:
        queries staged in device memory before timing (reference: in
        RAM), results blocked on device and downloaded outside the timed
        region."""
        q = prepare_vectors(np.asarray(queries, np.float32), self.metric)
        qb = min(query_batch, q.shape[0])
        for _ in range(warmup):  # the timed call itself (see FlatIndex)
            jax.block_until_ready(self.search(
                q, k, L, query_batch=qb, expand=expand,
                visited_mode=visited_mode, device_out=True, seeds=seeds))
        t0 = time.perf_counter()
        out = self.search(q, k, L, query_batch=qb, expand=expand,
                          visited_mode=visited_mode, device_out=True,
                          seeds=seeds)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        ids, dists, cmps, hops = (np.asarray(o) for o in out)
        return {
            "L_pq": L, "k": k,
            "qps": q.shape[0] / dt,
            "avg_cmps": float(cmps.mean()),
            "avg_hops": float(hops.mean()),
            "mean_latency_ms": 1000.0 * dt / max(1, -(-q.shape[0] // qb)),
            "ids": ids.astype(np.int32), "dists": dists,
        }
