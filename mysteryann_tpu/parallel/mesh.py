"""Device mesh helpers.

The reference's only parallelism is OpenMP threads over one shared memory
(SURVEY §2: omp parallel for + per-node std::mutex). The device scaling
axes are:

- ``dp`` (data parallel): independent queries/build-nodes sharded across
  devices — the analogue of the reference's query fan-out
  (tests/test_search_roargraph.cpp:203-209);
- ``mp`` (model parallel): the base-vector table + adjacency tensor sharded
  across device memory — the analogue RoarGraph *doesn't have*
  (single-node DRAM); required for T2I-100M-class corpora.

Cross-shard candidate exchange is psum/all_gather inside shard_map,
which XLA hands to NCCL. Within one host the cards are joined all to all
by NVLink, so any ``mp`` layout over them costs the same; the mesh
follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(dp: int = 1, mp: int = 1, devices=None,
              allow_split_mp: bool = False) -> Mesh:
    """dp x mp mesh with ``mp`` packed along consecutive devices.

    Consecutive devices share a host (JAX orders `jax.devices()` by
    process), so filling ``mp`` first keeps the per-hop psums (neighbor
    rows + partial distances) on the host's NVLink and lets ``dp`` —
    which never communicates during a search — span hosts over the
    network (see docs/ARCHITECTURE.md "Multi-host meshes"). An ``mp``
    axis that would straddle hosts turns every expansion into a network
    round trip; that is refused unless ``allow_split_mp=True``
    (>400M-corpus territory).
    """
    devices = devices if devices is not None else jax.devices()
    if dp * mp > len(devices):
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, "
                         f"have {len(devices)}")
    use = devices[: dp * mp]
    n_proc = len({d.process_index for d in use})
    if n_proc > 1 and not allow_split_mp:
        per_host = len(use) // n_proc
        if mp > per_host or per_host % mp:
            raise ValueError(
                f"mp={mp} would straddle hosts ({per_host} devices/host): "
                "per-hop psums would cross the network. Lay mp within a "
                "host, or pass allow_split_mp=True if the corpus truly "
                "exceeds one host's device memory.")
    dev = np.asarray(use).reshape(dp, mp)
    return Mesh(dev, axis_names=("dp", "mp"))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join (or start) a multi-host JAX cluster.

    Thin, idempotent wrapper over ``jax.distributed.initialize``: on a
    managed cluster the three arguments may come from the environment
    and be ``None``; for a manual bring-up (or the CPU smoke test,
    tests/test_multihost.py) pass them explicitly. After this returns,
    ``jax.devices()`` is the GLOBAL device list — every process must
    then call :func:`make_mesh` with identical arguments.

    Safe to call twice: a second call with a live client is a no-op.

    ORDERING: like ``jax.distributed.initialize`` itself, this must run
    before anything initializes the XLA backend (first jit, device_put,
    ``jax.devices()`` — and therefore before importing modules that do
    any of those at import time).
    """
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh_distributed(dp: int = 0, mp: int = 1,
                          coordinator: str | None = None,
                          num_processes: int | None = None,
                          process_id: int | None = None) -> Mesh:
    """Multi-host mesh: initialize the cluster, then lay ``mp`` within
    hosts and ``dp`` across them.

    Base + adjacency shard over ``mp`` *inside* each host (per-hop
    psums stay on NVLink), while ``dp`` — whose shards never exchange
    data during a search, only at the final result concat — is the axis
    that crosses the network. ``dp=0`` means "all remaining devices":
    ``dp = len(jax.devices()) // mp``.

    Traffic budget (why this layout; docs/ARCHITECTURE.md "Multi-host
    meshes" carries the derivation): per beam expansion the ``mp`` psums
    move ~[B, M]·(4+4) bytes (neighbor row + partial distances) — at
    B=8192, M=32 that is ~2 MB per hop, ~0.6 GB per L=300 query batch —
    cheap on NVLink (450 GB/s each way per H100), slow over a network of
    tens of Gb/s. The ``dp`` axis moves only the [B, k] results once per
    batch (~KBs) — a network is fine there.
    """
    init_distributed(coordinator, num_processes, process_id)
    devices = jax.devices()
    if dp == 0:
        dp = max(1, len(devices) // mp)
    return make_mesh(dp=dp, mp=mp, devices=devices)


def shard_base(mesh: Mesh, x, axis: str = "mp"):
    """Shard a [N, ...] array's leading dim across the given mesh axis."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))
