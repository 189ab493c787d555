"""Multi-host mesh smoke test — two real processes.

The T2I-100M config needs a multi-host mesh, so this test brings up a
REAL two-process JAX cluster over localhost gRPC (the same
``jax.distributed`` path a multi-host cluster uses over its network),
with 4 virtual CPU devices per process:

- ``make_mesh_distributed`` lays ``mp`` within each "host" and ``dp``
  across them (the layout whose traffic budget is derived in
  docs/ARCHITECTURE.md "Multi-host meshes");
- a ``shard_map`` psum over ``dp`` crosses the process boundary — the
  collective that crosses the network in production;
- ``make_mesh`` must REFUSE an ``mp`` axis that would straddle hosts
  (per-hop psums over the network are the slow layout).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import numpy as np
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")

port = os.environ["MSANN_PORT"]
pid = int(os.environ["MSANN_PID"])
# initialize BEFORE importing anything that may touch the backend
# (mysteryann_tpu import probes the native lib; play it safe — this is
# also the production bring-up order)
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

sys.path.insert(0, os.environ["MSANN_REPO"])
from mysteryann_tpu.parallel.mesh import make_mesh, make_mesh_distributed

mesh = make_mesh_distributed(dp=2, mp=4, coordinator=f"localhost:{port}",
                             num_processes=2, process_id=pid)
assert len(jax.devices()) == 8, jax.devices()
assert mesh.shape == {"dp": 2, "mp": 4}, mesh.shape

# every device of one dp row must live on one process (mp inside a host)
rows = np.asarray(mesh.devices)
for r in range(2):
    procs = {d.process_index for d in rows[r]}
    assert len(procs) == 1, f"dp row {r} straddles processes: {procs}"

# an mp axis straddling hosts must be refused
try:
    make_mesh(dp=1, mp=8)
    raise SystemExit("expected ValueError for host-straddling mp")
except ValueError:
    pass

# the cross-host collective: psum over dp crosses the process boundary
sharding = NamedSharding(mesh, P("dp"))
local = np.full((4, 4), float(pid + 1), np.float32)
garr = jax.make_array_from_process_local_data(sharding, local, (8, 4))
f = jax.jit(shard_map(lambda a: jax.lax.psum(a, "dp"), mesh=mesh,
                      in_specs=P("dp", None), out_specs=P(None, None)))
out = f(garr)
got = np.asarray(out.addressable_shards[0].data)
np.testing.assert_allclose(got, 3.0)  # 1 (proc 0) + 2 (proc 1)
print(f"worker {pid} ok", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_dcn_mesh(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    procs = []
    for pid in range(2):
        env = dict(env_base, MSANN_REPO=repo, MSANN_PORT=str(port),
                   MSANN_PID=str(pid), JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid} ok" in out
