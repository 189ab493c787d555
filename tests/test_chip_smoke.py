"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to
run without a GPU."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = chip_smoke.World(
    n_base=3000, n_train=600, n_eval=200, dim=32, n_concepts=40,
    intrinsic_dim=8, noise=0.5, knn_k=16, M_pjbp=8, L_pjpq=32, passes=1,
    build_expand=2, build_bits=8, batch=256, seed_sample=2, max_degree=16,
    fused_rows=((2, 8, 24),), classic_L=32, select_widths=(1024, 2600),
    floors=(("flat_f32", 0.99), ("flat_bf16", 0.95), ("flat_int8", 0.95),
            ("fused_e2_L24", 0.8), ("classic_L32", 0.8)))


def test_phases_at_tiny_size(tmp_path, capsys):
    data = chip_smoke.phase_data(TINY)
    index, path = chip_smoke.phase_build(TINY, data, str(tmp_path), "cpu")
    served = chip_smoke.phase_serve(TINY, data, index, path, str(tmp_path),
                                    "cpu")
    chip_smoke.phase_kernels(TINY, data, served, "cpu")
    rec = served["recalls"]
    assert set(rec) == {"flat_f32", "flat_bf16", "flat_int8",
                        "fused_e2_L24", "classic_L32", "cli_classic"}
    assert rec["flat_f32"] == 1.0
    # the CLI serves the classic engine at the same L: same recall band
    assert abs(rec["cli_classic"] - rec["classic_L32"]) < 0.05
    out = capsys.readouterr().out
    for tag in ("[data]", "[build]", "[serve]", "[select]", "[gather]",
                "[memory]", "[int8_dot]"):
        assert tag in out, tag
    assert '"ok"' not in out


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr
    assert np.all([not line.startswith("{") for line in
                   r.stdout.splitlines()])


def test_sharded_phase_on_four_virtual_devices(capsys):
    """The four-card phase on four of the CPU's virtual devices: the
    sharded kNN, fused serving and build agree with one device."""
    chip_smoke.run_sharded(TINY, "cpu", cards=4)
    out = capsys.readouterr().out
    for stage in ("knn", "placement", "fused", "split", "build"):
        assert f"stage={stage}" in out, stage
    assert "identical=True" in out
