"""Memory-sized choices (phase-D engine, flat scan tile) and the
persistent compilation cache's directory."""

import pytest

import mysteryann_tpu.utils.memory as memory
from mysteryann_tpu.flat import flat_tile
from mysteryann_tpu.graph.roargraph import _resolve_engine
from mysteryann_tpu.utils.params import BuildConfig


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _with_device(monkeypatch, stats):
    monkeypatch.setattr(memory.jax, "devices", lambda: [_Dev(stats)])


@pytest.mark.parametrize("limit,engine", [(64 << 30, "fused"),
                                          (4 << 30, "classic")])
def test_resolve_engine_from_device_memory(monkeypatch, limit, engine):
    """The 1M bench recipe's packed table (~5.1 GB at bits 4) takes the
    fused engine on a card that reports 64 GB and the classic one on a
    card that reports 4 GB."""
    _with_device(monkeypatch, {"bytes_limit": limit})
    cfg = BuildConfig(M_sq=64, M_pjbp=32, L_pjpq=128,
                      connectivity_bits=4)
    assert _resolve_engine(cfg, 1_000_000, 128) == engine


def test_memory_budget_falls_back_to_host_constant(monkeypatch):
    _with_device(monkeypatch, None)
    assert memory.device_memory_bytes() == memory.HOST_MEMORY_BYTES
    _with_device(monkeypatch, {"bytes_in_use": 1})
    assert memory.device_memory_bytes() == memory.HOST_MEMORY_BYTES


@pytest.mark.parametrize("limit,tile", [(64 << 30, 262144),
                                        (16 << 30, 131072),
                                        (1 << 30, 8192)])
def test_flat_tile_fits_a_quarter_of_memory(monkeypatch, limit, tile):
    _with_device(monkeypatch, {"bytes_limit": limit})
    got = flat_tile(8192)
    assert got == tile
    assert 8192 * got * 4 <= limit // 4


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """`enable_compile_cache` uses $JAX_COMPILATION_CACHE_DIR when set,
    else <repo>/.cache/jax, and sets no other directory."""
    import os
    import jax
    from mysteryann_tpu.utils import cache
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(os, "makedirs", lambda p, exist_ok=False: None)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(repo, ".cache", "jax")
    cache.enable_compile_cache()
    assert calls["jax_compilation_cache_dir"] == want
