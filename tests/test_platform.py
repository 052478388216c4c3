"""The one module that decides what runs on which platform
(core/platform.py), the compile-cache placement (core/compile_cache.py),
and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import igcn_cf.core.platform as plat
from igcn_cf.core import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2**30


def _gpu(monkeypatch, limit_bytes):
    monkeypatch.setattr(plat.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(plat, "device_memory_bytes", lambda: limit_bytes)


def test_cpu_choices_are_the_references():
    assert plat.platform() == "cpu"
    assert plat.graph_engine(29858, 40981, "auto") == "sparse"
    assert not plat.use_pcache(29858, 40981, 3, "auto")
    assert not plat.pcache_ab()
    assert plat.pcache_kernel() == "xla"
    assert not plat.use_sharded_pcache(29858, 40981, 4, "auto")
    assert plat.use_sharded_pcache(100, 100, 4, "host")
    assert plat.memory_budget_bytes() is None  # the CPU reports no limit


def test_gpu_choices_follow_memory(monkeypatch):
    _gpu(monkeypatch, 60 * GIB)
    assert plat.graph_engine(29858, 40981, "auto") == "sparse"
    assert plat.pcache_kernel() == "triton"
    assert plat.pcache_ab()
    assert plat.use_pcache(29858, 40981, 3, "auto")  # ~10 GB P
    assert not plat.use_pcache(52643 * 2, 91599 * 2, 3, "auto")
    assert not plat.use_sharded_pcache(29858, 40981, 4, "auto")
    with pytest.raises(ValueError, match="per device"):
        plat.use_sharded_pcache(300000, 300000, 4, True)
    # a 16 GB card's budget leaves the Gowalla-shaped P out
    _gpu(monkeypatch, 16 * GIB)
    assert not plat.use_pcache(29858, 40981, 3, "auto")


def test_memory_budget_reserve(monkeypatch):
    _gpu(monkeypatch, 60 * GIB)
    assert plat.memory_budget_bytes() == 48 * GIB  # 20% reserve
    _gpu(monkeypatch, 20 * GIB)
    assert plat.memory_budget_bytes() == 12 * GIB  # at least 8 GiB reserve


def test_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(plat.jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported"):
        plat.platform()
    with pytest.raises(RuntimeError):
        plat.graph_engine(10, 10, "auto")
    with pytest.raises(RuntimeError):
        plat.pcache_kernel()
    with pytest.raises(RuntimeError):
        plat.use_pcache(10, 10, 3, "auto")


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert compile_cache.compile_cache_dir() == str(tmp_path / "jc")


def test_compile_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.compile_cache_dir()
    assert d == os.path.join(REPO, ".cache", "xla")
    assert compile_cache.state_dir() == os.path.join(REPO, ".cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_the_cpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_needs_the_program(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
