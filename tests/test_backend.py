"""The backend dispatch and what hangs on it: the compile-cache placement,
the memory budget, and the one-process-per-card rule."""

import os
import subprocess
import sys

import jax
import pytest

import biograph_jax
from biograph_jax.runtime import backend as backend_mod
from biograph_jax.runtime.resources import HOST_DEFAULT_BYTES, MemoryBudget

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_backend_is_cpu_here():
    assert backend_mod.backend() == "cpu"
    assert backend_mod.describe().startswith("platform=cpu ")


def test_backend_rejects_unsupported_platform(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend_mod.backend()


def test_compile_cache_dir_follows_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
    assert biograph_jax._compile_cache_dir(env) == "/somewhere/else"


def test_compile_cache_dir_defaults_into_checkout():
    assert biograph_jax._compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")


def test_compile_cache_can_be_disabled():
    assert biograph_jax._compile_cache_dir({"BGT_NO_COMPILE_CACHE": "1"}) is None


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_placement_at_import(tmp_path, env_dir):
    """A fresh interpreter that imports the package compiles into the
    variable's directory when it is set, else into <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "BGT_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import biograph_jax, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


def test_memory_budget_host_default_without_stats(monkeypatch):
    monkeypatch.delenv("BGT_HBM_BUDGET_BYTES", raising=False)
    assert jax.devices()[0].memory_stats() is None  # the CPU backend
    assert MemoryBudget.detect(0.5).bytes == HOST_DEFAULT_BYTES // 2


def test_memory_budget_gpu_without_stats_fails(monkeypatch):
    monkeypatch.delenv("BGT_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.setattr(backend_mod, "backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="bytes_limit"):
        MemoryBudget.detect()


def test_memory_budget_env_override(monkeypatch):
    monkeypatch.setenv("BGT_HBM_BUDGET_BYTES", "12345")
    monkeypatch.setattr(backend_mod, "backend", lambda: "gpu")
    assert MemoryBudget.detect().bytes == 12345


def test_coverage_workers_refused_on_gpu(monkeypatch, tmp_path):
    """coverage --workers 2 must not fan out over processes on the GPU
    backend (each would reserve most of the card)."""
    from biograph_jax import cli

    monkeypatch.setattr(backend_mod, "backend", lambda: "gpu")
    with pytest.raises(ValueError, match="one JAX process per card"):
        cli.main([
            "coverage", "--vcf", str(tmp_path / "in.vcf"),
            "--biograph", str(tmp_path / "s.bgt"), "--ref", str(tmp_path / "ref"),
            "--out", str(tmp_path / "out.vcf"), "--workers", "2",
        ])


def test_chip_smoke_fails_without_gpu(tmp_path):
    """The smoke exits non-zero and prints no result line on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
