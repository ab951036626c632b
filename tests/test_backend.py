"""backend.py: the one device predicate, the compilation-cache placement,
and a failing accelerator that stops the run instead of falling back."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from floxer_tpu import backend

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_accelerator_predicate(monkeypatch, platform, want):
    monkeypatch.setattr(backend, "ensure_backend", lambda: platform)
    assert backend.accelerator() is want


def _cache_dir_in_child(env_extra: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update({"JAX_PLATFORMS": "cpu", **env_extra})
    code = (
        "import jax; from floxer_tpu.backend import ensure_backend; "
        "ensure_backend(); print(jax.config.jax_compilation_cache_dir)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_cache_dir_defaults_to_checkout():
    assert backend.compilation_cache_dir() == str(REPO / ".jax_cache") or (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
    )
    assert _cache_dir_in_child({}) == str(REPO / ".jax_cache")


def test_cache_dir_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compilation_cache_dir() is None
    assert _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    ) == str(tmp_path)


def test_failing_accelerator_fails_the_run(data_dir, tmp_path):
    """A requested GPU platform that cannot start ends the CLI with an
    error; it never becomes a CPU run that exits 0."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["FLOXER_TPU_PLATFORM"] = "cuda"
    proc = subprocess.run(
        [
            sys.executable, "-m", "floxer_tpu",
            "--reference", str(data_dir / "reference.fasta"),
            "--queries", str(data_dir / "queries.fastq"),
            "--output", str(tmp_path / "out.sam"),
            "--query-errors", "2",
        ],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode != 0
    assert not (tmp_path / "out.sam").exists()
