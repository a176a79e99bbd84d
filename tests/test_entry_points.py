"""Entry-point plumbing: the compile-cache helper, the CLI's backend and
dtype switches, and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from magics_tpu import cli
from magics_tpu.compile_cache import CHECKOUT_CACHE, enable_compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_dir_config():
    """Restore jax_compilation_cache_dir after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(CHECKOUT_CACHE)
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def _config_updates(monkeypatch) -> list:
    """Record jax.config.update calls from cli.main without applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


@pytest.mark.parametrize("choice, platform", [("gpu", "cuda"), ("cpu", "cpu")])
def test_cli_platform_choice(monkeypatch, capsys, choice, platform):
    calls = _config_updates(monkeypatch)
    assert cli.main(["--platform", choice, "--dump-default", "config"]) == 0
    assert ("jax_platforms", platform) in calls


def test_cli_rejects_other_platforms(capsys):
    assert sorted(cli.PLATFORMS) == ["cpu", "gpu"]
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "rocm", "--dump-default", "config"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv, x64", [
    (["--dtype", "f64"], True),
    (["--dtype", "f64", "--platform", "cpu"], True),
    (["--dtype", "f32"], False),
])
def test_cli_f64_enables_x64_with_or_without_platform(
    monkeypatch, capsys, argv, x64
):
    calls = _config_updates(monkeypatch)
    assert cli.main(argv + ["--dump-default", "config"]) == 0
    assert (("jax_enable_x64", True) in calls) == x64


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout
