"""Where the persistent compilation cache lives."""

import pathlib

import pytest

from gs360x.kernels import jaxsetup

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    calls = {}
    monkeypatch.setattr(jaxsetup, "_configured", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_dir_is_used_alone(monkeypatch, tmp_path, updates):
    target = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    monkeypatch.delenv("GS360X_NO_JAX_CACHE", raising=False)
    jaxsetup.enable_persistent_cache()
    assert updates["jax_compilation_cache_dir"] == str(target)
    assert target.is_dir()


def test_default_dir_is_fixed_and_ignored(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("GS360X_NO_JAX_CACHE", raising=False)
    jaxsetup.enable_persistent_cache()
    path = pathlib.Path(updates["jax_compilation_cache_dir"])
    assert path == REPO / ".jax_cache" == jaxsetup.DEFAULT_CACHE_DIR
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_opt_out_sets_nothing(monkeypatch, updates):
    monkeypatch.setenv("GS360X_NO_JAX_CACHE", "1")
    jaxsetup.enable_persistent_cache()
    assert updates == {}
