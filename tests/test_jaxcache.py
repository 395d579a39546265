"""Persistent-compile-cache plumbing (utils/jaxcache.py)."""
import importlib
import os

import jax
import pytest

import vcf2prot_tpu.utils.jaxcache as jaxcache

_TOUCHED = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture
def fresh():
    """The module reloaded (``_DONE`` cleared); every config value it may
    set is restored afterwards."""
    saved = {name: getattr(jax.config, name) for name in _TOUCHED}
    yield importlib.reload(jaxcache)
    for name, val in saved.items():
        jax.config.update(name, val)
    importlib.reload(jaxcache)


@pytest.fixture
def config_updates(monkeypatch):
    """Record every ``jax.config.update`` call (and still apply it)."""
    calls = []
    real = jax.config.update

    def record(name, val):
        calls.append((name, val))
        real(name, val)

    monkeypatch.setattr(jax.config, "update", record)
    return calls


def test_env_dir_wins(fresh, monkeypatch, tmp_path, config_updates):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    module sets no other directory and makes none."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    made = []
    monkeypatch.setattr(fresh.os, "makedirs",
                        lambda p, exist_ok=False: made.append(p))
    fresh.enable_persistent_cache()
    assert "jax_compilation_cache_dir" not in [n for n, _v in config_updates]
    assert made == []
    # the entry floors are still lowered so every compile is cached
    assert ("jax_persistent_cache_min_compile_time_secs", 0) in config_updates


def test_default_is_fixed_repo_path(fresh, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(jaxcache.__file__))))
    assert fresh.default_cache_dir() == os.path.join(repo, ".jax_cache")


def test_no_tempdir_fallback(fresh, monkeypatch, tmp_path, config_updates):
    """Without the env var the cache goes to the repo path and nowhere
    else, whatever the tempdir is."""
    import tempfile

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    made = []
    monkeypatch.setattr(fresh.os, "makedirs",
                        lambda p, exist_ok=False: made.append(p))
    fresh.enable_persistent_cache()
    dirs = [v for n, v in config_updates if n == "jax_compilation_cache_dir"]
    assert made == dirs == [fresh.default_cache_dir()]
    assert not dirs[0].startswith(str(tmp_path))


def test_enable_is_idempotent_and_skips_cpu(fresh, monkeypatch,
                                            config_updates):
    """On the CPU backend (this suite), enabling must be a no-op: XLA:CPU
    AOT cache entries are pinned to the machine's CPU features."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fresh.enable_persistent_cache()
    fresh.enable_persistent_cache()  # idempotent
    assert config_updates == []
    assert fresh._DONE
