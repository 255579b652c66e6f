"""Persistent XLA compilation cache wiring (`tensoralloy_tpu/cache.py`).

The persistent cache makes every serving process after the first start
warm. These tests pin the *wiring* (backend gating, env opt-out,
idempotence, where the cache lives) — the executable reuse itself is a
JAX feature that `chip_smoke.py` reports on the card (compile seconds
and persistent-cache hits).
"""
import importlib
import os
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh():
    import tensoralloy_tpu.cache as c
    importlib.reload(c)
    return c


def _run(code, **env_updates):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_updates)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()


def test_cpu_backend_skipped_by_default():
    c = _fresh()
    assert c.enable_compilation_cache() is False   # conftest pins cpu


def test_env_opt_out(monkeypatch):
    c = _fresh()
    monkeypatch.setenv("TENSORALLOY_NO_CACHE", "1")
    assert c.enable_compilation_cache(include_cpu=True) is False


def test_enable_sets_config_and_is_idempotent(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    c = _fresh()
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setattr(c, "DEFAULT_CACHE_DIR", str(tmp_path / "xla"))
        assert c.enable_compilation_cache(include_cpu=True) is True
        assert jax.config.jax_compilation_cache_dir == \
            str(tmp_path / "xla")
        assert os.path.isdir(tmp_path / "xla")
        # second call is a no-op (does not re-point the cache)
        monkeypatch.setattr(c, "DEFAULT_CACHE_DIR", str(tmp_path / "other"))
        assert c.enable_compilation_cache(include_cpu=True) is True
        assert jax.config.jax_compilation_cache_dir == \
            str(tmp_path / "xla")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_calculator_does_not_initialize_backend_eagerly():
    """The cache hook decides from the configured platform and never
    calls jax.default_backend(), which would initialize a backend as a
    side effect."""
    import inspect
    import tensoralloy_tpu.cache as c
    src = inspect.getsource(c)
    assert "default_backend(" not in src


def test_env_cache_dir_is_honoured_and_not_overwritten(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the hook leaves JAX's own setting
    alone, and compiled executables land there."""
    where = tmp_path / "jaxcache"
    out = _run(
        "import jax, jax.numpy as jnp\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
        " 0)\n"
        "from tensoralloy_tpu.cache import enable_compilation_cache\n"
        "print(enable_compilation_cache(include_cpu=True))\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()"
        "\n",
        JAX_COMPILATION_CACHE_DIR=str(where))
    assert out[0] == "True"
    assert out[1] == str(where)
    assert where.is_dir() and any(where.iterdir())


def test_default_cache_dir_is_fixed_inside_checkout():
    """Unset: one fixed path inside the checkout, the same in every
    fresh process (a cache that moves never hits)."""
    code = ("import jax\n"
            "from tensoralloy_tpu.cache import enable_compilation_cache\n"
            "print(enable_compilation_cache(include_cpu=True))\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    first, second = _run(code), _run(code)
    assert first == second
    assert first[0] == "True"
    assert first[1] == os.path.join(REPO, ".jax_cache")
