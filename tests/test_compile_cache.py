"""The persistent compile-cache helper (sparsetpu.bench.configure_cache)."""

import os
import subprocess
import sys

import jax

import sparsetpu.bench as b

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(monkeypatch):
    """Capture jax.config updates instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_set_leaves_directory_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record(monkeypatch)
    assert b.configure_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_env_var_unset_uses_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record(monkeypatch)
    path = b.configure_cache()
    assert calls["jax_compilation_cache_dir"] == path
    assert path == os.path.join(ROOT, ".jax_cache")


def test_path_stable_across_processes(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    code = "import sparsetpu.bench as b; print(b.CACHE_DIR)"
    outs = {subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                           capture_output=True, text=True,
                           check=True).stdout.strip()
            for cwd in (ROOT, str(tmp_path))}
    assert outs == {os.path.join(ROOT, ".jax_cache")}
