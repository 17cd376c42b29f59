"""Compile-cache location rule (mpc_cbf_tpu.utils.runtime)."""
import pytest

from mpc_cbf_tpu.utils import runtime


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_dir_rule(env, monkeypatch, tmp_path):
    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
        assert runtime.compile_cache_dir() == str(tmp_path / "cache")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        # a fixed directory inside the checkout, the same in every process
        path = runtime.compile_cache_dir()
        assert path == str(runtime.DEFAULT_CACHE_DIR)
        assert path.endswith("/.jax_cache")
        assert (runtime.DEFAULT_CACHE_DIR.parent / "mpc_cbf_tpu").is_dir()
