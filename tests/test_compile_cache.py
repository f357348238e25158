"""The persistent compile cache lands where JAX_COMPILATION_CACHE_DIR says,
and otherwise in the checkout's git-ignored .jax_cache directory."""
import os

import jax
import pytest

from fastertransformer4codefuse_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("from_env", [True, False])
def test_cache_dir(from_env, tmp_path, monkeypatch, restore_cache_config):
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
        want = str(tmp_path / "cc")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(root, ".jax_cache")
    assert compile_cache.enable() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
