"""The compile-cache helper and the native library's source build."""

import os
import shutil

import jax
import pytest

from clenabled_tpu import native
from clenabled_tpu.runtime import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the helper
    sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.init_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_ignored_path(monkeypatch,
                                                     restore_cache_dir):
    """Without the variable the cache goes to <checkout>/.jax_cache, a
    fixed path that .gitignore lists."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.init_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_native_library_built_into_ignored_dir():
    """The library is built from native/src into native/_build/, which
    .gitignore lists, and nothing built sits beside the sources."""
    assert native.get_lib() is not None, native.build_error()
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path)
    rel = os.path.relpath(native.BUILD_DIR, ROOT) + "/"
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert rel in fh.read().split()
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


def test_native_library_name_follows_source_contents(monkeypatch, tmp_path):
    """A changed source gives a new library path (content hash, not
    mtime), and _build compiles it there."""
    src = tmp_path / "src"
    shutil.copytree(native._SRC_DIR, src)
    monkeypatch.setattr(native, "_SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    first = native.lib_path()
    with open(src / "unpack.cc", "a") as fh:
        fh.write("\n// touched\n")
    second = native.lib_path()
    assert first != second
    assert native._build(second) is None
    assert os.path.exists(second)
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".tmp")]
