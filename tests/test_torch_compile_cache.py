"""PyTorch port: ``SYNCVSR_COMPILE_CACHE`` sets where the kernel library is
built and loaded from (``utils/compile_cache.py``, the counterpart of the
JAX package's persistent XLA cache): unset, the repository's
``build/syncvsr_tpu_torch``; ``0``, a fresh temporary directory for the
process; a path, that directory. ``kernels.build`` reuses a library it
finds under the root for the sources' hash, so no ``nvcc`` is needed."""

import os
from pathlib import Path

import pytest

from syncvsr_tpu_torch.utils import compile_cache, kernels

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(compile_cache, "_fresh", None)
    return monkeypatch


@pytest.mark.parametrize("value", [None, "", "1"])
def test_unset_is_the_repository_build_directory(fresh, value):
    if value is None:
        fresh.delenv(compile_cache.ENV, raising=False)
    else:
        fresh.setenv(compile_cache.ENV, value)
    assert compile_cache.build_root() == REPO / "build" / "syncvsr_tpu_torch"


def test_zero_is_a_fresh_directory_for_the_process(fresh):
    fresh.setenv(compile_cache.ENV, "0")
    root = compile_cache.build_root()
    assert root.is_dir() and not any(root.iterdir())
    assert not root.is_relative_to(REPO)
    assert compile_cache.build_root() == root      # one directory a process


def test_a_path_is_that_directory(fresh, tmp_path):
    fresh.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    assert compile_cache.build_root() == tmp_path / "cache"


@pytest.mark.parametrize("setting", ["path", "0"])
def test_build_reuses_the_library_under_the_root(fresh, tmp_path, setting):
    """A library already built for these sources under the root is loaded
    as built (no compiler runs); a root without one would need nvcc."""
    fresh.setenv(compile_cache.ENV, str(tmp_path / "cache") if setting == "path" else "0")
    root = compile_cache.build_root()
    lib = root / kernels._digest() / kernels.LIB_NAME
    fresh.setattr(kernels, "_nvcc", lambda: pytest.fail("nvcc was called"))
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert kernels.build() == (lib, "")
    os.remove(lib)
    fresh.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    with pytest.raises(RuntimeError, match="no nvcc"):
        kernels.build()
