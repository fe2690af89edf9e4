"""Build and load the hand-written CUDA kernels (``syncvsr_tpu_torch/csrc``).

Every ``*.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface and loaded with ``ctypes``. The library lands in
``<root>/<hash>/``, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is loaded as built; ``<root>`` is
``compile_cache.build_root()`` (by default ``build/syncvsr_tpu_torch/`` at
the repository root; ``SYNCVSR_COMPILE_CACHE`` moves it). A failed build
raises.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

from syncvsr_tpu_torch.utils.compile_cache import build_root

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libsyncvsr_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as void*)
SIGNATURES = {
    # x, w, b, tok, partials, out, n, d, ldx, slots, vocab, stream
    "sync_ce_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, b, tok, partials, out, n, d, slots, vocab, stream
    "sync_ce_split_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, partials, out, n, c, n_strips, is_bf16, stream
    "bn_stats_fwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    # g, x, mean, inv, partials, out, n, c, n_strips, is_bf16, stream
    "bn_stats_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_scratch = {}         # (name, device) -> (elements, address, buffer)
_ARENA_FLOATS = 1 << 20
_arena = {}           # device -> [next free float, floats, address, buffer]
_retained: Optional[List] = None   # the buffers handed out inside ``retained()``


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Tuple[Path, str]:
    """Compile the sources (in parallel) and link the library; returns its
    path and the compiler's output (empty when an earlier build is reused)."""
    root = build_root()
    out_dir = root / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists() and not force:
        return lib, ""
    nvcc = _nvcc()
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=root))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib, build_log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device or its index), without building a ``torch.cuda.Stream`` object,
    which costs the host more than a small kernel takes."""
    import torch

    idx = device if isinstance(device, int) else device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)


def check(status: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def scratch(name: str, device, numel: int, dtype=None) -> Tuple[int, int, "torch.Tensor"]:
    """(elements, address, buffer) of the per-device buffer ``name``: at
    least ``numel`` elements of ``dtype`` (f32 by default), zero-filled when
    it is allocated, at first use or to grow, and held here, so the caching
    allocator never hands it to another tensor. The kernels that share a
    name run on one stream at a time."""
    import torch

    slot = _scratch.get((name, device))
    if slot is None or slot[0] < numel:
        buf = torch.zeros(numel, device=device, dtype=dtype or torch.float32)
        slot = _scratch[name, device] = (numel, buf.data_ptr(), buf)
    if _retained is not None:
        _retained.append(slot[2])
    return slot


def result(device, floats: int) -> Tuple[int, "torch.Tensor"]:
    """A kernel's f32 result without an allocation a call: (address, a
    fresh [floats] slice of a per-device arena). No float of an arena is
    handed out twice; a full arena is replaced by a new one and stays alive
    while any slice of it does. (An allocation a call costs the host more
    than K3 and K4 take at the Conformer's [1280, 768].)"""
    import torch

    slot = _arena.get(device)
    if slot is None or slot[0] + floats > slot[1]:
        size = max(_ARENA_FLOATS, floats)
        buf = torch.empty(size, device=device, dtype=torch.float32)
        slot = _arena[device] = [0, size, buf.data_ptr(), buf]
    off, _, base, buf = slot
    slot[0] = off + floats
    if _retained is not None:
        _retained.append(buf)
    return base + 4 * off, buf[off:off + floats]


@contextmanager
def retained() -> Iterator[List]:
    """The scratch and arena buffers handed out inside the block, each as
    often as it was. A CUDA graph captured inside bakes their addresses in,
    so its record holds the list: a buffer that a later call replaces (a
    full arena, a scratch grown) is then not freed, nor reused by another
    tensor, while the graph may replay."""
    global _retained
    prev, _retained = _retained, []
    try:
        yield _retained
    finally:
        if prev is not None:
            prev.extend(_retained)
        _retained = prev
