"""Batch JPEG decoding on the host (port of ``syncvsr_tpu/data/jpeg.py``).

The native decoder (``syncvsr_tpu_torch/native/jpeg_batch.cpp``, a copy of
the JAX package's, on libjpeg) decodes every frame of a clip in one ctypes
call with a pool of worker threads. It is compiled with ``g++`` at first
use into ``build/syncvsr_tpu_torch/jpeg/<source hash>/`` at the repository
root. Where it cannot be built or loaded, ``cv2.imdecode`` decodes the
frames; where neither exists, ``decode_gray_batch`` raises, naming what is
missing. It never returns blank frames.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "jpeg_batch.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "syncvsr_tpu_torch" / "jpeg"
_CMD = ["g++", "-O3", "-shared", "-fPIC"]
_LIBS = ["-ljpeg", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_why_not: Optional[str] = None    # why the native decoder is unavailable


def _build() -> Path:
    """The built library (compiled now if this source has no build yet)."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CMD + _LIBS).encode())
    lib = _BUILD_ROOT / digest.hexdigest()[:16] / "libjpegbatch.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([*_CMD, "-o", str(tmp), str(_SRC), *_LIBS],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed: {(out.stderr or out.stdout).strip()[-400:]}")
    os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The native decoder, built and loaded once; None (with the reason in
    ``_why_not``) where it cannot be."""
    global _lib, _why_not
    with _lock:
        if _lib is not None or _why_not is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _why_not = f"the native decoder is unavailable ({e})"
            return None
        lib.decode_gray_batch.restype = ctypes.c_int
        lib.decode_gray_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def jpeg_dimensions(buf: bytes) -> Tuple[int, int]:
    """(height, width) from JPEG SOF markers, no decode."""
    i = 2
    n = len(buf)
    while i + 9 < n:
        if buf[i] != 0xFF:
            i += 1
            continue
        marker = buf[i + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = (buf[i + 5] << 8) | buf[i + 6]
            w = (buf[i + 7] << 8) | buf[i + 8]
            return h, w
        length = (buf[i + 2] << 8) | buf[i + 3]
        i += 2 + length
    raise ValueError("no SOF marker found")


def _decode_cv2(jpegs: Sequence[bytes], height: int, width: int, why: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"no JPEG decoder: {why}, and cv2 is not installed") from None
    frames = []
    for b in jpegs:
        img = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError("jpeg decode failed")
        f = np.zeros((height, width), np.uint8)
        h = min(img.shape[0], height)
        w = min(img.shape[1], width)
        f[:h, :w] = img[:h, :w]
        frames.append(f)
    return np.stack(frames)[..., None]


def decode_gray_batch(jpegs: Sequence[bytes], height: Optional[int] = None,
                      width: Optional[int] = None,
                      num_threads: int = 0) -> np.ndarray:
    """Decode a list of grayscale JPEGs -> uint8 [N, H, W, 1] (frames of
    another size are zero-padded or cropped at the bottom and right)."""
    if not jpegs:
        raise ValueError("empty jpeg list")
    if height is None or width is None:
        height, width = jpeg_dimensions(jpegs[0])

    lib = _load()
    if lib is None:
        return _decode_cv2(jpegs, height, width, _why_not)
    n = len(jpegs)
    out = np.empty((n, height, width), np.uint8)
    bufs = (ctypes.c_char_p * n)(*jpegs)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in jpegs])
    threads = num_threads or min(os.cpu_count() or 1, 8)
    rc = lib.decode_gray_batch(bufs, sizes, n, out.ctypes.data_as(ctypes.c_void_p),
                               height, width, threads)
    if rc == 0:
        return out[..., None]
    return _decode_cv2(jpegs, height, width, f"libjpeg failed on frame {rc - 1}")


def native_available() -> bool:
    return _load() is not None
