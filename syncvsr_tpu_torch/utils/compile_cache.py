"""Where the port keeps its compiled kernels (the counterpart of the JAX
package's ``utils/compile_cache.py``, which points XLA's persistent cache).

The port's one compiled artefact is the ``nvcc`` build of the hand-written
kernels (``utils/kernels.py``), a shared library keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
as built. ``SYNCVSR_COMPILE_CACHE``, the JAX package's variable, sets where:

* unset (or empty, or ``1``): ``build/syncvsr_tpu_torch/`` at the
  repository root (``DEFAULT_ROOT``; the ``.gitignore`` lists ``build/``);
* ``0``: a fresh temporary directory for each process, removed when it
  exits, so every process compiles anew;
* any other value: that directory, made where it is missing.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

ENV = "SYNCVSR_COMPILE_CACHE"
DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build" / "syncvsr_tpu_torch"

_fresh: Optional[Path] = None   # this process's directory under ENV=0


def build_root() -> Path:
    """The directory the kernel library is built into and loaded from, by
    ``SYNCVSR_COMPILE_CACHE`` (read at each call)."""
    global _fresh
    env = os.environ.get(ENV, "")
    if env in ("", "1"):
        return DEFAULT_ROOT
    if env == "0":
        if _fresh is None:
            _fresh = Path(tempfile.mkdtemp(prefix="syncvsr_kernels_"))
            atexit.register(shutil.rmtree, _fresh, True)
        return _fresh
    return Path(env).expanduser().resolve()
