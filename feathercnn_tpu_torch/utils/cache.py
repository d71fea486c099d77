"""The directory the port builds its native code into — counterpart of
``feathercnn_tpu/utils/cache.py``.

The reference's expensive start-up step is XLA/Mosaic compilation, and
``enable_persistent_cache`` points JAX's compilation cache at a directory
so that later processes reuse the compiled executables.  The port runs
eagerly and compiles nothing per model: what it compiles is its own code,
the CUDA kernels (``kernels/build.py``, ``nvcc``, ~30-55 s) and the C++
runtime (``native.py``, ``g++``, ~1.5 s), each at first use into a
directory named after the hash of its sources and flags.  That root
directory is the port's persistent cache: a process that finds a library
of the same hash there loads it and builds nothing.

The root is, in order: the argument of :func:`enable_persistent_cache`
(``EngineConfig(compilation_cache_dir=...)`` passes its value), the
environment variable ``FEATHERCNN_TPU_CACHE``, or
``feathercnn_tpu_torch/_build/`` beside the package.  Each library is
loaded once per process: a later call that names another directory changes
where a library not loaded yet is built, and leaves the loaded ones as
they are.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["enable_persistent_cache", "build_root"]

_DEFAULT = Path(__file__).resolve().parent.parent / "_build"
_ENV = "FEATHERCNN_TPU_CACHE"
_root: Optional[Path] = None


def build_root() -> Path:
    """The directory the kernels' and the native runtime's libraries are
    built into and loaded from: the last :func:`enable_persistent_cache`
    directory, else ``$FEATHERCNN_TPU_CACHE``, else the package's
    ``_build/``."""
    if _root is not None:
        return _root
    env = os.environ.get(_ENV)
    return Path(env).expanduser() if env else _DEFAULT


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Make ``path`` (else ``$FEATHERCNN_TPU_CACHE``, else the package's
    ``_build/``) the build directory of this process, creating it; returns
    it.  Idempotent.  A library already loaded in this process stays
    loaded from where it was."""
    global _root
    root = Path(path or os.environ.get(_ENV) or _DEFAULT).expanduser()
    root.mkdir(parents=True, exist_ok=True)
    _root = root.resolve()
    return str(_root)
