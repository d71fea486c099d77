"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``kernels/csrc`` expose a plain C interface, so they
compile without PyTorch's headers: one ``nvcc -c`` per source, all started
together, then one link into a shared library.  The library lands in
``<root>/<hash>/`` at first use, the root being ``utils.cache.build_root()``
(``feathercnn_tpu_torch/_build/`` unless ``compilation_cache_dir`` or
``FEATHERCNN_TPU_CACHE`` names another); the hash covers the sources and
the flags, so an edited source rebuilds and an unchanged one loads the
library already there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..utils.cache import build_root

__all__ = ["load_library", "library_dir", "build_log", "nvcc_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("matmul_epilogue.cu", "conv_implicit_gemm.cu",
            "depthwise_conv.cu", "fused_chain.cu", "fused_chain_float.cu",
            "ident.cu", "eltwise_int8.cu", "stem_conv.cu")
_HEADERS = ("gemm_common.cuh", "wgmma_ops.cuh")
# -split-compile 0: each source's kernels go through the device compiler
# in parallel (the int8 GEMM's wgmma instantiations take ~10-25 s each).
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile", "0")
_LIB_NAME = "libfcnn_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# (name, argtypes): pointers and the stream as c_void_p, or ctypes would
# pass a Python int as a 32-bit int and cut the pointer.
_SIGNATURES = {
    "fcnn_matmul_epilogue": [_P, _P, _P, _P, _P, _P, _P,      # x w out b w_scale lo hi
                             _I, _I, _I, _I, _I, _I, _I,      # M K N xt wt ot act
                             _F, _F,                          # x_scale out_scale
                             _I, _I, _I, _I, _I, _I, _I,      # plan: variant bn bk stages
                             _I, _I, _I, _I, _I,              #   bres grid smem split th tw
                                                              #   ldw sst
                             _P, _P],                         # ws stream
    "fcnn_conv_implicit_gemm": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I,   # N H W C KH KW Co
                                _I, _I, _I, _I,               # sh sw ph pw
                                _I, _I, _I, _I,               # xt wt ot act
                                _F, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _P, _P],
    # the same with the dilation after pw
    "fcnn_conv_implicit_gemm_dilated": [_P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I,   # sh sw ph pw d
                                        _I, _I, _I, _I,
                                        _F, _F, _I, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P, _P],
    "fcnn_conv_implicit_gemm_grouped": [_P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I,   # sh sw ph pw S
                                        _I, _I, _I, _I,
                                        _F, _F, _I, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P, _P],
    "fcnn_depthwise_conv2d": [_P, _P, _P, _P,                # x w out b
                              _I, _I, _I, _I, _I, _I,        # N H W C KH KW
                              _I, _I, _I, _I,                # sh sw ph pw
                              _I, _I, _I,                    # xt ot act
                              _F,                            # x_scale
                              _I, _I, _I, _I, _I, _I, _I,    # plan (DwPlan)
                              _P],                           # stream
    "fcnn_depthwise_conv2d_int8": [_P, _P, _P, _P, _P,       # x w out b ws
                                   _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I,
                                   _I, _I,                   # ot act
                                   _F,                       # out_scale
                                   _I, _I, _I, _I, _I, _I, _I,  # plan
                                   _P],                      # stream
    "fcnn_fused_block": [_P, _P,                             # x out
                         _P, _P, _P, _P, _P, _P,             # w1 b1 w1s w2 b2 w2s
                         _P, _P, _P,                         # w3 b3 w3s
                         _I, _I, _I, _I, _I, _I, _I,         # N H W C Cm TH TW
                         _F, _F, _F, _F, _F, _F,             # sx sy1 sy2, 1/sy1 1/sy2 out_scale
                         _I, _I,                             # shortcut_fma ot
                         _I, _I, _I, _I, _I,                 # plan: variant T stages smem grid
                         _P],                                # stream
    "fcnn_fused_block_float": [_P, _P,                       # x out
                               _P, _P, _P, _P, _P, _P,       # w1 b1 w2 b2 w3 b3
                               _I, _I, _I, _I, _I, _I, _I,   # N H W C Cm TH TW
                               _I, _I,                       # xt ot
                               _I, _I, _I, _I, _I, _I, _I,   # plan (ChainPlan)
                               _P],                          # stream
    "fcnn_ident": [_P, _P, _L, _I, _P],                      # x out chunk_bytes chunks stream
    "fcnn_eltwise_int8": [_P, _P, _P, _L, _L, _L, _L,        # x0 x1 out n c ld0 ld1
                          _F, _F, _F, _I,                    # s0 s1 y_inv act
                          _P],                               # stream
    "fcnn_stem_conv": [_P, _P, _P, _P,                       # x wk bias out
                       _I, _I, _I, _I, _I, _I, _I,           # N H W C KH KW Co
                       _I, _I, _I, _I,                       # sh sw ph pw
                       _I, _I,                               # th act
                       _F,                                   # out_scale
                       _P],                                  # stream
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``.  Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        f"{_CSRC} at first use and need the CUDA toolkit (set CUDA_HOME "
        "or put nvcc on PATH)")


def _flags(defines) -> tuple:
    return _FLAGS + tuple(f"-D{d}" for d in defines)


def _source_hash(defines=()) -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path, defines=()) -> None:
    nvcc = nvcc_path()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        procs = []
        for src in _SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            cmd = [nvcc, *_flags(defines), "-c", str(_CSRC / src), "-o",
                   str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            log.append(f"== nvcc -c {src} (rc {p.returncode})\n{out}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = tmp / _LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-Xcompiler", "-fPIC", *objs, "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== nvcc -shared (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / _LIB_NAME).exists():   # lost a race: keep theirs
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def library_dir(defines: tuple = ()) -> Path:
    """The directory the library of the current sources and ``defines`` is
    (or will be) built in, under ``utils.cache.build_root()``."""
    return build_root() / _source_hash(defines)


@functools.lru_cache(maxsize=None)
def load_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library,
    once per process: a later change of the build root keeps the library
    loaded.  ``defines`` (``"NAME"`` or ``"NAME=value"``) build a library
    of their own beside it, as ``tools/float_chain_probe.py`` asks for one
    with ``FCNN_FLOAT_PROBE``."""
    out_dir = library_dir(defines)
    if not (out_dir / _LIB_NAME).exists():
        _build(out_dir, defines)
    lib = ctypes.CDLL(str(out_dir / _LIB_NAME))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """The compiler's output of the current build (registers, shared
    memory and spills per kernel, from ``-Xptxas -v``)."""
    path = library_dir() / "build.log"
    return path.read_text() if path.exists() else ""
