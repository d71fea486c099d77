"""ctypes bindings for the native runtime — counterpart of
``feathercnn_tpu/native.py`` over the port's own C++ sources
(``native_csrc/``: the ``.ftpu`` mmap loader, the continuous-batching
queue and the image preprocessing).

The library is built at first use with the host's C++ compiler (``$CXX``,
else ``g++``) into ``<root>/native-<hash>/`` (the root as for the CUDA
kernels, ``utils.cache.build_root()``: ``feathercnn_tpu_torch/_build/``
unless ``compilation_cache_dir`` or ``FEATHERCNN_TPU_CACHE`` names
another), the hash
covering the sources, the compiler and its flags, as ``kernels/build.py``
builds the CUDA kernels: one compile into a temporary directory, renamed
into place, so that processes building at once keep one library.  A failed
build raises with the compiler's output; nothing falls back to Python on
its own.  A caller asks for the Python paths with ``prefer_native=False``
(``Engine.from_path``, ``serve.make_queue``, ``serve.preprocess``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .utils.cache import build_root

__all__ = ["load_library", "library_path", "available", "load_ftpu_native",
           "NativeBatchQueue"]

_SRC = Path(__file__).resolve().parent / "native_csrc"
_SOURCES = ("ftpu_loader.cc", "batch_queue.cc", "preprocess.cc")
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
          "-pthread")
_LIB_NAME = "libfcnn_native.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)
# name -> (restype, argtypes): the reference's signatures
_SIGNATURES = {
    "ftpu_open": (_P, [ctypes.c_char_p]),
    "ftpu_header_json": (ctypes.c_char_p, [_P]),
    "ftpu_tensor_data": (_P, [_P, ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_int64)]),
    "ftpu_prefetch": (None, [_P]),
    "ftpu_close": (None, [_P]),
    "bq_create": (_P, [_I64, _I64]),
    "bq_destroy": (None, [_P]),
    "bq_close": (None, [_P]),
    "bq_submit": (ctypes.c_uint64, [_P, _P]),
    "bq_collect": (_I64, [_P, _P, _U64P, _I64, _I64]),
    "bq_post_results": (None, [_P, _U64P, _P, _I64]),
    "bq_wait_result": (ctypes.c_int, [_P, ctypes.c_uint64, _P, _I64]),
    "bq_depth": (_I64, [_P]),
    "bq_stats": (None, [_P] + [_U64P] * 4),
    # image, h_in, w_in, c, out, h_out, w_out, mean, inv_std[, 1 / scale]
    "fcnn_preprocess_f32": (None, [ctypes.POINTER(ctypes.c_uint8), _I, _I, _I,
                                   _F32P, _I, _I, _F32P, _F32P]),
    "fcnn_preprocess_i8": (None, [ctypes.POINTER(ctypes.c_uint8), _I, _I, _I,
                                  ctypes.POINTER(ctypes.c_int8), _I, _I,
                                  _F32P, _F32P, ctypes.c_float]),
}


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _lib_dir() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_SRC / name).read_bytes())
    h.update(" ".join((_compiler(),) + _FLAGS).encode())
    return build_root() / ("native-" + h.hexdigest()[:16])


def _build(out_dir: Path) -> None:
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        cmd = [_compiler(), *_FLAGS, "-o", str(tmp / _LIB_NAME),
               *(str(_SRC / s) for s in _SOURCES)]
        try:
            r = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True,
                               timeout=300)
        except OSError as e:
            raise RuntimeError(f"the native library's build could not "
                               f"start: {' '.join(cmd)}: {e}") from e
        if r.returncode != 0 or not (tmp / _LIB_NAME).exists():
            raise RuntimeError(
                f"the native library's build failed (rc {r.returncode}): "
                f"{' '.join(cmd)}\n{r.stdout}")
        (tmp / "build.log").write_text(" ".join(cmd) + "\n" + r.stdout)
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / _LIB_NAME).exists():   # lost a race: keep theirs
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _load(dirname: str) -> ctypes.CDLL:
    lib_dir = build_root() / dirname
    if not (lib_dir / _LIB_NAME).exists():
        _build(lib_dir)
    lib = ctypes.CDLL(str(lib_dir / _LIB_NAME))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the native library, once per
    hash in a process: a later change of the build root keeps the library
    loaded."""
    return _load(_lib_dir().name)


def library_path() -> Path:
    """Where the native library of the current sources and compiler is
    (or will be) built."""
    return _lib_dir() / _LIB_NAME


def available() -> bool:
    """Whether the native library is built for the current sources and
    compiler (the first ``load_library`` builds it)."""
    return library_path().exists()


# ----------------------------------------------------------------------
def load_ftpu_native(path: str):
    """Load a .ftpu model through the C++ mmap loader.  Returns a Graph
    like ``model_format.load_ftpu``, its weights copied out of the map."""
    from .ir import Graph, Node, TensorSpec
    from .model_format import _json_restore

    lib = load_library()
    handle = lib.ftpu_open(str(path).encode())
    if not handle:
        raise IOError(f"ftpu_open failed for {path}")
    try:
        header = json.loads(lib.ftpu_header_json(handle).decode())
        lib.ftpu_prefetch(handle)
        params: Dict[str, np.ndarray] = {}
        for name, t in header["tensors"].items():
            nbytes = ctypes.c_int64()
            ptr = lib.ftpu_tensor_data(handle, name.encode(),
                                       ctypes.byref(nbytes))
            if not ptr:
                raise IOError(f"tensor {name!r} missing/out of bounds")
            buf = (ctypes.c_char * nbytes.value).from_address(ptr)
            # Copy out so the Graph outlives the handle.
            arr = np.frombuffer(bytearray(buf), dtype=np.dtype(t["dtype"]))
            params[name] = arr.reshape(t["shape"])
        return Graph(
            name=header["name"],
            inputs={k: TensorSpec(tuple(v["shape"]), v["dtype"])
                    for k, v in header["inputs"].items()},
            outputs=list(header["outputs"]),
            nodes=[Node(name=n["name"], op=n["op"], inputs=list(n["inputs"]),
                        outputs=list(n["outputs"]), attrs=dict(n["attrs"]),
                        params=list(n["params"])) for n in header["nodes"]],
            params=params,
            meta=_json_restore(header.get("meta", {})),
        )
    finally:
        lib.ftpu_close(handle)


# ----------------------------------------------------------------------
class NativeBatchQueue:
    """The C++ continuous-batching queue (``native_csrc/batch_queue.cc``),
    with ``PyBatchQueue``'s interface."""

    def __init__(self, item_shape, item_dtype, result_shape, result_dtype):
        lib = load_library()
        self._lib = lib
        self.item_shape = tuple(item_shape)
        self.item_dtype = np.dtype(item_dtype)
        self.result_shape = tuple(result_shape)
        self.result_dtype = np.dtype(result_dtype)
        self._item_bytes = int(np.prod(item_shape)) * self.item_dtype.itemsize
        self._result_bytes = (int(np.prod(result_shape))
                              * self.result_dtype.itemsize)
        self._q = lib.bq_create(self._item_bytes, self._result_bytes)

    def submit(self, item: np.ndarray) -> int:
        item = np.ascontiguousarray(item, self.item_dtype)
        if item.shape != self.item_shape:
            raise ValueError(f"item shape {item.shape}, expected "
                             f"{self.item_shape}")
        return int(self._lib.bq_submit(
            self._q, item.ctypes.data_as(ctypes.c_void_p)))

    def collect(self, max_batch: int, timeout_us: int = 2000):
        batch = np.empty((max_batch,) + self.item_shape, self.item_dtype)
        tickets = (ctypes.c_uint64 * max_batch)()
        n = int(self._lib.bq_collect(
            self._q, batch.ctypes.data_as(ctypes.c_void_p), tickets,
            max_batch, timeout_us))
        return batch[:n], [int(tickets[i]) for i in range(n)]

    def post_results(self, tickets, results: np.ndarray) -> None:
        results = np.ascontiguousarray(results, self.result_dtype)
        arr = (ctypes.c_uint64 * len(tickets))(*tickets)
        self._lib.bq_post_results(
            self._q, arr, results.ctypes.data_as(ctypes.c_void_p),
            len(tickets))

    def wait_result(self, ticket: int, timeout_us: int = 10_000_000
                    ) -> Optional[np.ndarray]:
        out = np.empty(self.result_shape, self.result_dtype)
        rc = self._lib.bq_wait_result(
            self._q, ticket, out.ctypes.data_as(ctypes.c_void_p), timeout_us)
        return out if rc == 0 else None

    def depth(self) -> int:
        return int(self._lib.bq_depth(self._q))

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.bq_stats(self._q, *[ctypes.byref(v) for v in vals])
        return {"submitted": vals[0].value, "completed": vals[1].value,
                "batches": vals[2].value, "max_depth": vals[3].value}

    def close(self) -> None:
        self._lib.bq_close(self._q)

    def __del__(self):
        q, self._q = getattr(self, "_q", None), None
        if q:
            self._lib.bq_close(q)
            self._lib.bq_destroy(q)
