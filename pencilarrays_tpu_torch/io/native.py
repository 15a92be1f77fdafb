"""ctypes bridge to the native strided-subarray file I/O library.

PyTorch counterpart of the JAX package's ``io/native.py``: the same C++
source (``native/pa_io.cpp`` at the repository root, the analog of the
reference's MPI-IO derived-datatype I/O, ``mpi_io.jl:372-380``) and the
same ctypes calls, ``pa_scatter_write_mt`` and ``pa_gather_read_mt``, which
release the GIL.  The port builds it with the system ``g++`` at first use
into its own directory, ``pencilarrays_tpu_torch/io/_build/`` (git-ignored),
under a name keyed by a hash of the source and the flags, so an edited
source rebuilds and a fresh checkout builds once.

Falls back gracefully: :func:`available` returns False when there is no
compiler or the build fails, and the binary driver then uses its NumPy
memmap path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["available", "default_threads", "scatter_write", "gather_read",
           "build_info"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "pa_io.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

build_info: dict = {}
"""``path`` of the library and ``seconds`` its build took in this process
(0 when a built library was reused); ``error`` when the build failed."""


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libpa_io-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile to a process-unique temporary name and rename atomically, so
    that concurrent ranks never load a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    i64p = ctypes.POINTER(ctypes.c_int64)
    base = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            i64p, i64p, i64p, ctypes.c_void_p]
    for fn in (lib.pa_scatter_write, lib.pa_gather_read):
        fn.restype = ctypes.c_int
        fn.argtypes = base
    for fn in (lib.pa_scatter_write_mt, lib.pa_gather_read_mt):
        fn.restype = ctypes.c_int
        fn.argtypes = base + [ctypes.c_int32]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not _SRC.exists():
            _failed = True
            build_info["error"] = f"{_SRC} is missing"
            return None
        so = _target()
        t0 = time.perf_counter()
        try:
            if not so.exists():
                _build(so)
            _lib = _bind(so)
        except (subprocess.SubprocessError, OSError, AttributeError) as e:
            _failed = True
            build_info["error"] = f"{type(e).__name__}: {e}"
            return None
        build_info.update(path=str(so), seconds=time.perf_counter() - t0)
        return _lib


def available() -> bool:
    return _load() is not None


def _as_i64(seq: Sequence[int]):
    return (ctypes.c_int64 * len(seq))(*[int(v) for v in seq])


def default_threads() -> int:
    """Worker count for within-block row parallelism: the C side splits a
    block's strided runs across up to this many threads (each with its own
    fd), capped by a 4 MiB/thread floor.  1 unless
    ``PENCILARRAYS_TPU_IO_THREADS`` says otherwise (capped at 16), as in the
    JAX package, whose measurements found concurrent ``pwrite``s slower
    than one stream on a page-cached filesystem; set it on parallel
    filesystems (Lustre, GPFS, striped NFS)."""
    env = os.environ.get("PENCILARRAYS_TPU_IO_THREADS")
    if env:
        try:
            return max(1, min(16, int(env)))
        except ValueError:
            warnings.warn(
                f"PENCILARRAYS_TPU_IO_THREADS={env!r} is not an integer; "
                f"using 1")
            return 1
    return 1


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native I/O library unavailable: "
                           f"{build_info.get('error')}")
    return lib


def scatter_write(path: str, base_offset: int, block: np.ndarray,
                  gdims: Sequence[int], start: Sequence[int],
                  nthreads: int = None) -> None:
    """Write a contiguous row-major ``block`` at corner ``start`` of the
    global row-major array of shape ``gdims`` stored at ``base_offset``."""
    lib = _require()
    block = np.ascontiguousarray(block)
    rc = lib.pa_scatter_write_mt(
        path.encode(), base_offset, block.dtype.itemsize, block.ndim,
        _as_i64(gdims), _as_i64(start), _as_i64(block.shape),
        block.ctypes.data_as(ctypes.c_void_p),
        int(nthreads if nthreads is not None else default_threads()),
    )
    if rc != 0:
        raise OSError(-rc, f"pa_scatter_write failed ({os.strerror(-rc)})")


def gather_read(path: str, base_offset: int, dtype, gdims: Sequence[int],
                start: Sequence[int], bdims: Sequence[int],
                nthreads: int = None,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Read the block at corner ``start`` of shape ``bdims`` into a
    contiguous array (``out``, a C-contiguous array of that shape and
    dtype, e.g. a view of pinned host memory, or a new one)."""
    lib = _require()
    bdims = tuple(int(b) for b in bdims)
    if out is None:
        out = np.empty(bdims, dtype=np.dtype(dtype))
    elif (out.shape != bdims or out.dtype != np.dtype(dtype)
          or not out.flags.c_contiguous):
        raise ValueError(f"gather_read: out is {out.dtype}{out.shape}, "
                         f"needs a C-contiguous {np.dtype(dtype)}{bdims}")
    rc = lib.pa_gather_read_mt(
        path.encode(), base_offset, out.dtype.itemsize, out.ndim,
        _as_i64(gdims), _as_i64(start), _as_i64(bdims),
        out.ctypes.data_as(ctypes.c_void_p),
        int(nthreads if nthreads is not None else default_threads()),
    )
    if rc != 0:
        raise OSError(-rc, f"pa_gather_read failed ({os.strerror(-rc)})")
    return out
