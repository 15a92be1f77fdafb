"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Builds happen
at first use, never at import, into ``ops/_build/`` (git-ignored), keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags: a fresh checkout builds once, an edited source rebuilds.
:func:`build_all` starts one ``nvcc`` per library at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["NVCC_FLAGS", "build", "build_all", "load", "build_info"]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, dict] = {}
"""Per kernel library: ``seconds`` the build took in this process (0 when
a cached library was reused), ``path`` and the compiler's ``log``
(``-Xptxas -v`` register and shared-memory report, kept beside the library
so that a reused one reports it too)."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, all
    ``nvcc`` processes running at once, and return each library's path."""
    out = {name: _target(name) for name in names}
    jobs = {}
    for name, path in out.items():
        if path.exists():
            log = path.with_suffix(".log")
            build_info[name] = {"seconds": 0.0, "path": str(path),
                                "log": log.read_text() if log.exists()
                                else ""}
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        src = _SRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        out[name].with_suffix(".log").write_text(log)
        os.replace(tmp, out[name])  # atomic: concurrent builds agree
        build_info[name] = {"seconds": seconds, "path": str(out[name]),
                            "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not built yet) and return the path
    of its shared library."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
