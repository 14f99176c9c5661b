"""Build the package's CUDA sources into one shared library at first use.

``nvcc`` compiles every ``comms_tpu_torch/csrc/*.cu`` for ``sm_90a``
(Hopper) into ``build/comms_tpu_torch/`` at the repository root (a
directory git ignores).  The library's file name carries a hash of the
sources and the compiler flags, so a changed source builds anew and an
unchanged one is loaded as it is; modification times are never read.
The library has a plain C interface and is loaded with ``ctypes``: no
PyTorch header is compiled, which keeps a build to seconds.

``--use_fast_math`` is deliberately absent: it flushes denormals and
approximates division, and the FM kernel's atan2 depends on both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load", "nvcc_path", "BUILD_DIR", "CSRC_DIR"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "comms_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the "
        "CUDA kernels of comms_tpu_torch cannot be built")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs, target: Path) -> None:
    """nvcc into a temporary file beside ``target``, then an atomic
    rename, so that concurrent builds never load a half-written
    library.  Raises with nvcc's stderr on failure."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fm_chain_launch.restype = ctypes.c_int
    lib.fm_chain_launch.argtypes = [
        ptr, ptr,            # re, im u8 planes
        ptr, ptr, ptr, ptr,  # ctx xre, xim, d, prev (f32, device)
        ptr, ptr,            # taps1, taps2 (f32, host)
        ptr,                 # audio out (f32, device)
        i64,                 # audio samples
        ptr,                 # cudaStream_t
    ]


def load():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        target = BUILD_DIR / f"libcomms_tpu_torch_{_source_hash(srcs)}.so"
        if not target.exists():
            _compile(srcs, target)
        lib = ctypes.CDLL(str(target))
        _bind(lib)
        _lib = lib
        return lib
