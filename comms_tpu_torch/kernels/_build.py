"""Build the package's CUDA sources into one shared library at first use.

``nvcc`` compiles every ``comms_tpu_torch/csrc/*.cu`` for ``sm_90a``
(Hopper), one process per source, all started together, then links the
objects into one library in ``build/comms_tpu_torch/`` at the repository
root (a directory git ignores).  The library's file name carries a hash
of the sources, the headers and the compiler flags, so a changed source
builds anew and an unchanged one is loaded as it is; modification times
are never read.  The library has a plain C interface and is loaded with
``ctypes``: no PyTorch header is compiled, which keeps a build to
seconds.  ``ptxas``'s report (registers, shared memory, spills per
kernel) is kept beside the library as ``<library>.log``.

:func:`device_constant` and :func:`device_index` keep the kernels'
coefficient tables and the estimate chains' index arrays on the card,
copied once per content and device.

``--use_fast_math`` is deliberately absent: it flushes denormals and
approximates division, and the FM kernel's atan2 depends on both.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["load", "library_path", "nvcc_path", "device_constant",
           "device_index", "BUILD_DIR", "CSRC_DIR"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "comms_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _run(cmds):
    """Run the commands in parallel; raises with the first failure's
    stderr.  Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


def _compile(srcs, target: Path) -> None:
    """One nvcc per source into objects, then one link, into a
    temporary file beside ``target`` and an atomic rename, so that
    concurrent builds never load a half-written library."""
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in srcs]
        logs = _run([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                     for p, o in zip(srcs, objs)])
        lib = str(Path(tmp) / "lib.so")
        _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", lib, *objs]])
        Path(f"{target}.log").write_text("".join(logs))
        os.replace(lib, target)


def _bind(lib) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fm_chain_launch.restype = i32
    lib.fm_chain_launch.argtypes = [
        ptr, ptr,            # re, im u8 planes
        ptr, ptr, ptr, ptr,  # ctx xre, xim, d, prev (f32, device)
        ptr, ptr,            # taps1, taps2 (f32, host)
        ptr,                 # audio out (f32, device)
        i64,                 # audio samples
        ptr,                 # cudaStream_t
    ]
    lib.channelize_launch.restype = i32
    lib.channelize_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # re, im, ctx re, ctx im, ctx length
        ptr, ptr, i32, i32,        # C, roots, K, M
        i64, ptr, ptr,             # frames, yr, yi
        ptr,                       # cudaStream_t
    ]
    lib.decim_fir_smem_bytes.restype = i64
    lib.decim_fir_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.decim_fir_launch.restype = i32
    lib.decim_fir_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # xr, xi, ctx r, ctx i, ctx length
        ptr, ptr, i32, i32, i32,   # taps r, taps i, MD, D, complex taps
        i64, i32, i32,             # samples per row, rows, outputs/block
        ptr, ptr, ptr,             # yr, yi, cudaStream_t
    ]
    lib.band_monitor_launch.restype = i32
    lib.band_monitor_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # re, im, ctx re, ctx im, ctx length
        ptr, ptr, i32,             # halo re, halo im, halo frames
        ptr, ptr, i32, i32,        # C, roots, K, M
        ptr, i32, i32, i64,        # audio taps, their count, dec, frames
        ptr, ptr, ptr, ptr, ptr,   # audio, halo out re/im, ctx out re/im
        ptr,                       # cudaStream_t
    ]
    lib.fir_smem_bytes.restype = i64
    lib.fir_smem_bytes.argtypes = [i32, i32]
    lib.fir_launch.restype = i32
    lib.fir_launch.argtypes = [
        ptr, ptr, ptr, ptr,        # xr, xi, ctx r, ctx i (1024 each)
        ptr, ptr, i32, i32,        # taps r, taps i, T, complex taps
        i64, ptr, ptr, ptr,        # samples, yr, yi, cudaStream_t
    ]
    lib.qpsk_sym_launch.restype = i32
    lib.qpsk_sym_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # re, im, ctx re, ctx im, MD
        ptr, ptr, ptr,             # taps r, taps i, (ws, phase0)
        ptr, ptr, ptr,             # mf rows, (w, lag, phase0), shift2
        i64, ptr, ptr, ptr,        # samples, yr, yi, cudaStream_t
    ]
    lib.qpsk_panel_chunk_rows.restype = i32
    lib.qpsk_panel_chunk_rows.argtypes = []
    lib.qpsk_panels_launch.restype = i32
    lib.qpsk_panels_launch.argtypes = [
        ptr, ptr, i64, i32,        # re, im, samples, halfwidth
        ptr, i32, ptr, ptr,        # partial sums, chunks, panels, stream
    ]
    lib.panel_reduce_launch.restype = i32
    lib.panel_reduce_launch.argtypes = [
        ptr, ptr, i32, i32,        # p13, p24, hw, sps
        ptr, ptr,                  # out [16, 128], cudaStream_t
    ]
    f32 = ctypes.c_float
    lib.fft_launch.restype = i32
    lib.fft_launch.argtypes = [
        ptr, ptr, i64, i32,        # xr, xi, rows, n
        ptr, ptr, f32,             # twiddles re, im, scale
        ptr, ptr, ptr,             # yr, yi, cudaStream_t
    ]
    lib.psd_launch.restype = i32
    lib.psd_launch.argtypes = [
        ptr, ptr, i64, i64, i32,   # xr, xi, rows, row stride, n
        ptr, ptr, i32,             # window, row weights, demean
        ptr, ptr,                  # twiddles re, im
        ptr, i32, i32,             # partial rows, their count, tiles each
        ptr, ptr,                  # out [n], cudaStream_t
    ]
    lib.fft_big_stage_a_launch.restype = i32
    lib.fft_big_stage_a_launch.argtypes = [
        ptr, ptr, i32, i64, i32,   # xr, xi, segments, stride, blocked
        i32, i32, i32, ptr, ptr,   # n1, n2, column tile, window, means
        ptr, ptr,                  # n1 twiddles re, im
        ptr, ptr, ptr, ptr,        # high table re, im, low table re, im
        ptr, ptr, ptr, ptr,        # dr, di, tile sums, cudaStream_t
    ]
    lib.fft_big_stage_b_psd_launch.restype = i32
    lib.fft_big_stage_b_psd_launch.argtypes = [
        ptr, ptr, i32, i32, i32,   # dr, di, segments, n1, n2
        ptr, ptr,                  # n2 twiddles re, im
        ptr, ptr, i32, ptr,        # sparse bins, W there, count, means
        ptr, ptr,                  # out [N], cudaStream_t
    ]
    lib.fft_big_stage_b_fft_launch.restype = i32
    lib.fft_big_stage_b_fft_launch.argtypes = [
        ptr, ptr, i32, i32, i32,   # dr, di, segments, n1, n2
        ptr, ptr,                  # n2 twiddles re, im
        ptr, ptr, ptr,             # yr, yi, cudaStream_t
    ]
    lib.halo_ring_max_pairs.restype = i32
    lib.halo_ring_max_pairs.argtypes = []
    lib.halo_ring_launch.restype = i32
    lib.halo_ring_launch.argtypes = [
        ctypes.POINTER(ptr), ctypes.POINTER(ptr),   # host arrays: srcs, dsts
        i32, i64, ptr,             # pairs, bytes each, cudaStream_t
    ]


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    srcs = _sources()
    return BUILD_DIR / f"libcomms_tpu_torch_{_source_hash(srcs)}.so"


def load():
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        target = library_path()
        if not target.exists():
            _compile(srcs, target)
        lib = ctypes.CDLL(str(target))
        _bind(lib)
        _lib = lib
        return lib


def device_constant(arr: np.ndarray, device, dtype=np.float32) -> torch.Tensor:
    """``arr`` as a ``dtype`` (float32 by default) tensor on ``device``,
    copied once per content and device (the taps and tables the kernels
    and the estimate chains read).  Callers must not write to it."""
    a = np.ascontiguousarray(arr, dtype=dtype)
    return _cached_constant(a.tobytes(), a.shape, a.dtype.str,
                            str(torch.device(device)))


def device_index(arr: np.ndarray, device) -> torch.Tensor:
    """Host index array ``arr`` as an int64 tensor on ``device``, copied
    once per content and device, for gathers whose indices are known on
    the host: reusing it keeps a block step free of host-to-device
    copies."""
    return device_constant(arr, device, np.int64)


@functools.lru_cache(maxsize=256)
def _cached_constant(raw: bytes, shape: tuple, np_dtype: str,
                     device: str) -> torch.Tensor:
    a = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    return torch.from_numpy(a.copy()).to(device)
