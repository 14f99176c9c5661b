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
copied once per content and device.  :func:`per_slice_vmap` lets
``torch.func.vmap`` lift a kernel launch registered as a
``torch.library.custom_op``: one launch a slice of the batch axis (K5's
ops; the recurrence ops have a batched rule of their own);
:func:`per_stream` wraps a stream step so that vmap runs it once a
stream.

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
import torch.utils._pytree as pytree
from torch._C._functorch import is_batchedtensor

__all__ = ["load", "library_path", "nvcc_path", "bind_recurrence",
           "device_constant", "device_index", "per_slice_vmap", "per_stream",
           "BUILD_DIR", "CSRC_DIR"]

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


def bind_recurrence(lib) -> None:
    """The C signatures of ``csrc/recurrence.cu``'s two entries on
    ``lib`` (any library built from that source)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f32 = ctypes.c_float
    lib.costas_loop_launch.restype = i32
    lib.costas_loop_launch.argtypes = [
        ptr, ptr,                  # xr, xi [B, n] planes
        i64, i64, i64, i64,        # their row and element strides
        i64, i64,                  # streams B, steps n
        ptr, i64, ptr, i64,        # phase, freq [B] (device), their strides
        i32, f32, f32,             # order, alpha, beta
        ptr, ptr, ptr, ptr,        # yr, yi [B, n], phase out, freq out
        ptr,                       # cudaStream_t
    ]
    lib.agc_scan_launch.restype = i32
    lib.agc_scan_launch.argtypes = [
        ptr, ptr,                  # xr, xi [B, n] planes
        i64, i64, i64, i64,        # their row and element strides
        i64, i64,                  # streams B, steps n
        ptr, i64, f32, f32,        # gain [B] (device), its stride, target, rate
        ptr, ptr, ptr,             # yr, yi [B, n], gain out
        ptr,                       # cudaStream_t
    ]


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
        i64, i32, ptr, ptr,        # frames, blocks, yr, yi
        ptr,                       # cudaStream_t
    ]
    lib.decim_fir_smem_bytes.restype = i64
    lib.decim_fir_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.decim_fir_launch.restype = i32
    lib.decim_fir_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # xr, xi, ctx r, ctx i, ctx length
        ptr, ptr, i32, i32, i32,   # taps r, taps i, MD, D, complex taps
        i64, i32, i32, i32,        # samples a row, rows, threads, blocks
        ptr, ptr, ptr, ptr,        # yr, yi, next ctx r, next ctx i
        ptr,                       # cudaStream_t
    ]
    lib.lag1_demod_launch.restype = i32
    lib.lag1_demod_launch.argtypes = [
        ptr, ptr, ptr,             # yr, yi [F, K], prev [K, 2]
        i64, i32, i32,             # frames, K, polynomial atan2
        ptr, ptr, ptr,             # d [K, F], next prev [K, 2], stream
    ]
    lib.band_monitor_launch.restype = i32
    lib.band_monitor_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # re, im, ctx re, ctx im, ctx length
        ptr, ptr, i32,             # halo re, halo im, halo frames
        ptr, ptr, ptr, i32, i32,   # C, roots (host), C (device), K, M
        ptr, i32, i32, i64, i32,   # audio taps, count, dec, frames, run
        ptr, ptr, ptr, ptr, ptr,   # audio, halo out re/im, ctx out re/im
        ptr,                       # cudaStream_t
    ]
    lib.qpsk_sym_launch.restype = i32
    lib.qpsk_sym_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32,   # re, im, ctx re, ctx im, MD
        ptr, ptr, ptr,             # taps r, taps i, (ws, phase0)
        ptr, ptr, ptr,             # mf rows, (w, lag, phase0), shift2
        i64, i32, i32,             # samples, threads a block, blocks
        ptr, ptr, ptr,             # yr, yi, cudaStream_t
    ]
    lib.qpsk_panels_launch.restype = i32
    lib.qpsk_panels_launch.argtypes = [
        ptr, ptr, i64, i32, i32,   # re, im, samples, halfwidth, chunk rows
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
        ptr, ptr, i64, i64, i32,   # xr, xi, rows, row stride, n
        ptr, f32,                  # twiddles (re, im) pairs, scale
        ptr, ptr, ptr,             # yr, yi, cudaStream_t
    ]
    lib.psd_launch.restype = i32
    lib.psd_launch.argtypes = [
        ptr, ptr, i64, i64, i32,   # xr, xi, rows, row stride, n
        ptr, ptr, i32,             # window, row weights, demean
        ptr, i32,                  # twiddles (re, im) pairs, segments a run
        ptr, i32,                  # partial rows, their count
        ptr, ptr,                  # out [n], cudaStream_t
    ]
    lib.fft_big_stage_a_launch.restype = i32
    lib.fft_big_stage_a_launch.argtypes = [
        ptr, ptr, i32, i64, i32,   # xr, xi, segments, stride, blocked
        i32, i32, i32, ptr, ptr,   # n1, n2, column tile, window, means
        ptr, ptr, ptr,             # n1 twiddles, high and low tables
        ptr, ptr, ptr,             # D, tile sums, cudaStream_t
    ]
    lib.fft_big_stage_b_psd_launch.restype = i32
    lib.fft_big_stage_b_psd_launch.argtypes = [
        ptr, i32, i32, i32,        # D, segments, n1, n2
        i32, i32, ptr,             # D's tile width, segments/block, n2 table
        ptr, ptr, i32, ptr,        # sparse bins, W there, count, means
        ptr, ptr, ptr,             # partial sums, out [N], cudaStream_t
    ]
    lib.fft_big_stage_b_fft_launch.restype = i32
    lib.fft_big_stage_b_fft_launch.argtypes = [
        ptr, i32, i32, i32,        # D, segments, n1, n2
        i32, i32, ptr,             # D's tile width, rows per block, n2 table
        ptr, ptr, ptr,             # yr, yi, cudaStream_t
    ]
    bind_recurrence(lib)
    lib.halo_ring_max_pairs.restype = i32
    lib.halo_ring_max_pairs.argtypes = []
    lib.halo_ring_launch.restype = i32
    lib.halo_ring_launch.argtypes = [
        ptr,                       # host array (bytes): srcs, then dsts
        i32, i64, ptr,             # pairs, bytes each, cudaStream_t
    ]
    lib.halo_ring_floor_launch.restype = i32
    lib.halo_ring_floor_launch.argtypes = [
        i32, i32, ptr,             # 2 KB parameter block?, blocks, stream
    ]
    pptr = ctypes.POINTER(ctypes.c_void_p)
    lib.halo_ipc_handle_bytes.restype = i32
    lib.halo_ipc_handle_bytes.argtypes = []
    lib.halo_ipc_window_alloc.restype = i32
    lib.halo_ipc_window_alloc.argtypes = [i64, pptr, ptr]  # bytes, out, handle
    lib.halo_ipc_window_open.restype = i32
    lib.halo_ipc_window_open.argtypes = [ptr, pptr]        # handle, out
    lib.halo_ipc_window_close.restype = i32
    lib.halo_ipc_window_close.argtypes = [ptr]
    lib.halo_ipc_window_free.restype = i32
    lib.halo_ipc_window_free.argtypes = [ptr]
    lib.halo_ipc_event_create.restype = i32
    lib.halo_ipc_event_create.argtypes = [pptr, ptr]       # out, handle
    lib.halo_ipc_event_open.restype = i32
    lib.halo_ipc_event_open.argtypes = [ptr, pptr]         # handle, out
    lib.halo_ipc_event_destroy.restype = i32
    lib.halo_ipc_event_destroy.argtypes = [ptr]
    lib.halo_ipc_wait_record.restype = i32
    lib.halo_ipc_wait_record.argtypes = [
        ptr, i32, ptr, ptr,        # events to wait for, count, record, stream
    ]
    lib.halo_ipc_copy_out.restype = i32
    lib.halo_ipc_copy_out.argtypes = [
        ptr, ptr, ptr, i64,        # written event, window, dst, bytes
        ptr, ptr,                  # freed event, cudaStream_t
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


def _per_slice(call, info, in_dims, args):
    """``call`` once per slice of the batch axis (contiguous slices of the
    batched tensors, the other arguments as they are), the outputs
    stacked along a new leading axis: ``(outputs, out_dims)``."""
    outs = [call(*(a.select(d, b).contiguous()
                   if isinstance(a, torch.Tensor) and d is not None else a
                   for a, d in zip(args, in_dims)))
            for b in range(info.batch_size)]
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs), 0
    return tuple(torch.stack(t) for t in zip(*outs)), (0,) * len(outs[0])


def per_slice_vmap(op) -> None:
    """Register a ``torch.func.vmap`` rule for the custom op ``op`` (a
    kernel launch, which reads data pointers and so cannot see a batched
    tensor): the op runs once per slice of the batch axis and its outputs
    are stacked.  Each stream gets its own launch, so a batched call
    equals a loop over the streams of the op's calls."""
    torch.library.register_vmap(
        op, lambda info, in_dims, *args: _per_slice(op, info, in_dims, args))


class _PerStream(torch.autograd.Function):
    """``fn(*args)``; under ``torch.func.vmap``, once per slice of the
    batch axis, the outputs stacked (:func:`per_stream`)."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        return _per_slice(lambda *a: _PerStream.apply(fn, *a), info,
                          in_dims[1:], args)


def per_stream(step):
    """``step`` (tensors, or dicts, tuples and lists of them, in and out)
    as it is, except under ``torch.func.vmap``: there it runs once a
    stream and its outputs are stacked.  For a stream step whose sums and
    small products would round otherwise on batched tensors, so that the
    vmapped step equals a loop over its streams bit for bit.  Outside
    vmap (no argument is a batched tensor) the wrapper calls ``step``
    directly."""
    @functools.wraps(step)
    def run(*args):
        leaves, spec = pytree.tree_flatten(args)
        if not any(isinstance(t, torch.Tensor) and is_batchedtensor(t)
                   for t in leaves):
            return step(*args)
        out_spec = []

        def flat(*ls):
            out, s = pytree.tree_flatten(
                step(*pytree.tree_unflatten(list(ls), spec)))
            out_spec.append(s)
            return tuple(out)

        out = _PerStream.apply(flat, *leaves)
        return pytree.tree_unflatten(list(out), out_spec[-1])

    return run
