"""The QPSK receiver's symbol path and correlation panels: one CUDA
source, three entries, and their plain versions.

Symbols (the artifact frame of the decimator already dropped):

    y[s] = e^{-j(phase0 + ws*(s+1))} *
           sum_t (fr + j*fi)[t] * (xr + j*xi)[4*(s+1) - t]

over raw float32 planes, with an optional carried context of MD-1
samples (zeros otherwise) and zeros past the block's end; optionally
also the four correlation panels of ``TimingEstimator.corr_panels``.
``csrc/qpsk_sym.cu`` replaces the TPU kernel
``comms_tpu/kernels/qpsk_sym_pallas.py`` and keeps its contracts
(:func:`kernel_ok`: sps = 4, N % :data:`IN_PER_STEP` == 0, MD <= 132;
matched filters of at most 116 taps; ``panels_hw`` in (0, 64]):

* :func:`qpsk_symbol_gemm` takes the modulated taps ``(fr, fi)`` and
  the symbol-rate step ``ws`` as tensors;
* :func:`qpsk_symbol_gemm_scalars` takes the estimates ``(w, lag[4],
  shift2)`` and builds ``conv(lagrange at shift2 + 4, mf)`` modulated by
  ``e^{j*w*t}`` in the kernel, reading the estimates from the device
  (no host synchronisation between blocks);
* :func:`qpsk_panels` computes the panels alone (it launches through
  :func:`qpsk_symbol_gemm`, as the JAX package's does).

The de-rotation angle follows the TPU kernel's float32 decomposition
(per 65,536-symbol step, row of 128 and lane, each reduced mod 2*pi),
and so does the plain version :func:`qpsk_symbol_plain`, so the two agree
at full width, where a single ``ws*s`` product in float32 would be off by
tens of milliradians.  The panels run on the tensor cores in 3xTF32
(``csrc/tf32x3.cuh``: each operand split into TF32 hi and lo, three
products a term, float32 accuracy; :mod:`._tf32` mirrors the split for
the CPU tests), per chunk of rows (:func:`panel_chunking`), and are then
summed over the chunks in a fixed order: two runs give bit-identical
panels.

The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; any other device raises.  ``launches`` counts,
per entry name, the calls that launched kernels (a symbol entry with
panels launches a symbol and two panel kernels and counts once), and
under ``qpsk_symbols`` the symbol kernel's own launches, whichever entry
made them.  The launches are ``torch.library`` custom ops
(``comms_tpu_torch::qpsk_symbols`` and ``::qpsk_panels``) with a
per-slice vmap rule (``_build.per_slice_vmap``): ``torch.func.vmap`` of
a stream step that reaches them runs one launch a stream, and each
launch counts, as a loop over the streams would.  The symbol kernel
walks tiles of symbols in persistent blocks, a partition fixed by the
shape (:func:`partition`).  The
taps of ``_scalars`` are built with the accurate ``sincosf``, so the
port does not carry the TPU kernel's ~3e-3 in-kernel tap error.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import demodulation as _demod
from comms_tpu_torch.ops import fir as _fir

__all__ = ["qpsk_symbol_gemm", "qpsk_symbol_gemm_scalars", "qpsk_panels",
           "qpsk_symbol_plain", "qpsk_panels_plain", "modulated_taps_plain",
           "kernel_ok", "panel_chunking", "partition", "IN_PER_STEP",
           "SPS"]

_LANES = 128
_ROWS = 512                    # output rows of 128 symbols per TPU step
IN_PER_STEP = _ROWS * 4 * _LANES   # 262,144 input samples per step
SPS = 4
_MD_MAX = 132
_MF_MAX = 116                  # matched-filter taps of the _scalars entry
_STEP_SYMS = IN_PER_STEP // SPS
_PANEL_CHUNKS = 66             # the panel kernel's chunks of rows, at least
_SYM_R = 4                     # symbols a thread of the symbol kernel
_SYM_THREADS = (128, 64)       # its block sizes, largest first
_SYM_MIN_TILES = 264           # tiles a call, before smaller blocks are taken
_RUN_BLOCKS = 6336             # blocks a call, at most (48 an SM)
_TWO_PI = float(np.float32(2.0 * np.pi))

# Calls that launched kernels, per entry, since import (or since a
# caller reset them to 0).
launches = {"qpsk_symbol_gemm": 0, "qpsk_symbol_gemm_scalars": 0,
            "qpsk_panels": 0, "qpsk_symbols": 0}


def kernel_ok(n: int, md: int, sps: int) -> bool:
    """Static applicability: sps 4, a block of whole TPU steps, taps
    within the kernel's reach."""
    return sps == SPS and n % IN_PER_STEP == 0 and 1 <= md <= _MD_MAX


def _mf_shift_rows(mf_taps) -> np.ndarray:
    """Host [16, 128] rows MS[s, m] = mf[m - s] for s < 12 (the rest
    zero): the 12 shifts the in-kernel tap build selects among (t0 + j,
    t0 = shift2 + 4 in [0, 8], j < 4)."""
    mf = np.asarray(mf_taps, np.float64)
    T = mf.shape[0]
    MS = np.zeros((16, _LANES), np.float32)
    for s in range(12):
        MS[s, s:s + T] = mf.astype(np.float32)
    return MS


def _check_planes(re, im):
    for name, p in (("re", re), ("im", im)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.float32 or p.ndim != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 "
                             f"tensor, got {p.dtype} {tuple(p.shape)}")
    if re.shape != im.shape or im.device != re.device:
        raise ValueError("re and im must share a length and a device")
    if re.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the QPSK symbol kernel runs on CUDA or CPU "
                         f"tensors, got {re.device}")


def _check_ctx(ctx, md: int, dev):
    if ctx is None:
        return None
    cr, ci = ctx
    for c in (cr, ci):
        if int(c.shape[0]) != md - 1:
            raise ValueError(f"ctx must be MD-1 = {md - 1} samples, "
                             f"got {c.shape[0]}")
    return (cr.to(device=dev, dtype=torch.float32).contiguous(),
            ci.to(device=dev, dtype=torch.float32).contiguous())


def _check_hw(panels_hw: int) -> int:
    hw = int(panels_hw)
    if hw and not 0 < hw <= 64:
        raise ValueError(f"panels_hw must be in (0, 64], got {hw}")
    return hw


def _panel_meta(n: int, hw: int) -> dict:
    K = n - hw
    return {"nd": hw, "K": K, "Kp": _LANES * (-(-K // _LANES)),
            "R": -(-K // _LANES), "width": _LANES + 2 * hw,
            "fdt": torch.float32, "prec": None}


def _scalar(v, dev) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(v), dtype=torch.float32, device=dev)


def _int_scalar(v, dev) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.int64)
    return torch.full((), int(v), dtype=torch.int64, device=dev)


# ---- the kernels

def partition(n: int):
    """The symbol kernel's partition of the n / 4 symbols of ``n``
    samples: ``(threads, tiles, blocks)``.  Tiles of 4 * ``threads``
    symbols (a divisor of the 65,536 of a TPU step): 128 threads, or 64
    when a call has fewer than 264 tiles of 512 (two an SM); at most
    6,336 persistent blocks, block b walking tiles b, b + blocks, ...
    (on an H100 at 2^25 samples 128 threads and 6,336 blocks ran 1.08x
    faster than 256 threads and 2,112 blocks, tools/k5_sym_compare.py)."""
    syms = int(n) // SPS
    for threads in _SYM_THREADS:
        if syms // (_SYM_R * threads) >= _SYM_MIN_TILES:
            break
    tiles = syms // (_SYM_R * threads)
    return threads, tiles, max(1, min(tiles, _RUN_BLOCKS))


@torch.library.custom_op(
    "comms_tpu_torch::qpsk_symbols", mutates_args=(), device_types="cuda",
    schema="(Tensor re, Tensor im, Tensor? ctx_re, Tensor? ctx_im, int md, "
           "Tensor? fr, Tensor? fi, Tensor? params, Tensor? rows, "
           "Tensor? scal_f, Tensor? scal_i, str[] count) -> (Tensor, Tensor)")
def _symbols_op(re, im, ctx_re, ctx_im, md, fr, fi, params, rows, scal_f,
                scal_i, count):
    """One launch of the symbol kernel: the traced-taps form (``fr, fi,
    params = [ws, phase0]``) or the ``_scalars`` form (``rows, scal_f =
    [w, lag[4], phase0], scal_i = [shift2]``).  Adds one to ``launches``
    under ``qpsk_symbols`` and under each name in ``count``."""
    lib = _build.load()
    dev = re.device
    n = re.shape[0]
    yr = torch.empty(n // SPS, dtype=torch.float32, device=dev)
    yi = torch.empty(n // SPS, dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    threads, _, blocks = partition(n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qpsk_sym_launch(
            re.data_ptr(), im.data_ptr(), ptr(ctx_re), ptr(ctx_im), md,
            ptr(fr), ptr(fi), ptr(params), ptr(rows), ptr(scal_f),
            ptr(scal_i), n, threads, blocks, yr.data_ptr(), yi.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"QPSK symbol kernel launch failed: CUDA "
                           f"error {rc}")
    for k in ("qpsk_symbols", *count):
        launches[k] += 1
    return yr, yi


def _launch_symbols(re, im, ctx, md, taps=None, ws=None, phase0=0.0,
                    scalars=None, count=()):
    dev = re.device
    cr, ci = ctx if ctx is not None else (None, None)
    if taps is not None:
        fr, fi = (t.to(device=dev, dtype=torch.float32).contiguous()
                  for t in taps)
        params = torch.cat([_scalar(ws, dev), _scalar(phase0, dev)])
        return _symbols_op(re, im, cr, ci, md, fr, fi, params, None, None,
                           None, list(count))
    mf_rows, w, lag, shift2 = scalars
    rows = _build.device_constant(mf_rows, dev)
    scal_f = torch.cat([_scalar(w, dev),
                        lag.to(device=dev, dtype=torch.float32).reshape(4),
                        _scalar(phase0, dev)])
    scal_i = (shift2.to(device=dev, dtype=torch.int32).reshape(1)
              if isinstance(shift2, torch.Tensor) else
              torch.full((1,), int(shift2), dtype=torch.int32, device=dev))
    return _symbols_op(re, im, cr, ci, md, None, None, None, rows, scal_f,
                       scal_i, list(count))


def panel_chunking(n: int, hw: int):
    """``(chunk_rows, chunks)`` of the panel kernel at N = ``n``: the R =
    ceil((n - hw) / 128) rows cut into chunks of floor(R / 66) rows (at
    least one), so at least 66 chunks of 8 block tiles: four blocks for
    each of the H100's 132 SMs at every N of the main paths."""
    R = -(-(n - hw) // _LANES)
    rows = max(1, R // _PANEL_CHUNKS)
    return rows, -(-R // rows)


@torch.library.custom_op(
    "comms_tpu_torch::qpsk_panels", mutates_args=(), device_types="cuda",
    schema="(Tensor re, Tensor im, int hw, str[] count) -> Tensor")
def _panels_op(re, im, hw, count):
    """One call of the panel kernels: the panels ``[4, 128, 128 + 2hw]``.
    Adds one to ``launches`` under each name in ``count``."""
    lib = _build.load()
    dev = re.device
    n = re.shape[0]
    meta = _panel_meta(n, hw)
    chunk_rows, chunks = panel_chunking(n, hw)
    w8 = -(-meta["width"] // 8) * 8
    part = torch.empty(chunks * 4 * _LANES * w8, dtype=torch.float32,
                       device=dev)
    panels = torch.empty((4, _LANES, meta["width"]), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qpsk_panels_launch(re.data_ptr(), im.data_ptr(), n, hw,
                                    chunk_rows, part.data_ptr(), chunks,
                                    panels.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"QPSK panel kernel launch failed: CUDA "
                           f"error {rc}")
    for k in count:
        launches[k] += 1
    return panels


_build.per_slice_vmap(_symbols_op)
_build.per_slice_vmap(_panels_op)


def _launch_panels(re, im, hw: int, count=()):
    panels = _panels_op(re, im, hw, list(count))
    return (panels[0], panels[1], panels[2], panels[3],
            _panel_meta(int(re.shape[0]), hw))


def _pad_to_quad(fr, fi, ctx):
    """Taps zero-padded to a multiple of 4 (the kernel's window phase),
    the context extended by as many zeros in front: the padded taps are
    zero, so the outputs do not change."""
    md = int(fr.shape[0])
    p = -md % SPS
    if not p:
        return fr, fi, ctx
    z = fr.new_zeros(p)
    fr, fi = torch.cat([fr, z]), torch.cat([fi, z])
    if ctx is not None:
        ctx = tuple(torch.cat([c.new_zeros(p), c]) for c in ctx)
    return fr, fi, ctx


# ---- the entries

def qpsk_symbol_gemm(re, im, fr, fi, ws, phase0=0.0, ctx=None,
                     panels_hw: int = 0, _sym_on: bool = True,
                     _panels_count=("qpsk_symbol_gemm",)):
    """Fused symbol path on float32 planes.

    Args:
      re, im: [N] raw planes, N % IN_PER_STEP == 0.
      fr, fi: [MD] modulated tap tensors, MD <= 132.
      ws: symbol-rate de-rotation step (w * sps), number or 0-d tensor.
      phase0: carried absolute phase at the block start.
      ctx: optional ``(ctx_re, ctx_im)`` carried raw tails, MD-1 samples.
      panels_hw: if > 0 (<= 64), also the correlation panels at this
        halfwidth, returned as ``(sr, si, (P1, P2, P3, P4, meta))``.

    Returns ``(sr, si)``, [N/4] symbol planes.
    """
    _check_planes(re, im)
    n = int(re.shape[0])
    md = int(fr.shape[0])
    if not kernel_ok(n, md, SPS):
        raise ValueError(f"block {n} / taps {md} outside kernel bounds")
    hw = _check_hw(panels_hw)
    dev = re.device
    ctx = _check_ctx(ctx, md, dev)
    if dev.type == "cpu":
        panels = qpsk_panels_plain(re, im, hw) if hw else None
        if not _sym_on:
            return panels
        sr, si = qpsk_symbol_plain(re, im, fr, fi, ws, phase0, ctx)
        return (sr, si) if not hw else (sr, si, panels)
    if not _sym_on:
        return _launch_panels(re, im, hw, _panels_count)
    panels = _launch_panels(re, im, hw) if hw else None
    fr4, fi4, ctx4 = _pad_to_quad(fr, fi, ctx)
    sr, si = _launch_symbols(re, im, ctx4, int(fr4.shape[0]),
                             taps=(fr4, fi4), ws=ws, phase0=phase0,
                             count=("qpsk_symbol_gemm",))
    return (sr, si) if not hw else (sr, si, panels)


def qpsk_symbol_gemm_scalars(re, im, mf_taps, w, lag, shift2, phase0=0.0,
                             ctx=None, panels_hw: int = 0):
    """:func:`qpsk_symbol_gemm` with the taps built in the kernel from the
    estimates: ``w`` (rad/sample), ``lag`` [4] (cubic Lagrange weights)
    and ``shift2`` (integer timing shift, in [-4, 4]), all numbers or
    tensors on the planes' device, and the host matched filter
    ``mf_taps`` (T <= 116).  The same outputs as
    ``qpsk_symbol_gemm(re, im, *modulated_taps(mf, w, lag, shift2),
    w * 4, ...)``; the context is MD-1 samples, MD = 4*ceil((11 + T)/4).
    """
    _check_planes(re, im)
    mf = np.asarray(mf_taps, np.float64)
    T = int(mf.shape[0])
    if T > _MF_MAX:
        raise ValueError(f"mf taps {T} exceed the shift-row width")
    md = -(-(3 * SPS + T - 1) // SPS) * SPS
    n = int(re.shape[0])
    if not kernel_ok(n, md, SPS):
        raise ValueError(f"block {n} / taps {md} outside kernel bounds")
    hw = _check_hw(panels_hw)
    dev = re.device
    ctx = _check_ctx(ctx, md, dev)
    lag = torch.as_tensor(lag, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        fr, fi = modulated_taps_plain(mf.astype(np.float32), w, lag, shift2,
                                      dev)
        sr, si = qpsk_symbol_plain(re, im, fr, fi,
                                   _scalar(w, dev)[0] * float(SPS), phase0,
                                   ctx)
        if not hw:
            return sr, si
        return sr, si, qpsk_panels_plain(re, im, hw)
    sr, si = _launch_symbols(re, im, ctx, md, phase0=phase0,
                             scalars=(_mf_shift_rows(mf), w, lag, shift2),
                             count=("qpsk_symbol_gemm_scalars",))
    panels = _launch_panels(re, im, hw) if hw else None
    return (sr, si) if not hw else (sr, si, panels)


def qpsk_panels(re, im, panels_hw: int):
    """Panels only: the ``TimingEstimator.corr_panels`` tuple ``(P1, P2,
    P3, P4, meta)`` of the raw planes at halfwidth ``panels_hw``, with
    the kernel's contract on N.  ``meta`` holds the shapes only."""
    md = 3 * SPS + 32 - 1          # any legal md; the taps are unused
    z = torch.zeros(md, dtype=torch.float32, device=re.device)
    if int(panels_hw) <= 0:
        raise ValueError(f"panels_hw must be in (0, 64], got {panels_hw}")
    return qpsk_symbol_gemm(re, im, z, z, 0.0, panels_hw=panels_hw,
                            _sym_on=False,
                            _panels_count=("qpsk_symbol_gemm",
                                           "qpsk_panels"))


# ---- the plain versions

def _mod_2pi(x):
    return torch.remainder(x, _TWO_PI)


def qpsk_symbol_plain(re, im, fr, fi, ws, phase0=0.0, ctx=None):
    """The symbol kernel's function in plain PyTorch, on any device:
    the complex-tap decimating product of ``ops.fir`` (with the carried
    context concatenated, a zero tail of 4) and the de-rotation by the
    kernel's float32 angle decomposition.  Returns ``(sr, si)``."""
    dev = re.device
    sr_all, si_all = _fir.fir_decimate_traced_planar_complex(
        re, im, fr.to(dev, torch.float32), fi.to(dev, torch.float32), SPS,
        tail_zeros=SPS, ctx=ctx)
    sr, si = sr_all[1:], si_all[1:]
    wsm = _mod_2pi(_scalar(ws, dev)[0])
    w128 = _mod_2pi(wsm * 128.0)
    s = torch.arange(sr.shape[0], device=dev)
    g = torch.div(s, _STEP_SYMS, rounding_mode="floor")
    rem = s - g * _STEP_SYMS
    base = _mod_2pi(_scalar(phase0, dev)[0] + wsm
                    + w128 * float(_ROWS) * g.to(torch.float32))
    ang = (base + w128 * torch.div(rem, _LANES, rounding_mode="floor")
           .to(torch.float32)) + wsm * (rem % _LANES).to(torch.float32)
    c, sn = torch.cos(ang), torch.sin(ang)
    return sr * c + si * sn, si * c - sr * sn


def modulated_taps_plain(mf_taps, w, lag, shift2, device, sps: int = SPS):
    """conv(cubic Lagrange at t0 = shift2 + sps, mf) modulated by
    e^{j*w*t}, zero-padded to a multiple of sps: ``(fr, fi)``.  At sps 4
    these are the taps the ``_scalars`` kernel builds.  ``w``, ``lag``
    and ``shift2`` may be tensors on ``device``; nothing is read on the
    host."""
    mf = np.asarray(mf_taps, np.float32)
    T = mf.shape[0]
    md = -(-(3 * sps + T - 1) // sps) * sps
    # flat[m] = sum_s a_s * mf[m - s], a_s = lag[s - t0] (0 outside)
    rows = np.zeros((3 * sps, md), np.float32)
    for k in range(3 * sps):
        rows[k, k:k + T] = mf
    t0 = _int_scalar(shift2, device) + sps
    j = _build.device_index(np.arange(3 * sps), device) - t0
    lag = torch.as_tensor(lag, dtype=torch.float32, device=device)
    a = torch.where((j >= 0) & (j < 4),
                    torch.take(lag, j.clamp(0, 3)), torch.zeros_like(lag[0]))
    flat = (a[:, None] * _build.device_constant(rows, device)).sum(0)
    ang = _scalar(w, device)[0] * _build.device_constant(
        np.arange(md, dtype=np.float32), device)
    return flat * torch.cos(ang), flat * torch.sin(ang)


def qpsk_panels_plain(re, im, panels_hw: int):
    """The panel kernel's function in plain PyTorch: the
    ``corr_panels`` products (float32, TF32 off), with the kernel's
    ``meta`` (shapes only)."""
    P1, P2, P3, P4, _ = _demod.corr_panels(re, im, int(panels_hw))
    return P1, P2, P3, P4, _panel_meta(int(re.shape[0]), int(panels_hw))
