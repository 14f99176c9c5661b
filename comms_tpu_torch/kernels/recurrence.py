"""The receive chain's sequential loops: one CUDA source, two entries, and
their plain versions.

* :func:`costas_loop` is the decision-directed Costas loop of
  :func:`comms_tpu.ops.demodulation.costas_loop_block` (order M, 4 for
  QPSK): per symbol ``c = s e^{-j ph}``, ``err = atan2(Im, Re)(-c^M) /
  M`` (``c^M`` by XLA's ``integer_pow`` expansion, :func:`complex_ipow`),
  ``fr += beta err``, ``ph = (ph + fr) + alpha err``; the output is
  ``c``.
* :func:`agc_scan` is the per-sample AGC of
  :func:`comms_tpu.ops.agc.agc_scan`: ``y = s g``, ``g *= exp(rate
  log(target / (|y| + 1e-12)))``.

Neither replaces a Pallas kernel: the JAX package runs both as
``lax.scan`` loops, and their carried value feeds the next step through a
nonlinear function, so they have no parallel form.  ``csrc/recurrence.cu``
walks a whole block in one launch (module docstring there: the design and
its bound, the latency of the dependent chain).  Inputs and outputs are
float32 planes (1-D, one common element stride, so the re/im views of a
complex tensor pass as they are); the state is float32 0-d tensors,
read and written on the device, so a call never synchronises with the
host.

The wrappers launch the kernels for CUDA tensors and run the plain
versions (:func:`costas_loop_plain`, :func:`agc_scan_plain`: one PyTorch
operation a step, in the kernel's order and rounding) for CPU tensors;
any other device raises.  The launches are ``torch.library`` custom ops
with a per-slice vmap rule (``_build.per_slice_vmap``), so
``torch.func.vmap`` lifts a step that calls them.  ``launches`` counts
the kernel launches per entry.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build

__all__ = ["costas_loop", "costas_loop_plain", "agc_scan",
           "agc_scan_plain", "complex_ipow"]

# Kernel launches per entry since import (or since a caller reset them).
launches = {"costas_loop": 0, "agc_scan": 0}


def _check(xr, xi, *state):
    for name, p in (("xr", xr), ("xi", xi)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.float32 or p.ndim != 1:
            raise ValueError(f"{name} must be a 1-D float32 tensor, got "
                             f"{p.dtype} {tuple(p.shape)}")
    if xr.shape != xi.shape or xr.device != xi.device:
        raise ValueError("xr and xi must share a length and a device")
    if xr.shape[0] > 1 and xr.stride(0) != xi.stride(0):
        raise ValueError("xr and xi must share an element stride")
    for v in state:
        if (not isinstance(v, torch.Tensor) or v.dtype != torch.float32
                or v.numel() != 1 or v.device != xr.device):
            raise ValueError("the carried state must be float32 scalars "
                             "on the planes' device")
    if xr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the recurrence kernels run on CUDA or CPU "
                         f"tensors, got {xr.device}")


def _stride(x) -> int:
    return int(x.stride(0)) if x.shape[0] > 1 else 1


@torch.library.custom_op(
    "comms_tpu_torch::costas_loop", mutates_args=(), device_types="cuda",
    schema="(Tensor xr, Tensor xi, Tensor phase, Tensor freq, int order, "
           "float alpha, float beta) -> (Tensor, Tensor, Tensor, Tensor)")
def _costas_op(xr, xi, phase, freq, order, alpha, beta):
    lib = _build.load()
    n = int(xr.shape[0])
    yr = torch.empty(n, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    ph = torch.empty((), dtype=torch.float32, device=xr.device)
    fr = torch.empty_like(ph)
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.costas_loop_launch(
            xr.data_ptr(), xi.data_ptr(), _stride(xr), n, phase.data_ptr(),
            freq.data_ptr(), order, alpha, beta, yr.data_ptr(),
            yi.data_ptr(), 1, ph.data_ptr(), fr.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"Costas loop kernel launch failed: CUDA error "
                           f"{rc}")
    launches["costas_loop"] += 1
    return yr, yi, ph, fr


@torch.library.custom_op(
    "comms_tpu_torch::agc_scan", mutates_args=(), device_types="cuda",
    schema="(Tensor xr, Tensor xi, Tensor gain, float target, float rate) "
           "-> (Tensor, Tensor, Tensor)")
def _agc_op(xr, xi, gain, target, rate):
    lib = _build.load()
    n = int(xr.shape[0])
    yr = torch.empty(n, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    g = torch.empty((), dtype=torch.float32, device=xr.device)
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.agc_scan_launch(
            xr.data_ptr(), xi.data_ptr(), _stride(xr), n, gain.data_ptr(),
            target, rate, yr.data_ptr(), yi.data_ptr(), 1, g.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"AGC scan kernel launch failed: CUDA error {rc}")
    launches["agc_scan"] += 1
    return yr, yi, g


_build.per_slice_vmap(_costas_op)
_build.per_slice_vmap(_agc_op)


def _f32(v) -> float:
    return float(np.float32(v))


def complex_ipow(xr, xi, m: int):
    """``(xr + j xi)^m`` on planes, m >= 1, as XLA's ``integer_pow``
    expands it (the JAX package's ``x ** m``): the accumulator takes x at
    each set bit of m (``acc * x``), x squares between bits, each complex
    product in XLA's order ``(ar*br - ai*bi, ar*bi + ai*br)``."""
    m = int(m)
    if m < 1:
        raise ValueError(f"the power must be at least 1, got {m}")
    acc = None
    while m > 0:
        if m & 1:
            acc = (xr, xi) if acc is None else (
                acc[0] * xr - acc[1] * xi, acc[0] * xi + acc[1] * xr)
        m >>= 1
        if m > 0:
            xr, xi = xr * xr - xi * xi, xr * xi + xi * xr
    return acc


def costas_loop(xr, xi, phase, freq, alpha: float, beta: float,
                order: int = 4):
    """Costas loop of order ``order`` over one block of symbol planes
    ``xr, xi`` from the carried ``(phase, freq)`` float32 scalars.
    Returns ``(yr, yi, phase, freq)``: the corrected symbol planes and the
    new state."""
    _check(xr, xi, phase, freq)
    phase, freq = phase.reshape(()), freq.reshape(())
    if int(order) < 1:
        raise ValueError(f"order must be at least 1, got {order}")
    if xr.device.type == "cpu":
        return costas_loop_plain(xr, xi, phase, freq, alpha, beta, order)
    return _costas_op(xr, xi, phase, freq, int(order), _f32(alpha),
                      _f32(beta))


def agc_scan(xr, xi, gain, target: float = 1.0, rate: float = 1e-2):
    """Per-sample AGC over one block of sample planes ``xr, xi`` from the
    carried float32 ``gain``.  Returns ``(yr, yi, gain)``."""
    _check(xr, xi, gain)
    gain = gain.reshape(())
    if xr.device.type == "cpu":
        return agc_scan_plain(xr, xi, gain, target, rate)
    return _agc_op(xr, xi, gain, _f32(target), _f32(rate))


def costas_loop_plain(xr, xi, phase, freq, alpha: float, beta: float,
                      order: int = 4):
    """The Costas kernel's function in plain PyTorch, one operation a
    step on 0-d float32 tensors, on any device: the kernel's order and
    rounding (the complex products as XLA evaluates them; no fused
    multiply-adds)."""
    a = torch.tensor(_f32(alpha), device=xr.device)
    b = torch.tensor(_f32(beta), device=xr.device)
    m = float(int(order))
    ph = phase.reshape(()).to(torch.float32)
    fr = freq.reshape(()).to(torch.float32)
    yr, yi = [], []
    for sr, si in zip(xr.unbind(0), xi.unbind(0)):
        c, s = torch.cos(ph), torch.sin(ph)
        ar = sr * c + si * s
        ai = si * c - sr * s
        qr, qi = complex_ipow(ar, ai, order)
        err = torch.atan2(-qi, -qr) / m
        fr = fr + b * err
        ph = (ph + fr) + a * err
        yr.append(ar)
        yi.append(ai)
    if not yr:
        empty = xr.new_zeros(0)
        return empty, empty.clone(), ph, fr
    return torch.stack(yr), torch.stack(yi), ph, fr


def agc_scan_plain(xr, xi, gain, target: float = 1.0, rate: float = 1e-2):
    """The AGC kernel's function in plain PyTorch, one operation a step on
    0-d float32 tensors, on any device, in the kernel's order."""
    t = torch.tensor(_f32(target), device=xr.device)
    r = torch.tensor(_f32(rate), device=xr.device)
    eps = torch.tensor(_f32(1e-12), device=xr.device)
    g = gain.reshape(()).to(torch.float32)
    yr, yi = [], []
    for sr, si in zip(xr.unbind(0), xi.unbind(0)):
        ar = sr * g
        ai = si * g
        err = torch.log(t / (torch.hypot(ar, ai) + eps))
        g = g * torch.exp(r * err)
        yr.append(ar)
        yi.append(ai)
    if not yr:
        empty = xr.new_zeros(0)
        return empty, empty.clone(), g
    return torch.stack(yr), torch.stack(yi), g
