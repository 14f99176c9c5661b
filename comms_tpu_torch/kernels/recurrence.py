"""The receive chain's sequential loops: one CUDA source, two kernels over
a batch of streams, and their plain versions.

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
nonlinear function, so a stream has no parallel form.
``csrc/recurrence.cu`` walks B streams in one launch, one lane a stream
(module comment there: the design, the staging and the bound).  The
single-stream entries take float32 planes ``[n]`` and 0-d states; the
``_batched`` entries planes ``[B, n]`` and states ``[B]``.  Planes pass
with any strides (the re/im views of a complex tensor as they are); the
state is read and written on the device, so a call never synchronises
with the host.

The wrappers launch the kernels for CUDA tensors and run the plain
versions (:func:`costas_loop_plain`, :func:`agc_scan_plain`,
:func:`costas_loop_batched_plain`, :func:`agc_scan_batched_plain`: one
PyTorch operation a step, in the kernel's order and rounding) for CPU
tensors; any other device raises.  Each kernel is one
``torch.library`` custom op over ``[B, n]`` planes, whose vmap rule
moves the vmapped axis to the front of the stream axis (expanding an
argument that is not batched) and launches once: ``torch.func.vmap`` of
a step that calls :func:`costas_loop` is one launch for all its streams.
``launches`` counts the kernel launches per entry.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build

__all__ = ["costas_loop", "costas_loop_batched", "costas_loop_plain",
           "costas_loop_batched_plain", "agc_scan", "agc_scan_batched",
           "agc_scan_plain", "agc_scan_batched_plain", "complex_ipow"]

# Kernel launches per entry since import (or since a caller reset them).
launches = {"costas_loop": 0, "agc_scan": 0}


def _check(xr, xi, ndim: int, *state):
    for name, p in (("xr", xr), ("xi", xi)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.float32 or p.ndim != ndim:
            raise ValueError(f"{name} must be a {ndim}-D float32 tensor, "
                             f"got {p.dtype} {tuple(p.shape)}")
    if xr.shape != xi.shape or xr.device != xi.device:
        raise ValueError("xr and xi must share a length, a shape and a "
                         "device")
    streams = 1 if ndim == 1 else xr.shape[0]
    for v in state:
        if (not isinstance(v, torch.Tensor) or v.dtype != torch.float32
                or v.numel() != streams or v.device != xr.device):
            raise ValueError(f"the carried state must be float32 scalars, "
                             f"one a stream ({streams}), on the planes' "
                             f"device")
    if xr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the recurrence kernels run on CUDA or CPU "
                         f"tensors, got {xr.device}")


def _plane_strides(x):
    """``(row stride, element stride)`` of a ``[B, n]`` plane; 0 along an
    axis of length 1, which the kernel never steps along."""
    B, n = x.shape
    return (int(x.stride(0)) if B > 1 else 0,
            int(x.stride(1)) if n > 1 else 0)


def _state_stride(v) -> int:
    return int(v.stride(0)) if v.shape[0] > 1 else 0


def _outputs(xr, states: int):
    B, n = xr.shape
    y = [torch.empty((B, n), dtype=torch.float32, device=xr.device)
         for _ in range(2)]
    s = [torch.empty(B, dtype=torch.float32, device=xr.device)
         for _ in range(states)]
    return y, s


def _raise(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


@torch.library.custom_op(
    "comms_tpu_torch::costas_loop", mutates_args=(), device_types="cuda",
    schema="(Tensor xr, Tensor xi, Tensor phase, Tensor freq, int order, "
           "float alpha, float beta) -> (Tensor, Tensor, Tensor, Tensor)")
def _costas_op(xr, xi, phase, freq, order, alpha, beta):
    lib = _build.load()
    (yr, yi), (ph, fr) = _outputs(xr, 2)
    B, n = xr.shape
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        _raise(lib.costas_loop_launch(
            xr.data_ptr(), xi.data_ptr(), *_plane_strides(xr),
            *_plane_strides(xi), B, n, phase.data_ptr(),
            _state_stride(phase), freq.data_ptr(), _state_stride(freq),
            order, alpha, beta, yr.data_ptr(), yi.data_ptr(), ph.data_ptr(),
            fr.data_ptr(), stream), "Costas loop")
    if B:
        launches["costas_loop"] += 1
    return yr, yi, ph, fr


@torch.library.custom_op(
    "comms_tpu_torch::agc_scan", mutates_args=(), device_types="cuda",
    schema="(Tensor xr, Tensor xi, Tensor gain, float target, float rate) "
           "-> (Tensor, Tensor, Tensor)")
def _agc_op(xr, xi, gain, target, rate):
    lib = _build.load()
    (yr, yi), (g,) = _outputs(xr, 1)
    B, n = xr.shape
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        _raise(lib.agc_scan_launch(
            xr.data_ptr(), xi.data_ptr(), *_plane_strides(xr),
            *_plane_strides(xi), B, n, gain.data_ptr(), _state_stride(gain),
            target, rate, yr.data_ptr(), yi.data_ptr(), g.data_ptr(),
            stream), "AGC scan")
    if B:
        launches["agc_scan"] += 1
    return yr, yi, g


def batched_vmap_rule(op):
    """The vmap rule of a recurrence op (every tensor argument has the
    stream axis first): the vmapped axis goes in front of the stream axis
    (an argument that is not batched is expanded, a stride-0 view), the
    two are flattened into one, and the op launches once over all the
    streams; its outputs are split back."""
    def rule(info, in_dims, *args):
        V = info.batch_size
        flat, streams = [], None
        for a, d in zip(args, in_dims):
            if isinstance(a, torch.Tensor):
                a = a.movedim(d, 0) if d is not None else a.expand(V,
                                                                  *a.shape)
                streams = a.shape[1]
                a = a.flatten(0, 1)
            flat.append(a)
        outs = op(*flat)
        return (tuple(o.unflatten(0, (V, streams)) for o in outs),
                (0,) * len(outs))
    return rule


_costas_op.register_vmap(batched_vmap_rule(_costas_op))
_agc_op.register_vmap(batched_vmap_rule(_agc_op))


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


def _order(order) -> int:
    if int(order) < 1:
        raise ValueError(f"order must be at least 1, got {order}")
    return int(order)


def costas_loop(xr, xi, phase, freq, alpha: float, beta: float,
                order: int = 4):
    """Costas loop of order ``order`` over one block of symbol planes
    ``xr, xi`` [n] from the carried ``(phase, freq)`` float32 scalars.
    Returns ``(yr, yi, phase, freq)``: the corrected symbol planes and the
    new state.  On the card: the batched kernel at B = 1."""
    _check(xr, xi, 1, phase, freq)
    phase, freq = phase.reshape(()), freq.reshape(())
    order = _order(order)
    if xr.device.type == "cpu":
        return costas_loop_plain(xr, xi, phase, freq, alpha, beta, order)
    yr, yi, ph, fr = _costas_op(xr[None], xi[None], phase.reshape(1),
                                freq.reshape(1), order, _f32(alpha),
                                _f32(beta))
    return yr[0], yi[0], ph[0], fr[0]


def costas_loop_batched(xr, xi, phase, freq, alpha: float, beta: float,
                        order: int = 4):
    """:func:`costas_loop` over B streams in one launch: planes ``[B, n]``,
    states ``[B]``; returns ``(yr, yi, phase, freq)`` of those shapes."""
    _check(xr, xi, 2, phase, freq)
    phase, freq = phase.reshape(-1), freq.reshape(-1)
    order = _order(order)
    if xr.device.type == "cpu":
        return costas_loop_batched_plain(xr, xi, phase, freq, alpha, beta,
                                         order)
    return _costas_op(xr, xi, phase, freq, order, _f32(alpha), _f32(beta))


def agc_scan(xr, xi, gain, target: float = 1.0, rate: float = 1e-2):
    """Per-sample AGC over one block of sample planes ``xr, xi`` [n] from
    the carried float32 ``gain``.  Returns ``(yr, yi, gain)``.  On the
    card: the batched kernel at B = 1."""
    _check(xr, xi, 1, gain)
    gain = gain.reshape(())
    if xr.device.type == "cpu":
        return agc_scan_plain(xr, xi, gain, target, rate)
    yr, yi, g = _agc_op(xr[None], xi[None], gain.reshape(1), _f32(target),
                        _f32(rate))
    return yr[0], yi[0], g[0]


def agc_scan_batched(xr, xi, gain, target: float = 1.0, rate: float = 1e-2):
    """:func:`agc_scan` over B streams in one launch: planes ``[B, n]``,
    gains ``[B]``."""
    _check(xr, xi, 2, gain)
    gain = gain.reshape(-1)
    if xr.device.type == "cpu":
        return agc_scan_batched_plain(xr, xi, gain, target, rate)
    return _agc_op(xr, xi, gain, _f32(target), _f32(rate))


def _costas_step(sr, si, ph, fr, a, b, order: int, m: float):
    """One Costas step on tensors of any shape, in the kernel's order."""
    c, s = torch.cos(ph), torch.sin(ph)
    ar = sr * c + si * s
    ai = si * c - sr * s
    qr, qi = complex_ipow(ar, ai, order)
    err = torch.atan2(-qi, -qr) / m
    fr = fr + b * err
    ph = (ph + fr) + a * err
    return ar, ai, ph, fr


def _agc_step(sr, si, g, t, r, eps):
    """One AGC step on tensors of any shape, in the kernel's order."""
    ar = sr * g
    ai = si * g
    err = torch.log(t / (torch.hypot(ar, ai) + eps))
    return ar, ai, g * torch.exp(r * err)


def _scalars(device, *vals):
    return [torch.tensor(_f32(v), device=device) for v in vals]


def costas_loop_plain(xr, xi, phase, freq, alpha: float, beta: float,
                      order: int = 4):
    """The Costas kernel's function in plain PyTorch, one operation a
    step on 0-d float32 tensors, on any device: the kernel's order and
    rounding (the complex products as XLA evaluates them; no fused
    multiply-adds)."""
    a, b = _scalars(xr.device, alpha, beta)
    ph = phase.reshape(()).to(torch.float32)
    fr = freq.reshape(()).to(torch.float32)
    yr, yi = [], []
    for sr, si in zip(xr.unbind(0), xi.unbind(0)):
        ar, ai, ph, fr = _costas_step(sr, si, ph, fr, a, b, order,
                                      float(int(order)))
        yr.append(ar)
        yi.append(ai)
    if not yr:
        empty = xr.new_zeros(0)
        return empty, empty.clone(), ph, fr
    return torch.stack(yr), torch.stack(yi), ph, fr


def costas_loop_batched_plain(xr, xi, phase, freq, alpha: float,
                              beta: float, order: int = 4):
    """The batched Costas kernel's function in plain PyTorch, one
    operation a step on ``[B]`` tensors (every stream at once), in the
    kernel's order: planes ``[B, n]``, states ``[B]``."""
    a, b = _scalars(xr.device, alpha, beta)
    ph = phase.reshape(-1).to(torch.float32)
    fr = freq.reshape(-1).to(torch.float32)
    yr, yi = [], []
    for sr, si in zip(xr.unbind(1), xi.unbind(1)):
        ar, ai, ph, fr = _costas_step(sr, si, ph, fr, a, b, order,
                                      float(int(order)))
        yr.append(ar)
        yi.append(ai)
    if not yr:
        empty = xr.new_zeros(xr.shape)
        return empty, empty.clone(), ph, fr
    return torch.stack(yr, 1), torch.stack(yi, 1), ph, fr


def agc_scan_plain(xr, xi, gain, target: float = 1.0, rate: float = 1e-2):
    """The AGC kernel's function in plain PyTorch, one operation a step on
    0-d float32 tensors, on any device, in the kernel's order."""
    t, r, eps = _scalars(xr.device, target, rate, 1e-12)
    g = gain.reshape(()).to(torch.float32)
    yr, yi = [], []
    for sr, si in zip(xr.unbind(0), xi.unbind(0)):
        ar, ai, g = _agc_step(sr, si, g, t, r, eps)
        yr.append(ar)
        yi.append(ai)
    if not yr:
        empty = xr.new_zeros(0)
        return empty, empty.clone(), g
    return torch.stack(yr), torch.stack(yi), g


def agc_scan_batched_plain(xr, xi, gain, target: float = 1.0,
                           rate: float = 1e-2):
    """The batched AGC kernel's function in plain PyTorch, one operation a
    step on ``[B]`` tensors, in the kernel's order: planes ``[B, n]``,
    gains ``[B]``."""
    t, r, eps = _scalars(xr.device, target, rate, 1e-12)
    g = gain.reshape(-1).to(torch.float32)
    yr, yi = [], []
    for sr, si in zip(xr.unbind(1), xi.unbind(1)):
        ar, ai, g = _agc_step(sr, si, g, t, r, eps)
        yr.append(ar)
        yi.append(ai)
    if not yr:
        empty = xr.new_zeros(xr.shape)
        return empty, empty.clone(), g
    return torch.stack(yr, 1), torch.stack(yi, 1), g
