"""Complex mixer, NCO and carrier de-rotation on tensors.

Counterpart of :mod:`comms_tpu.ops.mixer`:

* the mixer, ``y[n] = x[n] * exp(j*(phase0 + n*dphase))``, as a ramp
  precomputed on the host in float64 (``n*dphase mod 2*pi`` loses
  nothing at any block position) times the carried phasor;
* the NCO, ``phase += dphase + perr[k]`` then ``exp(j*phase)``, as a
  cumulative sum of the phase errors and one elementwise ``exp``;
* the drift-free carried phase: a 64-bit fixed-point fraction of 2*pi
  in two 32-bit words (hi, lo), advanced per block by an exact modular
  add.  The words and the advance are host integers (the advance is a
  host constant of the block shape), so the add costs no device work
  and reads nothing back; the float32 angle is the sum of the JAX
  package's three float32 products;
* de-rotation by a frequency held in a tensor
  (``derotate_traced(_planar)``): cos/sin are taken on two small
  vectors, a row angle ``freq*128*r + phase0`` for r < ceil(N/128) and
  a column angle ``freq*s`` for s < 128, and combined on [R, 128]
  planes by the angle-addition identity.  The split and its float32
  rounding are the JAX package's, operation for operation, so the tests
  can hold the two to 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build

__all__ = [
    "normalize_dphase",
    "mixer_ramp",
    "mixer_block",
    "nco_block",
    "phase_fix_init",
    "advance_fix",
    "add_fix",
    "phase_fix_to_angle",
    "mixer_block_fix",
    "derotate_traced",
    "derotate_traced_planar",
    "scalar",
]

_TWO_PI = 2.0 * np.pi
_M32 = 0xFFFFFFFF


def normalize_dphase(dphase: float) -> float:
    """Wrap dphase to [0, 2*pi) in float64 (the reference's Mixer::new)."""
    return float(np.mod(np.float64(dphase), _TWO_PI))


def mixer_ramp(n: int, dphase: float, dtype=np.complex64):
    """Host unit ramp ``exp(j * (k*dphase mod 2*pi))`` for k in [0, n)
    and the per-block advance ``n*dphase mod 2*pi``, both in float64
    before the cast.  Returns ``(ramp[n] ndarray, advance float)``."""
    dphase = np.float64(normalize_dphase(dphase))
    k = np.arange(n, dtype=np.float64)
    ramp = np.exp(1j * np.mod(k * dphase, _TWO_PI)).astype(dtype)
    advance = float(np.mod(np.float64(n) * dphase, _TWO_PI))
    return ramp, advance


def _expj(phase):
    """``exp(j*phase)`` of a float32 tensor, complex64."""
    return torch.polar(torch.ones_like(phase), phase)


def mixer_block(x, phase, ramp, advance):
    """Mix one block: ``y[k] = x[k] * exp(j*(phase + k*dphase))``.

    ``phase`` is the carried float32 0-d tensor (wrapped); ``ramp`` and
    ``advance`` come from :func:`mixer_ramp` for ``len(x)``.  Sample k
    sees ``phase0 + k*dphase`` (the phase steps after the multiply).
    Returns ``(y, new_phase)``."""
    phase = phase.to(torch.float32)
    r = _build.device_constant(ramp, x.device, np.complex64)
    y = x * (_expj(phase).to(x.dtype) * r)
    new_phase = torch.remainder(phase + np.float32(advance),
                                np.float32(_TWO_PI))
    return y, new_phase


def nco_block(perr, phase, dphase: float):
    """Run a block of phase errors through the NCO: output k carries
    ``phase0 + (k+1)*dphase + cumsum(perr)[k]``.  Returns ``(iq,
    new_phase)`` with ``new_phase`` wrapped."""
    dphase = normalize_dphase(dphase)
    n = perr.shape[0]
    k_dph = np.mod(np.arange(1, n + 1, dtype=np.float64)
                   * np.float64(dphase), _TWO_PI).astype(np.float32)
    ph = (phase.to(perr.dtype)
          + _build.device_constant(k_dph, perr.device).to(perr.dtype)
          + torch.cumsum(perr, 0))
    iq = _expj(ph)
    new_phase = torch.remainder(ph[-1], np.float32(_TWO_PI)).to(phase.dtype)
    return iq, new_phase


# ------------------------- fixed-point carried phase -------------------
# (hi, lo) host integers: a fraction of 2*pi in 64 bits.

_C_16 = np.float32(2.0 * np.pi / 2.0 ** 16)
_C_32 = np.float32(2.0 * np.pi / 2.0 ** 32)
_C_LO = np.float32(2.0 * np.pi / 2.0 ** 64)


def _fix_words(phase: float, n: int = 1):
    frac = float(np.mod(np.float64(n) * np.float64(phase), _TWO_PI)) \
        / _TWO_PI
    q = int(round(frac * 2.0 ** 64)) % (1 << 64)
    return (q >> 32, q & _M32)


def phase_fix_init(phase0: float = 0.0):
    """Initial (hi, lo) fixed-point phase."""
    return _fix_words(phase0)


def advance_fix(n: int, dphase: float):
    """Per-block advance ``n*dphase mod 2*pi`` as (hi, lo) words."""
    return _fix_words(normalize_dphase(dphase), int(n))


def add_fix(p, a):
    """(hi, lo) + (hi, lo) with exact 64-bit wraparound."""
    lo = int(p[1]) + int(a[1])
    hi = (int(p[0]) + int(a[0]) + (lo >> 32)) & _M32
    return (hi, lo & _M32)


def phase_fix_to_angle(p) -> np.float32:
    """Fixed-point phase -> float32 radians in [0, 2*pi): the hi word in
    16-bit halves (exact in float32) and the lo word, each times its
    float32 weight, summed in float32 (~1e-7 rad, not accumulating)."""
    hi, lo = int(p[0]), int(p[1])
    return (np.float32(hi >> 16) * _C_16 + np.float32(hi & 0xFFFF) * _C_32
            + np.float32(lo) * _C_LO)


def mixer_block_fix(x, pfix, ramp, adv_fix):
    """Drift-free mixer block: :func:`mixer_block` with the fixed-point
    phase of :func:`phase_fix_init`, advanced by ``adv_fix`` from
    :func:`advance_fix`.  ``ramp``: the host ramp, or a tensor of it on
    ``x``'s device that the caller resolved once.  Returns ``(y,
    new_pfix)``."""
    phi0 = phase_fix_to_angle(pfix)
    phasor = complex(np.complex64(np.exp(1j * np.float32(phi0))))
    r = (ramp if isinstance(ramp, torch.Tensor)
         else _build.device_constant(ramp, x.device, np.complex64))
    y = x * (phasor * r).to(x.dtype)
    return y, add_fix(pfix, adv_fix)


def scalar(v, device) -> torch.Tensor:
    """``v`` as a 0-d float32 tensor on ``device``: a tensor is cast in
    place, a number is written by a fill kernel (no host-to-device copy,
    which would synchronise)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def derotate_traced_planar(xr, xi, freq, phase0=0.0):
    """``(yr, yi)`` = planes of ``(xr + j*xi) * exp(-j*(phase0 +
    freq*k))``; ``freq`` and ``phase0`` are numbers or 0-d tensors on
    the planes' device (they stay there: nothing is read on the
    host)."""
    n = xr.shape[0]
    R = -(-n // 128)
    pad = R * 128 - n
    dev = xr.device
    freq = scalar(freq, dev)
    phase0 = scalar(phase0, dev)
    a = (freq * 128.0 * torch.arange(R, dtype=torch.float32, device=dev)
         + phase0)
    b = freq * torch.arange(128, dtype=torch.float32, device=dev)
    ca, sa = torch.cos(a)[:, None], torch.sin(a)[:, None]
    cb, sb = torch.cos(b)[None, :], torch.sin(b)[None, :]
    c = ca * cb - sa * sb               # cos(phase0 + freq*k)
    s = sa * cb + ca * sb               # sin(phase0 + freq*k)
    x2r = torch.nn.functional.pad(xr, (0, pad)).reshape(R, 128)
    x2i = torch.nn.functional.pad(xi, (0, pad)).reshape(R, 128)
    yr = x2r * c + x2i * s              # x * (c - j*s)
    yi = x2i * c - x2r * s
    return yr.reshape(-1)[:n], yi.reshape(-1)[:n]


def derotate_traced(x, freq, phase0=0.0):
    """Complex form of :func:`derotate_traced_planar`."""
    yr, yi = derotate_traced_planar(x.real.contiguous(),
                                    x.imag.contiguous(), freq, phase0)
    return torch.complex(yr, yi)
