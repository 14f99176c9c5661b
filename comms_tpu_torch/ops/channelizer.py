"""Critically-sampled polyphase DFT-filterbank channelizer.

Counterpart of :mod:`comms_tpu.ops.channelizer`.  Channel k's stream is

    y_k[m] = decimate_K( FIR(h, x * exp(-j*2*pi*k*n/K)) )[m]
           = sum_n h[n] * x[m*K - n] * exp(+j*2*pi*k*n/K)

computed for all K channels at once: branch filters
``V[m, c] = sum_k C[k-1, c] * xe[(m+M-k)*K + c]`` (``C`` from
:func:`branch_taps`, the tap reversal folded in), then a K-point DFT
across the branch axis with the branch-reversal phase folded in:

    y[m, ch] = sum_c V[m, c] * exp(-2i*pi*ch*(c+1)/K)

Both stages are matrix products here, as in the JAX package: the branch
stage a banded product over the flattened output stream
(:func:`comms_tpu_torch.ops.fir.piece_dots_accum`), the DFT a
block-diagonal [P, P] product on the same [R, P] rows.  For K > 256 the
per-branch MAC (:func:`comms_tpu_torch.ops.fir.poly_mac_frames`) and
``torch.fft.fft`` take over.  The products are ``torch.matmul`` in the
inputs' precision; TF32 stays off (PyTorch's default), since it would
put ~1e-3 of error into float32 results.

Carried state: the last T-1 input samples.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comms_tpu_torch.ops import fir as _fir

__all__ = [
    "design_prototype",
    "branch_taps",
    "channelizer_init_ctx",
    "channelize_block",
    "channelize_block_planar",
    "channelize_oracle",
]

# DFT-by-matmul cutover: above this K the batched FFT wins (K MACs vs
# log K per sample).
_DFT_MATMUL_MAX_K = 256


def design_prototype(num_channels: int, taps_per_branch: int) -> np.ndarray:
    """Hamming-windowed sinc lowpass, cutoff 1/(2K), unit DC gain,
    length K * taps_per_branch (host, float64)."""
    K, M = int(num_channels), int(taps_per_branch)
    T = K * M
    n = np.arange(T, dtype=np.float64) - (T - 1) / 2.0
    h = np.sinc(n / K)
    h *= np.hamming(T)
    return h / h.sum()


def branch_taps(prototype, num_channels: int) -> np.ndarray:
    """h[T] -> coefficient matrix [M, K] for :func:`channelize_block`
    (tap reversal pre-applied).  T must be a multiple of K."""
    h = np.asarray(prototype)
    K = int(num_channels)
    if h.shape[0] % K:
        raise ValueError(f"prototype length {h.shape[0]} not a multiple "
                         f"of num_channels {K}")
    return _fir.decimating_branch_taps(h, K)


def channelizer_init_ctx(prototype_len: int, dtype=torch.complex64,
                         device="cuda"):
    """Zero carried context of T-1 input samples."""
    return torch.zeros((int(prototype_len) - 1,), dtype=dtype,
                       device=device)


def _branch_phases(K: int) -> int:
    """Output phases per product row: the multiple of K nearest 128
    (K | P makes the coefficient of output o depend on o mod P only)."""
    return K * max(1, 128 // K)


def _branch_banded_matrix(C: np.ndarray, phases: int) -> np.ndarray:
    """B[i, p] = C[k-1, p % K] at i = p + (M-k)*K (0 elsewhere): one
    product row of the flattened output stream covers P outputs,
    V_flat[r*P + p] = sum_i xe[r*P + i] * B[i, p].  Host-side."""
    C = np.asarray(C)
    M, K = C.shape
    P = int(phases)
    if P % K:
        raise ValueError(f"phases {P} must be a multiple of K={K}")
    width = (M - 1) * K + P
    i = np.arange(width)[:, None]
    p = np.arange(P)[None, :]
    j = i - p                       # = (M-k)*K for the valid band
    valid = (j >= 0) & (j % K == 0) & (j // K < M)
    krow = np.where(valid, M - 1 - np.minimum(j // K, M - 1), 0)
    return np.where(valid, C[krow, p % K], 0).astype(C.dtype)


def _dft_blockdiag_matrix(K: int, P: int) -> np.ndarray:
    """[P, P] block-diagonal stack of P//K copies of the DFT with the
    fix-up phase, F[c, ch] = e^{-2i pi ch (c+1) / K}.  Host-side f64."""
    c = np.arange(K)[:, None]
    ch = np.arange(K)[None, :]
    F = np.exp(-2j * np.pi * ch * (c + 1) / K)
    BD = np.zeros((P, P), np.complex128)
    for j in range(P // K):
        BD[j * K:(j + 1) * K, j * K:(j + 1) * K] = F
    return BD


@functools.lru_cache(maxsize=32)
def _cached_mats(raw: bytes, shape: tuple, np_dtype: str, dtype: torch.dtype,
                 device: str):
    """(branch band, DFT real part, DFT imaginary part) on ``device`` in
    ``dtype``: built and copied once per coefficient content."""
    C = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    K = shape[1]
    P = _branch_phases(K)
    B = _branch_banded_matrix(C, P)
    BD = _dft_blockdiag_matrix(K, P)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
        device=device, dtype=dtype)
    return to(B), to(BD.real), to(BD.imag)


def _fft_fix(y):
    """Multiply FFT output [frames, K] by the branch-reversal phase
    e^{-2i pi ch / K}."""
    K = y.shape[1]
    fix = np.exp(-2j * np.pi * np.arange(K) / K)
    return y * torch.from_numpy(fix).to(device=y.device, dtype=y.dtype)


def _channelize_planar_core(re, im, C, ctx_re, ctx_im):
    """Both stages on re/im planes.  Returns
    ``(yr[frames, K], yi[frames, K], new_ctx_re, new_ctx_im)``."""
    C = np.asarray(C)
    M, K = C.shape
    N = int(re.shape[0])
    if N % K:
        raise ValueError(f"block {N} not a multiple of channels {K}")
    frames = N // K
    if K > _DFT_MATMUL_MAX_K:
        # The banded branch product costs ~M*K MACs per sample here;
        # the M-MAC per-branch form plus a batched FFT is cheaper.
        x = torch.complex(re, im)
        ctx = torch.complex(ctx_re.to(re.dtype), ctx_im.to(im.dtype))
        V, nctx = _fir.poly_mac_frames(x, C, ctx)
        y = _fft_fix(torch.fft.fft(V, dim=1))
        return y.real, y.imag, nctx.real, nctx.imag
    P = _branch_phases(K)
    width = (M - 1) * K + P
    c = np.ascontiguousarray(C)
    B, BDr, BDi = _cached_mats(c.tobytes(), c.shape, c.dtype.str, re.dtype,
                               str(re.device))
    R = -(-N // P)                   # cdiv over flattened outputs
    last_off = P * ((width - 1) // P)
    Tm1 = M * K - 1
    pad = max(last_off + R * P - (Tm1 + N), 0)
    rows = []
    for plane, ctx in ((re, ctx_re), (im, ctx_im)):
        xpad = torch.cat([ctx.to(plane.dtype), plane,
                          plane.new_zeros(pad)])
        rows.append(_fir.piece_dots_accum(xpad, [B], R, P, width)[0])
    Vr, Vi = rows
    nre = torch.cat([ctx_re.to(re.dtype), re])[-Tm1:]
    nim = torch.cat([ctx_im.to(im.dtype), im])[-Tm1:]
    Yr = Vr @ BDr - Vi @ BDi
    Yi = Vr @ BDi + Vi @ BDr
    yr = Yr.reshape(R * P)[:N].reshape(frames, K)
    yi = Yi.reshape(R * P)[:N].reshape(frames, K)
    return yr, yi, nre, nim


def channelize_block(x, Hb, ctx):
    """Channelize one block.

    Args:
      x: [N] complex (or real), N % K == 0.
      Hb: [M, K] branch-tap matrix from :func:`branch_taps`.
      ctx: carried [M*K - 1] input tail.

    Returns ``(y[N//K, K], new_ctx)``: frame m, channel k.
    """
    C = np.asarray(Hb)
    out_dtype = torch.promote_types(x.dtype, torch.complex64)
    real_dtype = torch.empty(0, dtype=out_dtype).real.dtype
    if x.is_complex():
        re, im = x.real, x.imag
    else:
        re, im = x, torch.zeros_like(x)
    if ctx.is_complex():
        cre, cim = ctx.real, ctx.imag
    else:
        cre, cim = ctx, torch.zeros_like(ctx)
    yr, yi, nre, nim = _channelize_planar_core(
        re.to(real_dtype), im.to(real_dtype), C,
        cre.to(real_dtype), cim.to(real_dtype))
    new_ctx = torch.complex(nre, nim).to(ctx.dtype) if ctx.is_complex() \
        else nre.to(ctx.dtype)
    return torch.complex(yr, yi).to(out_dtype), new_ctx


def channelize_block_planar(re, im, Hb, ctx_re, ctx_im):
    """Plane-native :func:`channelize_block`: float re/im planes in,
    ``(yr[frames, K], yi[frames, K], new_ctx_re, new_ctx_im)`` out, with
    no complex tensor on the way (except past the K > 256 cutover)."""
    return _channelize_planar_core(re, im, np.asarray(Hb), ctx_re, ctx_im)


def channelize_oracle(x, prototype, num_channels: int) -> np.ndarray:
    """Direct per-channel mix->FIR->decimate oracle (float64 host).
    For tests: must equal :func:`channelize_block` from zero context."""
    x = np.asarray(x, dtype=np.complex128)
    h = np.asarray(prototype, dtype=np.float64)
    K = int(num_channels)
    N = len(x)
    out = np.zeros((N // K, K), dtype=np.complex128)
    n = np.arange(N)
    for k in range(K):
        z = x * np.exp(-2j * np.pi * k * n / K)
        w = np.convolve(z, h)[:N]  # causal FIR, zero initial state
        out[:, k] = w[::K][: N // K]
    return out
