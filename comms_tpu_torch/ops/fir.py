"""Streaming FIR filtering as a banded-Toeplitz matrix product.

Counterpart of :mod:`comms_tpu.ops.fir`.  A block of N samples is
filtered as one matrix product

    Y[r, p] = sum_k taps[k] * xext[r*P + p - k + (T-1)]
            = (W @ B)[r, p]

where ``W`` is the windowed input ([R, T+P-1], rows overlapping by
T-1 samples) and ``B`` the banded tap matrix ([T+P-1, P]).  ``W`` is a
``Tensor.unfold`` view of the padded input, not a gather; the product
is ``torch.matmul``.  Real taps on complex input run as two real
products on the re/im planes.

Streaming semantics: the carried state is the last ``T-1`` input
samples (oldest first), so output does not depend on how the stream is
chopped into blocks.

The host helpers (``banded_tap_matrix``, ``decimating_branch_taps``,
``_decimating_banded_matrix``) are numpy, computed once per tap set;
their device copies are cached by content.

The traced decimators (``fir_decimate_traced*``) take their taps as a
device tensor that depends on estimates (the QPSK receiver's
interpolator, timing shift and phase pick folded into one tap vector):
the band matrix is one small gather of it against a host index array
kept on the device, so nothing is read back to the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comms_tpu_torch.kernels import _build

__all__ = [
    "init_ctx",
    "ctx_from_reference_state",
    "banded_tap_matrix",
    "fir_block",
    "fir_apply",
    "fir_decimate_block",
    "fir_apply_planar",
    "decimating_branch_taps",
    "fir_decimate_poly",
    "decimating_band",
    "piece_dots_accum",
    "poly_mac_frames",
    "fir_decimate_traced",
    "fir_decimate_traced_planar",
    "fir_decimate_traced_planar_complex",
]

# Output phases per GEMM row (the JAX package's MXU lane width; kept so
# that both packages build the same band matrices).
_DEFAULT_PHASES = 128

def init_ctx(num_taps: int, dtype=torch.complex64, device="cuda"):
    """Zero carried context (the reference's default zero state)."""
    return torch.zeros(max(num_taps - 1, 0), dtype=dtype, device=device)


def ctx_from_reference_state(state, dtype=torch.complex64, device="cuda"):
    """A reference-style state vector (most-recent-first, length T, its
    last element unused: the reference shifts it out before it ever
    contributes) as carried context (oldest-first, T-1) on ``device``."""
    state = np.asarray(state)
    return torch.as_tensor(np.ascontiguousarray(state[:len(state) - 1][::-1]),
                           dtype=dtype, device=device)


def banded_tap_matrix(taps, phases: int = _DEFAULT_PHASES) -> np.ndarray:
    """Banded Toeplitz matrix B[i, p] = taps[T-1+p-i] (0 outside band).
    Host-side (numpy)."""
    taps = np.asarray(taps)
    T = taps.shape[0]
    P = int(phases)
    i = np.arange(T + P - 1)[:, None]
    p = np.arange(P)[None, :]
    k = T - 1 + p - i
    valid = (k >= 0) & (k < T)
    B = np.where(valid, taps[np.clip(k, 0, T - 1)], 0)
    return B.astype(taps.dtype)


def _band_on(taps: np.ndarray, phases: int, decimating: bool,
             device) -> torch.Tensor:
    """The band matrix of host ``taps`` on ``device``: built and copied
    to the device once per content, phases and device, not per block.
    ``taps`` is a 1-D tap vector or a ready 2-D band (dense), or the
    [M, D] branch matrix of :func:`decimating_branch_taps`."""
    t = np.ascontiguousarray(taps)
    return _cached_band(t.tobytes(), t.shape, t.dtype.str, int(phases),
                        decimating, str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _cached_band(raw: bytes, shape: tuple, np_dtype: str, phases: int,
                 decimating: bool, device: str) -> torch.Tensor:
    t = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    if decimating:
        B = _decimating_banded_matrix(_flat_from_branches(t), shape[1],
                                      phases)
    elif t.ndim == 1:
        B = banded_tap_matrix(t, phases)
    else:
        B = t.copy()
    return torch.from_numpy(B).to(device)


def _window_rows_strided(xpad, rows: int, stride: int, width: int):
    """W[..., r, i] = xpad[..., r*stride + i] for i < width: a strided
    view over the last axis.  Requires xpad.shape[-1] >= (rows -
    1)*stride + width."""
    return xpad.unfold(-1, width, stride)[..., :rows, :]


def _window_rows(xext, rows: int, phases: int, taps_len: int):
    """W[r, :] = xext[r*P : r*P + T+P-1] (row stride == phases)."""
    return _window_rows_strided(xext, rows, phases, taps_len + phases - 1)


def _pad_tail(x, length: int):
    """Zero-extend ``x`` along its last axis to at least ``length``
    samples."""
    pad = length - x.shape[-1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros(*x.shape[:-1], pad)], dim=-1)


def _banded_product(xpad, B, windows):
    """(W @ B) with W = ``windows(xpad)``.  Real taps on complex data:
    two real products on the planes (B is shared)."""
    if xpad.is_complex() and not B.is_complex():
        Br = B.to(xpad.real.dtype)
        return torch.complex(windows(xpad.real) @ Br,
                             windows(xpad.imag) @ Br)
    out_dtype = torch.promote_types(xpad.dtype, B.dtype)
    return windows(xpad.to(out_dtype)) @ B.to(out_dtype)


def fir_block(x, taps, ctx, phases: int = _DEFAULT_PHASES):
    """Filter one block.  Returns (y, new_ctx); y.shape == x.shape.

    ``taps`` may be a host (numpy) 1-D tap vector, or a precomputed
    ``banded_tap_matrix`` (2-D, numpy or tensor) whose band length
    implies T.  Float32 products run in full float32: TF32 stays off
    (``torch.backends.cuda.matmul.allow_tf32`` is False by default and
    nothing here turns it on).
    """
    N = x.shape[0]
    if isinstance(taps, torch.Tensor):
        B = taps.to(x.device)
    else:
        B = _band_on(np.asarray(taps), phases, False, x.device)
    P = B.shape[1]
    T = B.shape[0] - P + 1
    if T == 1:
        out_dtype = torch.promote_types(x.dtype, B.dtype)
        return x.to(out_dtype) * B[0, 0], ctx

    xext = torch.cat([ctx.to(x.dtype), x])            # [T-1 + N]
    new_ctx = xext[-(T - 1):]
    R = -(-N // P)
    width = T + P - 1
    xpad = _pad_tail(xext, (R - 1) * P + width)
    Y = _banded_product(xpad, B,
                        lambda v: _window_rows(v, R, P, T))   # [R, P]
    return Y.reshape(R * P)[:N], new_ctx


def fir_apply(x, taps, phases: int = _DEFAULT_PHASES):
    """Stateless FIR with zero initial context (one-shot convenience):
    ``taps`` as in :func:`fir_block`."""
    t = taps if isinstance(taps, torch.Tensor) else np.asarray(taps)
    T = t.shape[0] if t.ndim == 1 else t.shape[0] - t.shape[1] + 1
    y, _ = fir_block(x, taps, init_ctx(T, dtype=x.dtype, device=x.device),
                     phases=phases)
    return y


def fir_decimate_block(x, taps, ctx, rate: int,
                       phases: int = _DEFAULT_PHASES):
    """FIR then keep every ``rate``-th output, the phase reset each block
    (the reference's DecimateNode, resample_node.rs:53-65).  Returns
    ``(y, new_ctx)``.  The reference's convenience form: the polyphase
    :func:`fir_decimate_poly` is the one for the hot path."""
    y, new_ctx = fir_block(x, taps, ctx, phases=phases)
    if rate in (0, 1):
        return y, new_ctx
    return y[::rate], new_ctx


def fir_apply_planar(xr, xi, B, phases: int = _DEFAULT_PHASES):
    """Real-tap FIR on re/im planes with zero initial context:
    ``(yr, yi)`` out, no complex tensor made.  ``B`` is a real
    :func:`banded_tap_matrix` (2-D numpy array or tensor)."""
    if isinstance(B, torch.Tensor):
        B = B.to(xr.device)
    else:
        B = _band_on(np.asarray(B), phases, False, xr.device)
    P = B.shape[1]
    T = B.shape[0] - P + 1
    N = xr.shape[0]
    Br = B.to(xr.dtype)
    if T == 1:
        return xr * Br[0, 0], xi * Br[0, 0]
    R = -(-N // P)
    width = T + P - 1
    last_off = P * ((width - 1) // P)
    pad_tail = max(last_off + R * P - (T - 1 + N), 0)
    outs = []
    for plane in (xr, xi):
        xpad = torch.nn.functional.pad(plane, (T - 1, pad_tail))
        Y = _window_rows(xpad, R, P, T) @ Br
        outs.append(Y.reshape(R * P)[:N])
    return outs[0], outs[1]


def decimating_branch_taps(taps, rate: int) -> np.ndarray:
    """taps[T] -> C[M, rate] with C[k-1, c] = taps[k*rate - 1 - c]
    (zero where out of range), M = ceil(T/rate).  Host-side."""
    taps = np.asarray(taps)
    D = int(rate)
    M = -(-taps.shape[0] // D)
    flat = np.zeros(M * D, dtype=taps.dtype)
    flat[: taps.shape[0]] = taps
    C = np.zeros((M, D), dtype=taps.dtype)
    for k in range(1, M + 1):
        for c in range(D):
            C[k - 1, c] = flat[k * D - 1 - c]
    return C


def _flat_from_branches(C: np.ndarray) -> np.ndarray:
    """Invert :func:`decimating_branch_taps`: C[k-1, c] = flat[k*D-1-c]."""
    M, D = C.shape
    flat = np.zeros(M * D, dtype=C.dtype)
    for k in range(1, M + 1):
        for c in range(D):
            flat[k * D - 1 - c] = C[k - 1, c]
    return flat


def _decimating_banded_matrix(flat_taps: np.ndarray, rate: int,
                              phases: int) -> np.ndarray:
    """B2[i, p] = flat[p*D + M*D-1 - i] (0 outside the band): the
    decimating analogue of :func:`banded_tap_matrix`, columns strided
    by D so the product yields ONLY the kept outputs.  Host-side."""
    D, P = int(rate), int(phases)
    MD = flat_taps.shape[0]
    width = (P - 1) * D + MD
    i = np.arange(width)[:, None]
    p = np.arange(P)[None, :]
    t = p * D + MD - 1 - i
    valid = (t >= 0) & (t < MD)
    return np.where(valid, flat_taps[np.clip(t, 0, MD - 1)],
                    0).astype(flat_taps.dtype)


def decimating_band(Hb, device, phases: int = _DEFAULT_PHASES):
    """The band matrix :func:`fir_decimate_poly` multiplies by, for the
    host [M, D] matrix ``Hb``, on ``device``: a caller that resolves it
    once passes it back as ``band=`` and skips the lookup by content."""
    return _band_on(np.asarray(Hb), phases, True, device)


def fir_decimate_poly(x, Hb, ctx, phases: int = _DEFAULT_PHASES,
                      band=None):
    """Polyphase decimating FIR: computes ONLY the kept outputs.

        y[m] = sum_t taps[t] * x[m*D - t]

    ``Hb = C`` is the host-prepared [M, D] coefficient matrix from
    :func:`decimating_branch_taps`; ``ctx`` is the carried input tail
    of M*D - 1 samples.  len(x) % D == 0.  Returns ``(y[N//D],
    new_ctx)``.  Identical to ``fir_block`` + ``[::D]`` when the block
    length divides D (both keep index 0).

    Leading axes of ``x`` and ``ctx`` are batch axes (one independent
    stream per row, as the JAX package's ``vmap`` over channels).
    ``band``: :func:`decimating_band` of ``Hb`` on ``x``'s device, where
    the caller holds it.
    """
    C = np.asarray(Hb)
    M, D = C.shape
    N = x.shape[-1]
    if N % D:
        raise ValueError(f"block {N} not a multiple of rate {D}")
    frames = N // D
    T_pad = M * D
    P = int(phases)
    B2 = _band_on(C, P, True, x.device) if band is None else band
    width = (P - 1) * D + T_pad

    xe = torch.cat([ctx.to(x.dtype), x], dim=-1)       # [T_pad - 1 + N]
    new_ctx = xe[..., -(T_pad - 1):] if T_pad > 1 else ctx
    y = _decimate_gemm_core(xe, B2, D, P, frames, width)
    return y, new_ctx


def _decimate_gemm_core(xe, B2, D: int, P: int, frames: int, width: int):
    """Strided-window banded product: ``y[frames]`` with
    ``y[m] = sum_i xe[m*D + i] * B2[i, m % P]`` over the row window
    (see :func:`_decimating_banded_matrix` for the band layout)."""
    R = -(-frames // P)
    stride = P * D
    xpad = _pad_tail(xe, (R - 1) * stride + width)
    Y = _banded_product(
        xpad, B2, lambda v: _window_rows_strided(v, R, stride, width))
    return Y.reshape(*Y.shape[:-2], R * P)[..., :frames]


def piece_dots_accum(xpad, Bs, R: int, stride: int, width: int):
    """Banded-GEMM core on pieces: row r of the window is
    ``xpad[r*stride : r*stride + width]``, cut into ``stride``-wide
    pieces, each a reshape of a slice of ``xpad`` (no gather), and each
    piece multiplies its rows of every band matrix in ``Bs``.  Returns
    one [R, P] accumulator per matrix.  Requires ``len(xpad) >=
    stride*((width-1)//stride) + R*stride``.  Counterpart of the JAX
    package's ``piece_dots_accum``; the channelizer's branch GEMM runs
    on it."""
    Ys = [None] * len(Bs)
    off = 0
    while off < width:
        w = min(stride, width - off)
        Wp = xpad[off:off + R * stride].reshape(R, stride)[:, :w]
        for i, B in enumerate(Bs):
            t = Wp @ B[off:off + w].to(xpad.dtype)
            Ys[i] = t if Ys[i] is None else Ys[i] + t
        off += w
    return Ys


def poly_mac_frames(x, C, ctx):
    """Polyphase MAC core: the per-column accumulator
    ``V[frames, D] = sum_k C[k-1, :] * G[m + M - k, :]`` with
    ``G[i, c] = xe[i*D + c]`` and ``xe`` the carried tail followed by
    ``x`` (the decimating FIR sums it over columns; the channelizer
    FFTs it).  ``C`` is the host [M, D] matrix of
    :func:`decimating_branch_taps`.  Returns ``(V, new_ctx)``."""
    C = np.asarray(C)
    M, D = C.shape
    N = x.shape[0]
    if N % D:
        raise ValueError(f"block {N} not a multiple of rate {D}")
    frames = N // D
    T_pad = M * D
    Ct = torch.from_numpy(np.ascontiguousarray(C)).to(x.device)
    xe = torch.cat([ctx.to(x.dtype), x])               # [T_pad - 1 + N]
    new_ctx = xe[-(T_pad - 1):] if T_pad > 1 else ctx
    R = frames + M - 1
    G = xe[:R * D].reshape(R, D)
    acc = torch.zeros((frames, D), dtype=torch.promote_types(x.dtype,
                                                             Ct.dtype),
                      device=x.device)
    for k in range(1, M + 1):
        acc = acc + Ct[k - 1][None, :] * G[M - k:M - k + frames]
    return acc, new_ctx


def _traced_band_setup(flat_taps, N: int, rate: int, tail_zeros: int,
                       phases: int):
    """Validation and the band matrix of the traced-tap decimators:
    B2[i, p] = flat[p*D + MD-1 - i] (0 outside the band), one gather of
    ``flat_taps`` (with a zero appended) against a host index matrix
    cached on the device."""
    D, P = int(rate), int(phases)
    MD = int(flat_taps.shape[0])
    if MD % D:
        raise ValueError(f"flat_taps length {MD} must be a multiple of "
                         f"rate {D}")
    Z = int(tail_zeros)
    if (N + Z) % D:
        raise ValueError(f"block {N} + tail_zeros {Z} not a multiple "
                         f"of rate {D}")
    frames = (N + Z) // D
    width = (P - 1) * D + MD
    i = np.arange(width)[:, None]
    p = np.arange(P)[None, :]
    t = p * D + MD - 1 - i
    idx = _build.device_index(np.where((t >= 0) & (t < MD), t, MD),
                              flat_taps.device)
    flat_e = torch.cat([flat_taps, flat_taps.new_zeros(1)])
    return torch.take(flat_e, idx), D, P, frames, width


def fir_decimate_traced(x, flat_taps, rate: int, tail_zeros: int = 0,
                        phases: int = _DEFAULT_PHASES):
    """Polyphase decimating FIR whose taps are a device tensor:

        y[m] = sum_t flat_taps[t] * x[m*D - t],  m in [0, (N+Z)//D)

    with ``x`` zero-extended at both ends (the head where the taps reach
    before sample 0; ``tail_zeros`` = Z extra zeros at the end so late
    output frames exist)."""
    B2, D, P, frames, width = _traced_band_setup(
        flat_taps, int(x.shape[0]), rate, tail_zeros, phases)
    MD = int(flat_taps.shape[0])
    xe = torch.cat([x.new_zeros(MD - 1), x])
    return _decimate_gemm_core(xe, B2, D, P, frames, width)


def fir_decimate_traced_planar(xr, xi, flat_taps, rate: int,
                               tail_zeros: int = 0,
                               phases: int = _DEFAULT_PHASES):
    """Planar twin of :func:`fir_decimate_traced` (real taps on re/im
    planes): returns the ``(yr, yi)`` frame planes."""
    (yr,), (yi,) = _dec_traced_planar_core(
        xr, xi, (flat_taps,), rate, tail_zeros, phases)
    return yr, yi


def fir_decimate_traced_planar_complex(xr, xi, flat_re, flat_im,
                                       rate: int, tail_zeros: int = 0,
                                       phases: int = _DEFAULT_PHASES,
                                       ctx=None):
    """Complex taps on re/im planes:

        y[m] = sum_t (flat_re + j*flat_im)[t] * (xr + j*xi)[m*D - t]

    as four real decimating products sharing their window operands.
    ``ctx``: optional carried ``(ctx_re, ctx_im)`` planes of MD-1
    samples in place of the zero head (the streaming form: reads before
    sample 0 see the previous block's tail).  Returns ``(yr, yi)``."""
    (rr, ri), (ir_, ii) = _dec_traced_planar_core(
        xr, xi, (flat_re, flat_im), rate, tail_zeros, phases, ctx=ctx)
    return rr - ii, ri + ir_


def _dec_traced_planar_core(xr, xi, flats, rate, tail_zeros, phases,
                            ctx=None):
    """For each plane and each tap vector in ``flats``, the decimating
    product, the windows of a plane built once per piece.  Returns
    ``tuple_per_plane(tuple_per_flat)``."""
    N = int(xr.shape[0])
    setups = [_traced_band_setup(f, N, rate, tail_zeros, phases)
              for f in flats]
    B2s = [s[0] for s in setups]
    _, D, P, frames, width = setups[0]
    MD = int(flats[0].shape[0])
    R = -(-frames // P)
    stride = P * D
    last_off = stride * ((width - 1) // stride)
    pad = max(last_off + R * stride - (MD - 1 + N), 0)
    if ctx is not None and int(ctx[0].shape[0]) != MD - 1:
        raise ValueError(f"ctx must be MD-1 = {MD - 1} samples, got "
                         f"{ctx[0].shape[0]}")
    outs = []
    for pi, plane in enumerate((xr, xi)):
        if ctx is None:
            xpad = torch.nn.functional.pad(plane, (MD - 1, pad))
        else:
            xpad = torch.cat([ctx[pi].to(plane.dtype), plane,
                              plane.new_zeros(pad)])
        Ys = piece_dots_accum(xpad, B2s, R, stride, width)
        outs.append(tuple(Y.reshape(R * P)[:frames] for Y in Ys))
    return outs[0], outs[1]
