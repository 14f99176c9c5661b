"""FFT / IFFT over sample blocks.

Counterpart of :mod:`comms_tpu.ops.fft`, with its parity targets: the
reference's rustfft wrappers (``BatchFFT.run_fft`` transforms one
``fft_size`` block at a time; ``SampleFFT`` is a reblock plus the same
transform) and rustfft's **unnormalized** inverse (``normalize=True``
gives the conventional 1/N).

:func:`fft_block`, :func:`ifft_block` and :func:`fft_reblock` are
``torch.fft`` over reshaped blocks, as the JAX package leaves them to
``jnp.fft``.  :func:`fft_four_step` is the two-DFT-matmul form: complex
einsums in the input's precision, with TF32 off (PyTorch's default,
which the port never changes).
:func:`fft_large` routes CUDA tensors of a two-factor size N through the
four-step kernel K10 (:mod:`comms_tpu_torch.kernels.fft_big`), anything
else through ``torch.fft.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import fft_big as _FB

__all__ = ["fft_block", "ifft_block", "fft_reblock", "fft_four_step",
           "fft_large"]


def _complex_like(x: torch.Tensor) -> torch.dtype:
    """The JAX package's ``result_type(x.dtype, complex64)``."""
    return torch.promote_types(x.dtype, torch.complex64)


def fft_block(x, fft_size: int):
    """FFT each consecutive ``fft_size`` chunk of ``x`` ([N], N a
    multiple of ``fft_size``); returns the same flat shape."""
    blocks = x.reshape(-1, int(fft_size))
    return torch.fft.fft(blocks, dim=-1).reshape(x.shape).to(
        _complex_like(x))


def ifft_block(x, fft_size: int, normalize: bool = False):
    """Inverse FFT per chunk.  Default is rustfft's unnormalized
    convention (output scaled by N relative to numpy's ifft)."""
    blocks = x.reshape(-1, int(fft_size))
    y = torch.fft.ifft(blocks, dim=-1)
    if not normalize:
        y = y * fft_size
    return y.reshape(x.shape).to(_complex_like(x))


def fft_reblock(samples, fft_size: int):
    """SampleFFT semantics: view a sample stream as FFT frames, dropping
    the ragged tail.  Returns ``frames[num_ffts, fft_size]`` and the
    leftover tail."""
    n = (samples.shape[0] // int(fft_size)) * int(fft_size)
    return samples[:n].reshape(-1, int(fft_size)), samples[n:]


def fft_large(x, use_kernel=None):
    """Batched large-N FFT over the last axis (N in 2^16..2^22 with a
    two-factor decomposition into 256..2048-point stages).

    ``use_kernel=None`` takes the four-step kernel for a CUDA tensor of a
    supported N and ``torch.fft.fft`` otherwise; ``True`` insists on the
    kernel (ValueError for an unsupported N)."""
    n = int(x.shape[-1])
    if use_kernel is None:
        use_kernel = _FB.supported_big(n) and x.device.type == "cuda"
    if not use_kernel:
        return torch.fft.fft(x, dim=-1).to(_complex_like(x))
    if not _FB.supported_big(n):
        raise ValueError(
            f"N={n} has no two-factor decomposition into 256..2048-"
            "point stages; use use_kernel=False (torch.fft fallback)")
    n1, n2 = _FB.factorize(n)
    lead = x.shape[:-1]
    rows = x.reshape(-1, n)
    yr, yi = _FB.fft_big_planar(rows.real.to(torch.float32).contiguous(),
                                rows.imag.to(torch.float32).contiguous(),
                                n1, n2)
    return torch.complex(yr, yi).reshape(*lead, n)


def fft_four_step(x, radix=None, precision=None, inverse: bool = False,
                  scale: float | None = None):
    """Batched FFT over the last axis as two DFT matmuls (four-step):
    N = R*C, a cross-block R-point DFT, exact integer-mod twiddles and a
    C-point DFT.

    ``radix``: optional (R, C) with R*C = N; the default picks the
    largest R <= 128 dividing N, and falls back to ``torch.fft`` when
    there is none or C > 4096.  ``precision``: None or "highest" (the
    products run in the input's precision).  ``inverse``: conjugate
    exponent; with the default scale (1/N when inverse) this matches
    ``torch.fft.ifft``.  ``scale`` multiplies the result (folded into the
    C-point DFT matrix)."""
    if precision not in (None, "highest"):
        raise ValueError(f"precision must be None or 'highest', got "
                         f"{precision!r}")
    N = x.shape[-1]
    if scale is None:
        scale = 1.0 / N if inverse else 1.0
    sgn = 2j if inverse else -2j

    def _fallback(z):
        if inverse:
            return torch.fft.ifft(z, dim=-1) * (N * scale)
        y = torch.fft.fft(z, dim=-1)
        return y * scale if scale != 1.0 else y

    if radix is None:
        R = 128
        while R > 1 and N % R:
            R //= 2
        if R == 1 or N // R > 4096:
            return _fallback(x)
        radix = (R, N // R)
    R, C = map(int, radix)
    if R * C != N:
        raise ValueError(f"radix {radix} does not factor N = {N}")
    if max(R, C) > 8192:
        raise ValueError(
            f"radix {radix}: a dense {max(R, C)}^2 DFT matrix is "
            "impractical (memory/flops grow quadratically); refactor N "
            "or use torch.fft")
    if R == 1 or C == 1:
        return _fallback(x)
    cdtype = _complex_like(x)
    np_c = np.complex128 if cdtype == torch.complex128 else np.complex64

    def mat(a):
        return torch.from_numpy(a.astype(np_c)).to(x.device)

    p = np.arange(R)
    d_r = mat(np.exp((sgn * np.pi / R) * np.mod(np.outer(p, p), R)))
    j = np.arange(C)
    tw = mat(np.exp((sgn * np.pi / N) * np.mod(np.outer(p, j), N)))
    d_c = mat(scale * np.exp((sgn * np.pi / C) * np.mod(np.outer(j, j), C)))

    lead = x.shape[:-1]
    xm = x.to(cdtype).reshape(-1, R, C)
    g = torch.einsum("ps,bsj->bpj", d_r, xm) * tw[None]
    z = torch.einsum("bpj,jm->bpm", g, d_c)
    # X[k], k = p + R*m  ->  [b, m, p] then flatten.
    return z.transpose(1, 2).reshape(*lead, N).to(cdtype)
