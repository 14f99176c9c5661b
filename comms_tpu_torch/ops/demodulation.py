"""FM quadrature demodulation and the QPSK receiver's estimators.

Counterpart of :mod:`comms_tpu.ops.demodulation`:

* FM demod ``y[n] = arg(x[n] * conj(x[n-1]))`` with ``prev`` carried
  across blocks (zero-initialized; arg(0) = 0), and the polynomial atan2
  that the fused FM kernel shares;
* the carrier-offset estimate ``arg(sum(x[1:] * conj(x[:-1])))``;
* the PSK/QAM phase estimates ``arg(sum(x^m))/m`` and
  ``arg(sum(-x^4))/4`` (Mengali 5.7.4/5.7.5), the powers as XLA's
  ``integer_pow`` expands them;
* :func:`costas_loop_block`, the decision-directed Costas loop, on the
  hand-written recurrence kernel (``kernels.recurrence``) for CUDA
  tensors and its plain version for CPU tensors;
* :class:`TimingEstimator`, the feedforward NDA ML timing estimate
  (Mengali 8.4) as correlation panels, whose products are float32
  ``torch.matmul`` (TF32 stays off; the JAX package leaves them to XLA
  outside any Pallas kernel).  Every host-known constant and index array
  lives on the device once (``kernels._build.device_constant``), and the
  estimates stay tensors, so an estimate chain never synchronises.

The complex product is written out on the re/im planes in the order
XLA evaluates a complex multiply, ``(ar*br - ai*bi, ar*bi + ai*br)``.
That order fixes the signs of zero products: at stream start
``prev = 0`` and atan2 of signed zeros is 0 or +-pi depending on them
(a first sample of -1-1j demodulates to pi), so a different order
would move the first audio samples.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import recurrence as _rec
from comms_tpu_torch.ops import taps as _taps

__all__ = ["fast_atan2", "fast_angle", "fm_demod_init", "fm_demod_block",
           "frequency_offset_estimate", "frequency_offset_estimate_planar",
           "psk_phase_estimate", "qam_phase_estimate", "costas_loop_block",
           "TimingEstimator", "corr_panels"]


def fast_atan2(y, x):
    """Octant-reduced degree-15 odd-polynomial atan2 in float32, 8.8e-8
    rad max error; the same coefficients, Horner order, ``den + 1e-30``
    and sign-bit branches as the JAX package's ``fast_atan2`` and the
    fused FM kernel.  IEEE signed-zero faithful on the x<0 branch cuts
    (atan2(+-0, -0) = +-pi): ``signbit`` is exact for -0.0 and +-inf."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32)
    ax = x.abs()
    ay = y.abs()
    swap = ay > ax
    num = torch.minimum(ax, ay)
    den = torch.maximum(ax, ay)
    r = num / (den + 1e-30)
    r2 = r * r
    p = r2 * -4.831168387e-03 + 2.475678069e-02
    p = p * r2 + -6.021912799e-02
    p = p * r2 + 9.967923619e-02
    p = p * r2 + -1.404013889e-01
    p = p * r2 + 1.997368136e-01
    p = p * r2 + -3.333230283e-01
    p = p * r2 + 9.999999582e-01
    a = p * r
    a = torch.where(swap, np.pi / 2 - a, a)
    a = torch.where(torch.signbit(x), np.pi - a, a)
    return torch.where(torch.signbit(y), -a, a)


def fast_angle(z):
    """:func:`fast_atan2` of a complex tensor's (im, re)."""
    return fast_atan2(z.imag, z.real)


def fm_demod_init(dtype=torch.complex64, device="cuda"):
    """Carried ``prev`` sample, zero-initialized (analog.rs:44-47)."""
    return torch.zeros((), dtype=dtype, device=device)


def _mul_conj(ar, ai, br, bi):
    """Planes of (ar + j ai) * conj(br + j bi), in XLA's operation order
    (see module docstring)."""
    ci = -bi
    return ar * br - ai * ci, ar * ci + ai * br


def fm_demod_block(x, prev, fast: bool = False):
    """Quadrature FM demod of one block.  Returns ``(y, new_prev)``;
    y is real with the dtype of ``x.real``.

    ``fast``: use :func:`fast_atan2` (float32) instead of the exact
    ``torch.atan2``."""
    shifted = torch.cat([prev.reshape(1).to(x.dtype), x[:-1]])
    zre, zim = _mul_conj(x.real, x.imag, shifted.real, shifted.imag)
    y = fast_atan2(zim, zre) if fast else torch.atan2(zim, zre)
    return y.to(x.real.dtype), x[-1]


def frequency_offset_estimate(x):
    """Carrier-offset estimate in rad/sample (pre-matched-filter):
    ``arg(sum(x[1:] * conj(x[:-1])))``."""
    return torch.angle(torch.sum(x[1:] * torch.conj(x[:-1])))


def frequency_offset_estimate_planar(re, im):
    """Planar twin of :func:`frequency_offset_estimate`."""
    ar = torch.sum(re[1:] * re[:-1] + im[1:] * im[:-1])
    ai = torch.sum(im[1:] * re[:-1] - re[1:] * im[:-1])
    return torch.atan2(ai, ar)


def psk_phase_estimate(symbols, m: int):
    """Mengali 5.7.4: ``arg(sum(x^m)) / m`` for M-PSK symbols (complex)."""
    pr, pi = _rec.complex_ipow(symbols.real, symbols.imag, m)
    return torch.atan2(torch.sum(pi), torch.sum(pr)) / float(m)


def qam_phase_estimate(symbols):
    """Mengali 5.7.5: ``arg(sum(-x^4)) / 4`` for square QAM (complex)."""
    pr, pi = _rec.complex_ipow(symbols.real, symbols.imag, 4)
    return torch.atan2(torch.sum(-pi), torch.sum(-pr)) / 4.0


def costas_loop_block(symbols, state, alpha: float, beta: float,
                      order: int = 4):
    """Decision-directed Costas carrier-tracking loop over one block.

    A second-order loop whose M-th-power phase detector (with the -x^M
    sign, so the error zero sits at the constellation points) drives the
    NCO: per symbol ``c = s e^{-j ph}``, ``err = arg(-c^M) / M``, ``fr +=
    beta err``, ``ph = ph + fr + alpha err``.  The recurrence has no
    parallel form: on CUDA tensors one launch of the recurrence kernel
    walks the block (under ``torch.func.vmap``, one launch walks every
    stream's block, a lane a stream), on CPU tensors its plain version
    does.

    Args:
      symbols: [N] complex64 symbol-rate input.
      state: ``(phase, freq)`` float32 0-d tensors on the symbols'
        device (start ``(0, 0)``).
      alpha, beta: proportional / integrator gains.
      order: constellation order (4 = QPSK).

    Returns ``(corrected, (phase, freq))``.
    """
    if symbols.dtype != torch.complex64:
        raise ValueError(f"symbols must be complex64, got {symbols.dtype}")
    v = torch.view_as_real(symbols)
    ph, fr = (torch.as_tensor(s, dtype=torch.float32, device=symbols.device)
              for s in state)
    yr, yi, ph, fr = _rec.costas_loop(v[:, 0], v[:, 1], ph, fr, alpha, beta,
                                      order)
    return torch.complex(yr, yi), (ph, fr)


def corr_panels(re, im, hw: int):
    """Raw correlation panels ``(P1, P2, P3, P4, meta)`` of one block's
    planes: ``P1 = rev^T @ Wr``, ``P2 = -(rev^T @ Wi)``, ``P3 = imv^T @
    Wr``, ``P4 = -(imv^T @ Wi)``, each [128, 128 + 2*hw], where
    ``rev/imv`` are the planes as [R, 128] rows (zero-padded past k = N -
    hw) and ``Wr/Wi`` 128-stride windows of the planes at offset -hw.
    Every lagged-product statistic of the block with |lag| <= hw is a
    diagonal functional of these four small matrices.  ``meta`` holds
    the shapes and the operands that ``lag_sums_r2`` needs when 128 % n
    != 0."""
    lanes = TimingEstimator.LANES
    N = int(re.shape[0])
    K = N - hw
    R = -(-K // lanes)
    Kp = lanes * R
    width = lanes + 2 * hw
    pad = torch.nn.functional.pad
    rev = pad(re[:K], (0, Kp - K)).reshape(R, lanes)
    imv = pad(im[:K], (0, Kp - K)).reshape(R, lanes)
    need = (R - 1) * lanes + (-(-width // lanes)) * lanes
    Wr_flat = pad(re, (hw, max(need - hw - N, 0)))
    Wi_flat = pad(im, (hw, max(need - hw - N, 0)))
    V2t = torch.cat([rev, imv], dim=1).T          # [2*lanes, R]

    def panel2(Wflat):
        tops, bots = [], []
        off = 0
        while off < width:
            w = min(lanes, width - off)
            Wp = Wflat[off:off + R * lanes].reshape(R, lanes)[:, :w]
            E2 = V2t @ Wp                          # [2*lanes, w]
            tops.append(E2[:lanes])
            bots.append(E2[lanes:])
            off += w
        return torch.cat(tops, dim=1), torch.cat(bots, dim=1)

    P1, P3 = panel2(Wr_flat)
    P2n, P4n = panel2(Wi_flat)
    meta = {"nd": hw, "K": K, "Kp": Kp, "R": R, "width": width,
            "fdt": re.dtype, "prec": None, "rev": rev, "imv": imv,
            "Wr_flat": Wr_flat, "Wi_flat": -Wi_flat}
    return P1, -P2n, P3, -P4n, meta


def _const(a, like: torch.Tensor) -> torch.Tensor:
    """Host array ``a`` in ``like``'s float dtype on its device, cached."""
    np_dtype = np.float64 if like.dtype == torch.float64 else np.float32
    return _build.device_constant(a, like.device, np_dtype)


class TimingEstimator:
    """Feedforward NDA ML timing estimator (Mengali ch. 8.4).

    q-filter = ``qfilt_taps(2*N*D + 1, alpha, N)``, delay = ND samples.
    As in the JAX package, the estimate is computed from the 2ND+1
    lagged correlations

        g[u] = sum_k r2[k] * x[k] * conj(x[k+u]),  r2[k] = exp(-2j*pi*k/N),

    weighted by the host-folded ``_wq`` (float64):
    ``s = sum_u wq[u+ND] * g[u]``, estimate ``-N * arg(s) / (2*pi)``
    samples.  ``g`` comes from four small correlation panels
    (:meth:`corr_panels`): with ``V[row, j] = x[128*row + j]`` (zero past
    k = len - HW) and ``W[row, i] = conj(x)[128*row + i - HW]``,
    ``E = V^T @ W`` is [128, 128 + 2HW] and ``g[u]`` is the sum of E's
    ``(HW+u)``-offset diagonal.
    """

    LANES = 128

    def __init__(self, n: int, d: int, alpha: float):
        if not 0.0 <= alpha <= 1.0:
            raise _taps.InvalidRolloffError(f"alpha={alpha} not in [0, 1]")
        self.n = int(n)
        self.d = int(d)
        self.alpha = float(alpha)
        q = _taps.qfilt_taps(2 * self.n * self.d + 1, alpha, self.n)
        self.qfilt = np.real(q).astype(np.float64)
        # s = sum_u wq[u+ND] * g[u], wq[u+ND] = q[ND-u] * exp(-j*pi*u/N)
        nd = self.n * self.d
        u = np.arange(-nd, nd + 1, dtype=np.float64)
        self._wq = (self.qfilt[nd - u.astype(int)]
                    * np.exp(-1j * np.pi * u / self.n))

    def corr_panels(self, re, im, halfwidth: int | None = None):
        """Raw correlation panels of one block's planes, at the largest
        |lag| ``halfwidth`` (default ND): see :func:`corr_panels`."""
        hw = self.n * self.d if halfwidth is None else int(halfwidth)
        return corr_panels(re, im, hw)

    def lag_sums_r2(self, panels):
        """r2-rotated lagged-correlation sums ``(gr, gi)`` over lag v in
        [-HW, HW]: ``g[v] = sum_k r2[k] x[k] conj(x[k+v])``.  The
        rotation follows the panels when 128 % n == 0 (r2 then depends
        on j = k mod 128 only), else it multiplies the rows before
        panel products of its own."""
        P1, P2, P3, P4, meta = panels
        lanes = self.LANES
        hw = meta["nd"]
        if lanes % self.n == 0:
            ph = 2.0 * np.pi * np.arange(lanes, dtype=np.float64) / self.n
            c2 = _const(np.cos(ph)[:, None], P1)
            s2 = _const(np.sin(ph)[:, None], P1)
            Er = (c2 * P1 + s2 * P3) - (c2 * P4 - s2 * P2)
            Ei = (c2 * P2 + s2 * P4) + (c2 * P3 - s2 * P1)
        else:
            if "rev" not in meta:
                raise ValueError(
                    f"panels without their operands (the fused symbol "
                    f"kernel's) need 128 % n == 0, n = {self.n}")
            rev, imv = meta["rev"], meta["imv"]
            Wr_flat, Wi_flat = meta["Wr_flat"], meta["Wi_flat"]
            R, width = meta["R"], meta["width"]
            ph = (2.0 * np.pi * np.arange(meta["Kp"], dtype=np.float64)
                  / self.n).reshape(R, lanes)
            c2 = _const(np.cos(ph), rev)
            s2 = _const(np.sin(ph), rev)
            Vr = rev * c2 + imv * s2
            Vi = imv * c2 - rev * s2

            def panel(V, Wflat):
                pieces = []
                off = 0
                while off < width:
                    w = min(lanes, width - off)
                    Wp = Wflat[off:off + R * lanes].reshape(R, lanes)[:, :w]
                    pieces.append(V.T @ Wp)
                    off += w
                return torch.cat(pieces, dim=1)

            Er = panel(Vr, Wr_flat) - panel(Vi, Wi_flat)
            Ei = panel(Vr, Wi_flat) + panel(Vi, Wr_flat)
        # g[v] = sum_j E[j, j + HW + v]: offset-diagonal sums.
        cols = _build.device_index(
            np.arange(lanes)[:, None] + np.arange(2 * hw + 1)[None, :],
            Er.device)
        gr = torch.gather(Er, 1, cols).sum(0)
        gi = torch.gather(Ei, 1, cols).sum(0)
        return gr, gi

    def estimate_from_panels(self, panels, weights=None, lag_rot=None):
        """Timing estimate (samples, a 0-d tensor) from
        :meth:`corr_panels` output.  ``weights``: host complex weights
        over lag v in [-HW, HW] in place of ``self._wq`` (which needs
        HW == ND).  ``lag_rot``: a rotation w (number or tensor); g[v]
        is rotated by exp(j*w*v) before weighting, the exact fold of a
        carrier de-rotation x * exp(-j*w*k)."""
        gr, gi = self.lag_sums_r2(panels)
        return self.estimate_from_lag_sums(gr, gi, weights, lag_rot)

    def estimate_from_lag_sums(self, gr, gi, weights=None, lag_rot=None):
        """Timing estimate from the r2-rotated lag sums over v in [-HW,
        HW] (:meth:`lag_sums_r2`, or rows 0/1 of the panel-reduction
        kernel); ``weights`` and ``lag_rot`` as in
        :meth:`estimate_from_panels`."""
        hw = (gr.shape[0] - 1) // 2
        fdt = gr.dtype
        if weights is None:
            if hw != self.n * self.d:
                raise ValueError(
                    "widened panels need an explicit weight vector")
            weights = self._wq
        wq = np.asarray(weights)
        if wq.shape[0] != 2 * hw + 1:
            raise ValueError(f"weights must cover 2*HW+1 = {2*hw+1} "
                             f"lags, got {wq.shape[0]}")
        wr = _const(np.real(wq), gr)
        wi = _const(np.imag(wq), gr)
        if lag_rot is not None:
            v = _const(np.arange(-hw, hw + 1), gr)
            cv = torch.cos(lag_rot * v)
            sv = torch.sin(lag_rot * v)
            gr, gi = gr * cv - gi * sv, gr * sv + gi * cv
        s_re = torch.sum(wr * gr - wi * gi)
        s_im = torch.sum(wr * gi + wi * gr)
        return (-float(self.n) * torch.atan2(s_im, s_re)
                / (2.0 * np.pi)).to(fdt)

    def estimate_planar(self, re, im):
        """Timing estimate from re/im planes."""
        if int(re.shape[0]) <= self.n * self.d:
            # empty product sum -> angle(0) = 0
            return torch.zeros((), dtype=re.dtype, device=re.device)
        return self.estimate_from_panels(self.corr_panels(re, im))

    def estimate(self, samples):
        """Timing estimate in samples for one complex block."""
        return self.estimate_planar(samples.real.contiguous(),
                                    samples.imag.contiguous())

    __call__ = estimate
