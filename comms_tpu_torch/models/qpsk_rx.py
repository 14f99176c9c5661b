"""QPSK receiver: matched filter -> sync -> symbol decisions -> bits.

Counterpart of :mod:`comms_tpu.models.qpsk_rx`: the feedforward
synchronisation chain for the qpsk_tx waveform (RRC, sps 4, beta 0.25,
consecutive-bit-pair map):

    planes -> frequency estimate (Meyr 8.2.2)
           -> NDA ML timing estimate (Mengali 8.4) -> cubic-Lagrange
              interpolation + integer shift + symbol-phase pick
           -> fine carrier and M-power phase (Mengali 5.7.4)
           -> symbols on the +-1+-1j constellation (the 4-fold phase
              ambiguity and the pipeline lag are resolved by the caller)

Two cores, as in the JAX package:

* the fused core (sps 4, or any sps >= 4 dividing 128): every estimate
  comes from one set of correlation panels of the RAW planes (the
  matched filter folded into host weights, ``QpskRxConfig.
  _fold_mf_weights``), and one complex-tap decimating product does
  matched filter, de-rotation, interpolation, shift, phase pick and
  downsample.  On CUDA tensors both run on the QPSK symbol kernel
  (:mod:`comms_tpu_torch.kernels.qpsk_sym`: ``qpsk_panels`` and
  ``qpsk_symbol_gemm_scalars``);
* the staged core (the oracle, and the route for other sps): de-rotate,
  matched filter (the FIR kernel, :mod:`comms_tpu_torch.kernels.fir`,
  on CUDA tensors whose length fits a tile), panels of the filtered
  signal, one traced-tap decimating product.

Every estimate stays a tensor on the device (argmax, floor and integer
casts included), and every host-known index array is kept there once, so
a block runs without a host synchronisation.  ``use_kernel``: None takes
the kernels for CUDA tensors whose shapes they accept; True forces them
(a CPU tensor then runs their plain versions, as the tests do; shapes
they do not accept raise); False keeps the plain tensor route.

At sps = 2 the JAX package's staged core indexes its 3-lag correlation
array with lags in [-2, 4], which JAX wraps and clamps, so it picks the
symbol phase from wrong energies; the port takes the general
interpolated-energy branch whenever 2*sps - 1 < 7.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import fir as _FK
from comms_tpu_torch.kernels import qpsk_sym as _QS
from comms_tpu_torch.ops import demodulation, fir, mixer, taps

__all__ = ["QpskRxConfig", "make_rx_fn", "make_rx_fn_planar",
           "decide_bits", "resolve_ambiguity", "modulated_taps",
           "fused_gemm_ctx_len"]

_LANES = demodulation.TimingEstimator.LANES


class QpskRxConfig:
    def __init__(self, sps: int = 4, num_taps: int = 32,
                 beta: float = 0.25, timing_d: int = 5, use_kernel=None):
        self.use_kernel = use_kernel
        self.sps = int(sps)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.timing_d = int(timing_d)
        t = taps.rrc_taps(num_taps, float(sps), beta)
        # unit-energy matched filter, so decisions are scale-free
        t = t / np.sqrt(np.sum(np.abs(t) ** 2))
        self.mf_taps = np.real(t).astype(np.float32)
        self.mf = fir.banded_tap_matrix(self.mf_taps)
        self.timing = demodulation.TimingEstimator(
            n=self.sps, d=self.timing_d, alpha=self.beta)
        # one-hot band matrices of the cubic-Lagrange interpolator (the
        # staged core's general branch): B_lag = sum_j lag[j] * E_j
        eye4 = np.eye(4, dtype=np.float32)
        self.lag_bands = np.stack(
            [fir.banded_tap_matrix(eye4[j]) for j in range(4)])
        self._fold_mf_weights()

    def _fold_mf_weights(self):
        """Host float64 folds that move the matched filter behind the
        correlation panels, so frequency, timing and per-phase symbol
        energies all come from lagged correlations of the RAW signal.
        With y = h * x,

            sum_k r2[k] y[k] conj(y[k+u])
              = sum_{a,b} h[a] h[b] r2[a] g2_x[u + a - b]  + O(T/N),

        so the q-filter weights fold to
        ``wq2[v] = sum_{a,b} wq[v - a + b] h[a] h[b] r2[a]``, and the
        phase-restricted energies through
        ``w4[am, d] = sum_{a = am (mod sps)} h[a] h[a - d]``."""
        h = np.asarray(self.mf_taps, np.float64)
        T = h.shape[0]
        sps = self.sps
        nd = sps * self.timing_d
        self.panel_hw = nd + T - 1
        wq = self.timing._wq                      # [2*nd+1], v index +nd
        r2 = np.exp(-2j * np.pi * np.arange(T) / sps)
        wq2 = np.zeros(2 * self.panel_hw + 1, np.complex128)
        for a in range(T):
            for b in range(T):
                lo = -nd + a - b + self.panel_hw
                wq2[lo:lo + 2 * nd + 1] += (h[a] * h[b] * r2[a]) * wq
        self.wq2 = wq2
        w4 = np.zeros((sps, 2 * T - 1), np.float64)
        for a in range(T):
            for d in range(-(T - 1), T):
                if 0 <= a - d < T:
                    w4[a % sps, d + T - 1] += h[a] * h[a - d]
        self.w4 = w4.astype(np.float32)
        self.w4_dvec = np.arange(-(T - 1), T, dtype=np.float32)


def make_rx_fn(cfg: QpskRxConfig):
    """``rx(iq_pairs[N, 2]) -> (sym_planes[2, N/sps], diag)``: the
    synchronised symbols as float32 re/im planes and a dict of the
    estimates (0-d tensors)."""

    def rx(iq_pairs):
        return _rx_core(cfg, iq_pairs[:, 0].contiguous(),
                        iq_pairs[:, 1].contiguous())

    return rx


def make_rx_fn_planar(cfg: QpskRxConfig):
    """Planar twin of :func:`make_rx_fn`: ``rx(re[N], im[N])``."""

    def rx(re, im):
        return _rx_core(cfg, re, im)

    return rx


def _rx_core(cfg: QpskRxConfig, re, im):
    """The fused core when sps >= 4 divides the lane width (its phase
    pick indexes lags j - j' in [-3, 3], which needs 2*sps - 1 >= 7),
    the staged core otherwise."""
    if 4 <= cfg.sps <= _LANES and _LANES % cfg.sps == 0:
        return _rx_core_fused(cfg, re, im)
    return _rx_core_staged(cfg, re, im)


def _valid_mask(sr, si, n: int, sps: int, shift2):
    """Zero the symbols whose windows left the block (the Lagrange
    zero-context head, the shifted-off tail)."""
    lo = 3 + torch.clamp(shift2, min=0)
    hi = n + torch.clamp(shift2, max=0)
    m4 = torch.arange(sr.shape[0], device=sr.device) * sps
    valid = (m4 >= lo) & (m4 < hi)
    return torch.where(valid, sr, 0.0), torch.where(valid, si, 0.0)


def _rx_core_fused(cfg: QpskRxConfig, re, im):
    """Fused core: estimates from one set of panels on the raw planes,
    then one fused symbol product (module docstring)."""
    n = re.shape[0]
    sps = cfg.sps
    f_est, t_est, lag, shift, p_star = _panel_estimates(cfg, re, im)
    # clip to the tap window (t0 = shift2 + sps keeps all 4 Lagrange
    # taps inside the 3*sps flat vector)
    shift2 = torch.clamp(shift - p_star, -sps, 2 * sps - 4)
    sr, si = _fused_symbol_gemm(cfg, re, im, f_est, lag, shift2)
    sr, si = _valid_mask(sr, si, n, sps, shift2)
    sym_planes, diag_tail = _symbol_tail(sr, si)
    diag = {"freq": f_est, "timing": t_est, "sym_phase": p_star,
            **diag_tail}
    return sym_planes, diag


def _use_kernel(cfg, re, fits: bool) -> bool:
    if cfg.use_kernel is None:
        return re.device.type == "cuda" and fits
    return bool(cfg.use_kernel)


def _corr_panels(cfg: QpskRxConfig, re, im):
    """The correlation panels of the raw planes at ``cfg.panel_hw``: the
    symbol kernel's panel entry on CUDA tensors it accepts, else
    ``TimingEstimator.corr_panels``."""
    fits = (_QS.kernel_ok(int(re.shape[0]), 1, cfg.sps)
            and 0 < cfg.panel_hw <= 64)
    if _use_kernel(cfg, re, fits):
        return _QS.qpsk_panels(re, im, cfg.panel_hw)
    return cfg.timing.corr_panels(re, im, halfwidth=cfg.panel_hw)


def _panel_estimates(cfg: QpskRxConfig, re, im):
    """All block-rate estimates from one set of correlation panels of the
    raw planes: ``(f_est, t_est, lag[4], shift, p_star)``."""
    return _estimates_from_panels(cfg, _corr_panels(cfg, re, im))


def _lagrange(t_est):
    """Cubic-Lagrange weights [4] and the integer part of the delay
    -t_est, as tensors."""
    dev = t_est.device
    delay = -t_est
    d_floor = torch.floor(delay)
    mu = delay - d_floor
    d_int = d_floor.to(torch.int32)
    tmu = 1.0 + mu
    pts = _build.device_constant(np.arange(4, dtype=np.float32), dev)
    eye = _build.device_constant(np.eye(4), dev) > 0
    num = torch.prod(torch.where(eye, 1.0, tmu - pts[None, :]), dim=1)
    den = torch.prod(torch.where(eye, 1.0, pts[:, None] - pts[None, :]),
                     dim=1)
    return num / den, d_int


def _estimates_from_panels(cfg: QpskRxConfig, panels):
    """The estimate chain on given panels (lagged-correlation sums are
    additive, so panels of several shards may be summed first)."""
    sps = cfg.sps
    T = int(cfg.mf_taps.shape[0])
    hw = cfg.panel_hw
    P1, P2, P3, P4, _meta = panels
    dev = P1.device
    Er = P1 - P4                      # Re(V^T @ conj-windows)
    Ei = P2 + P3

    # coarse carrier: angle of the v = -1 diagonal, sum x[k] conj(x[k-1])
    idx_m1 = _build.device_index((np.arange(_LANES) + hw - 1)[:, None], dev)
    g1r = torch.sum(torch.gather(Er, 1, idx_m1))
    g1i = torch.sum(torch.gather(Ei, 1, idx_m1))
    f_est = torch.atan2(g1i, g1r)

    # timing on the same panels: matched filter via the folded wq2, the
    # de-rotation via the exact e^{jwv} lag rotation
    t_est = cfg.timing.estimate_from_panels(panels, weights=cfg.wq2,
                                            lag_rot=f_est)
    lag, d_int = _lagrange(t_est)

    # symbol phase: max-energy phase of the interpolated matched-filter
    # output, a quadratic form in lag over phase-restricted correlations:
    #   e4[p] = Re sum_{j,j'} lag_j lag_j' e^{jw(j-j')}
    #               H[(p-j) mod sps, j-j'],
    #   H[q, t] = sum_{am,d} w4[am,d] e^{jwd} G_x[(q-am)%sps, t+d].
    vmax = (sps - 1) + (T - 1)
    vsel = np.arange(-vmax, vmax + 1)
    cols = _build.device_index(
        np.arange(_LANES)[:, None] + hw + vsel[None, :], dev)
    Gr = torch.gather(Er, 1, cols).reshape(_LANES // sps, sps,
                                           vsel.size).sum(0)
    Gi = torch.gather(Ei, 1, cols).reshape(_LANES // sps, sps,
                                           vsel.size).sum(0)
    d_vec = _build.device_constant(cfg.w4_dvec, dev)
    cd = torch.cos(f_est * d_vec)
    sd = torch.sin(f_est * d_vec)
    w4 = _build.device_constant(cfg.w4, dev)
    q_idx = (np.arange(sps)[:, None] - np.arange(sps)[None, :]) % sps
    t_vec = np.arange(-(sps - 1), sps)
    v_idx = (t_vec[:, None] + np.arange(-(T - 1), T)[None, :]) + vmax
    # Gsel[q, t, am, d] = G[q_idx[q, am], v_idx[t, d]]
    sel = _build.device_index(q_idx[:, None, :, None] * vsel.size
                              + v_idx[None, :, None, :], dev)
    Gsel_r = torch.take(Gr, sel)      # [sps, 2sps-1, sps(am), 2T-1]
    Gsel_i = torch.take(Gi, sel)
    wc = w4 * cd[None, :]
    ws = w4 * sd[None, :]
    Hr = (torch.einsum("qtad,ad->qt", Gsel_r, wc)
          - torch.einsum("qtad,ad->qt", Gsel_i, ws))
    Hi = (torch.einsum("qtad,ad->qt", Gsel_i, wc)
          + torch.einsum("qtad,ad->qt", Gsel_r, ws))

    jj = np.arange(4)
    t_jj = jj[:, None] - jj[None, :]
    ph_idx = (np.arange(sps)[:, None, None] - jj[None, :, None]) % sps
    t_idx = (t_jj + sps - 1)[None, :, :]
    hsel = _build.device_index(ph_idx * (2 * sps - 1) + t_idx, dev)
    Hsel_r = torch.take(Hr, hsel)     # [sps, 4, 4]
    Hsel_i = torch.take(Hi, hsel)
    t_jj_f = _build.device_constant(t_jj, dev)
    ll = lag[:, None] * lag[None, :]
    ll_c = ll * torch.cos(f_est * t_jj_f)
    ll_s = ll * torch.sin(f_est * t_jj_f)
    e4 = (torch.einsum("jk,pjk->p", ll_c, Hsel_r)
          - torch.einsum("jk,pjk->p", ll_s, Hsel_i))
    shift = d_int + 1  # +1: interpolator basepoint
    p_star = torch.remainder(torch.argmax(e4).to(torch.int32) + shift, sps)
    return f_est, t_est, lag, shift, p_star


def modulated_taps(cfg: QpskRxConfig, w, lag, shift2):
    """The fused symbol product's complex tap planes: conv(matched
    filter, cubic Lagrange at t0 = shift2 + sps) modulated by e^{j*w*t},
    zero-padded to a multiple of sps (sps = 4: the symbol kernel's
    ``_scalars`` taps)."""
    return _QS.modulated_taps_plain(cfg.mf_taps, w, lag, shift2, lag.device,
                                    cfg.sps)


def fused_gemm_ctx_len(cfg: QpskRxConfig) -> int:
    """Carried raw-tail samples of the streaming symbol product (MD - 1
    of the padded tap vector)."""
    md = 3 * cfg.sps + int(cfg.mf_taps.shape[0]) - 1
    return -(-md // cfg.sps) * cfg.sps - 1


def _fused_symbol_gemm(cfg: QpskRxConfig, re, im, w, lag, shift2,
                       ctx=None, phase0=0.0):
    """The fused symbol path: one complex-tap decimating product on the
    raw planes (taps conv(mf, lagrange) modulated by e^{j*w*t}) and the
    symbol-rate rotation e^{-j(phase0 + w*sps*m)}.  ``ctx``: carried
    raw-tail ``(re, im)`` planes (streaming); ``phase0``: carried phase at
    the block start.  Returns the symbol planes ``(sr, si)`` of N/sps
    frames.  On CUDA tensors the symbol kernel's ``_scalars`` entry runs
    it; otherwise the tensor form below, whose product runs with a zero
    head and patches the head outputs that reach into ``ctx`` from a
    small recompute (the JAX package's form, kept for parity)."""
    sps = cfg.sps
    md_flat = 3 * sps + int(cfg.mf_taps.shape[0]) - 1
    pad_to = -(-md_flat // sps) * sps
    fits = _QS.kernel_ok(int(re.shape[0]), pad_to, sps)
    if _use_kernel(cfg, re, fits):
        return _QS.qpsk_symbol_gemm_scalars(
            re, im, cfg.mf_taps, w, lag, shift2, phase0=phase0, ctx=ctx)
    fr, fi = modulated_taps(cfg, w, lag, shift2)
    sr_all, si_all = fir.fir_decimate_traced_planar_complex(
        re, im, fr, fi, sps, tail_zeros=sps)
    if ctx is not None:
        nh = (pad_to - 1) // sps + 1      # head outputs touching ctx
        L = nh * sps
        z = re.new_zeros(1)
        hr, hi = fir.fir_decimate_traced_planar_complex(
            torch.cat([z, ctx[0].to(re.dtype), re[:L]]),
            torch.cat([z, ctx[1].to(re.dtype), im[:L]]), fr, fi, sps)
        off = pad_to // sps               # zero + ctx consume MD/sps
        sr_all = torch.cat([hr[off:off + nh], sr_all[nh:]])
        si_all = torch.cat([hi[off:off + nh], si_all[nh:]])
    sr_all, si_all = mixer.derotate_traced_planar(
        sr_all, si_all, mixer.scalar(w, re.device) * float(sps),
        phase0=phase0)
    return sr_all[1:], si_all[1:]


# Symbols per segment of the fine-carrier slope refinement (_symbol_tail).
SLOPE_SEGMENT = 65536


def _fourth_power(sr, si):
    s2r, s2i = sr * sr - si * si, 2.0 * sr * si
    return s2r * s2r - s2i * s2i, 2.0 * s2r * s2i


def _slope_fit(zr, zi):
    """Least-squares slope (rad/symbol) of the 4th-power phases of K >= 2
    consecutive segment sums ``zr + j*zi``, unwrapped across segments."""
    K = zr.shape[0]
    ph = torch.atan2(zi, zr)
    step = torch.remainder(ph[1:] - ph[:-1] + np.pi, 2.0 * np.pi) - np.pi
    ph = torch.cat([ph[:1], ph[:1] + torch.cumsum(step, 0)])
    x = torch.arange(K, dtype=ph.dtype, device=ph.device) - (K - 1) / 2.0
    # sum(x^2) = K (K^2 - 1) / 12 for the centred segment index x
    return torch.sum(x * ph) * (12.0 / (K * (K * K - 1))) / (
        4.0 * SLOPE_SEGMENT)


def _phase_slope(q4r, q4i):
    """Residual carrier slope (rad/symbol) of symbols whose 4th powers
    are ``q4r + j*q4i``: the 4th-power phase of each ``SLOPE_SEGMENT``-
    symbol segment, unwrapped across segments and fitted by least
    squares.  None for a block of fewer than two segments."""
    K = q4r.shape[0] // SLOPE_SEGMENT
    if K < 2:
        return None
    zr = q4r[:K * SLOPE_SEGMENT].reshape(K, SLOPE_SEGMENT).sum(1)
    zi = q4i[:K * SLOPE_SEGMENT].reshape(K, SLOPE_SEGMENT).sum(1)
    return _slope_fit(zr, zi)


def _phase_slope_sharded(q4s, starts, reduce, total=None):
    """:func:`_phase_slope` over a block held as shards: ``q4s`` the
    per-shard ``(q4r, q4i)`` in shard order (this process's shards),
    ``starts`` each shard's global first-symbol index, ``total`` the
    block's symbols (by default those of ``q4s``, every shard in one
    process).  Each shard sums its symbols per global segment; ``reduce``
    adds the per-shard segment sums in shard order; the fit runs once on
    the global sums.  None for a block of fewer than two segments."""
    if total is None:
        total = sum(int(q[0].shape[0]) for q in q4s)
    K = total // SLOPE_SEGMENT
    if K < 2:
        return None
    nseg = -(-total // SLOPE_SEGMENT)
    parts = []
    for (q4r, q4i), o in zip(q4s, starts):
        g0, head = divmod(int(o), SLOPE_SEGMENT)
        n = int(q4r.shape[0])
        ns = -(-(head + n) // SLOPE_SEGMENT)
        pad = (head, ns * SLOPE_SEGMENT - head - n)
        sums = []
        for q in (q4r, q4i):
            z = torch.nn.functional.pad(q, pad).reshape(ns, SLOPE_SEGMENT)
            sums.append(torch.nn.functional.pad(
                z.sum(1), (g0, nseg - g0 - ns)))
        parts.append(tuple(sums))
    zr, zi = reduce(parts)
    return _slope_fit(zr[:K], zi[:K])


def _two_pi_anchor(w, mloc, idx):
    """``mod(mod(w * mloc, 2 pi) * idx, 2 pi)``: a rotation's phase at a
    shard's first symbol (global index idx * mloc), reduced mod 2 pi per
    factor so that no float32 product exceeds ~2 pi * idx."""
    two_pi = float(np.float32(2.0 * np.pi))
    return torch.remainder(torch.remainder(w * float(mloc), two_pi)
                           * float(idx), two_pi)


def _symbol_tail(sr, si, fphase=None, pfine=None, warm=None, reduce=None,
                 sym_offset=None):
    """Symbol-rate tail: fine carrier (4th power), then the Mengali
    5.7.4 phase estimate and the rotation onto +-1+-1j.  Returns
    ``(sym_planes, diag)``.

    The fine carrier is the JAX package's lag-1 estimate, angle(sum
    (s[m] conj(s[m-1]))^4) / 4.  On the QPSK waveform it is biased by
    about 1e-7 rad/symbol (ISI between neighbouring symbols weights its
    terms unevenly), which turns an 8.4M-symbol block by up to pi from
    one end to the other.  So in a block of at least two
    ``SLOPE_SEGMENT``-symbol segments the port fits the residual slope of
    the segments' 4th-power phases and adds it (``_phase_slope``); a
    shorter block, such as every block of the JAX tests, runs the JAX
    package's operations unchanged.

    Streaming (the stream steps): ``fphase`` is the carried fine-carrier
    phase at the block start (``diag["fphase_next"]`` carries it on);
    ``pfine``/``warm`` the previous phase estimate, against which the new
    one is unwrapped mod pi/2 so the 4-fold ambiguity cannot jump
    quadrants at block seams (``diag["phase"]`` is the value to carry).

    Sharding (``parallel.qpsk_rx_sharded``): ``sr``/``si`` are lists of
    per-shard symbol planes in shard order, ``reduce`` maps the list of
    the shards' estimator sums (tuples of tensors) to their global sums
    (the sums are additive across time shards), and ``sym_offset =
    (block_symbols, shard_indices, shards)`` anchors every rotation at
    each shard's global first symbol, so every shard applies the same
    globally coherent correction; the slope fit runs on the global
    segment sums of ``block_symbols * shards`` symbols.  The lists may
    hold a part of the shards (those of one process, across processes).
    The symbol planes come back as a list per shard."""
    sharded = reduce is not None
    srs, sis = (list(sr), list(si)) if sharded else ([sr], [si])
    red = reduce if sharded else (lambda parts: parts[0])
    if sym_offset is not None:
        mloc, idxs, nshards = sym_offset
    else:
        mloc, idxs, nshards = None, [0] * len(srs), len(srs)

    def anchored(phase0, w, idx):
        if mloc is None:
            return phase0
        return phase0 + _two_pi_anchor(w, mloc, idx)

    parts = []
    for a, b in zip(srs, sis):
        tr = a[1:] * a[:-1] + b[1:] * b[:-1]
        ti = b[1:] * a[:-1] - a[1:] * b[:-1]
        t4r, t4i = _fourth_power(tr, ti)
        parts.append((torch.sum(t4r), torch.sum(t4i)))
    s4r, s4i = red(parts)
    w_fine = torch.atan2(s4i, s4r) / 4.0
    phase0 = 0.0 if fphase is None else fphase
    rot = [mixer.derotate_traced_planar(a, b, w_fine,
                                        phase0=anchored(phase0, w_fine, i))
           for a, b, i in zip(srs, sis, idxs)]

    q4 = [_fourth_power(a, b) for a, b in rot]
    if sharded:
        per = mloc if mloc is not None else 0
        dw = _phase_slope_sharded(q4, [i * per for i in idxs], red,
                                  per * nshards if mloc is not None else None)
    else:
        dw = _phase_slope(*q4[0])
    if dw is not None:
        rot = [mixer.derotate_traced_planar(a, b, dw, phase0=anchored(
            0.0, dw, i)) for (a, b), i in zip(rot, idxs)]
        w_fine = w_fine + dw
        q4 = [_fourth_power(a, b) for a, b in rot]
    g4r, g4i = red([(torch.sum(qr), torch.sum(qi)) for qr, qi in q4])
    p_est = torch.atan2(g4i, g4r) / 4.0
    if pfine is not None:
        halfq = float(np.float32(np.pi / 4))
        dp = torch.remainder(p_est - pfine + halfq,
                             float(np.float32(np.pi / 2))) - halfq
        p_est = torch.where(warm > 0, pfine + dp, p_est)
    th = np.pi / 4 - p_est
    c, s = torch.cos(th), torch.sin(th)
    outs = [torch.stack([a * c - b * s, b * c + a * s], dim=0)
            for a, b in rot]
    diag = {"freq_fine": w_fine, "phase": p_est}
    if fphase is not None:
        diag["fphase_next"] = torch.remainder(
            fphase + w_fine * rot[0][0].shape[0],
            float(np.float32(2.0 * np.pi)))
    return (outs if sharded else outs[0]), diag


def _mf_kernel_tile_rows(cfg, re) -> int:
    """Tile rows of the FIR kernel for the staged matched filter (the
    largest of 1024, 512, ..., 8 dividing N/128), 0 for the tensor
    route."""
    n = int(re.shape[0])
    tr = 1024
    while tr >= 8 and n % (tr * _LANES):
        tr //= 2
    fits = tr >= 8
    if not _use_kernel(cfg, re, fits):
        return 0
    if not fits:
        raise ValueError(f"the FIR kernel needs N % 1024 == 0, got N={n}")
    return tr


def _rx_core_staged(cfg: QpskRxConfig, re, im):
    """Staged core: de-rotate, matched filter, panels of the filtered
    signal, one traced-tap decimating product.  All planar."""
    n = re.shape[0]
    sps = cfg.sps
    dev = re.device

    # coarse carrier (pre-matched-filter; a fine stage follows)
    f_est = demodulation.frequency_offset_estimate_planar(re, im)
    xr, xi = mixer.derotate_traced_planar(re, im, f_est)

    # matched filter, zero head context
    tr = _mf_kernel_tile_rows(cfg, re)
    if tr:
        cz_r, cz_i = _FK.planar_ctx_zero(dev)
        yr, yi, _, _ = _FK.fir_planar(xr, xi, cfg.mf_taps, cz_r, cz_i,
                                      tile_rows=tr)
    else:
        yr, yi = fir.fir_apply_planar(xr, xi, cfg.mf)

    # timing (Mengali 8.4); its panels also give the phase pick
    panels = cfg.timing.corr_panels(yr, yi)
    t_est = cfg.timing.estimate_from_panels(panels)
    lag, d_int = _lagrange(t_est)

    # symbol phase: e4[p] = sum_m |yd[sps*m+p]|^2 of the interpolated yd
    if 4 <= sps <= _LANES and _LANES % sps == 0:
        # as a quadratic form in lag over phase-restricted correlations,
        # e4[p] = Re sum_{j,j'} lag[j] lag[j'] G[(p-j) mod sps, j-j']
        P1, _p2, _p3, P4, meta = panels
        u7 = np.arange(-(sps - 1), sps)
        cols = _build.device_index(
            np.arange(_LANES)[:, None] + meta["nd"] + u7[None, :], dev)
        Gr = torch.gather(P1 - P4, 1, cols).reshape(
            _LANES // sps, sps, u7.size).sum(0)
        jj = np.arange(4)
        qh = (np.arange(sps)[:, None] - jj[None, :]) % sps
        uh = (jj[:, None] - jj[None, :]) + sps - 1
        sel = _build.device_index(qh[:, :, None] * u7.size
                                  + uh[None, :, :], dev)
        e4 = torch.einsum("j,k,pjk->p", lag, lag, torch.take(Gr, sel))
    else:
        # 2*sps - 1 < 7 (or sps not dividing 128): interpolate and sum
        bands = _build.device_constant(cfg.lag_bands, dev)
        B_lag = torch.tensordot(lag, bands, dims=1)
        yd, _ = fir.fir_block(torch.complex(yr, yi), B_lag,
                              torch.zeros(3, dtype=torch.complex64,
                                          device=dev))
        keep = (n // sps) * sps
        en = (yd.real ** 2 + yd.imag ** 2)[:keep]
        e4 = torch.sum(en.reshape(-1, sps), dim=0)
    shift = d_int + 1  # +1: interpolator basepoint
    p_star = torch.remainder(torch.argmax(e4).to(torch.int32) + shift, sps)

    # interpolation, integer shift, phase pick and downsample as one
    # traced-tap decimating product: sym[m] = sum_j lag[j] *
    # y[sps*m - shift2 - j], lag placed at t0 = shift2 + sps
    shift2 = shift - p_star
    t0 = shift2 + sps
    tt = _build.device_index(np.arange(3 * sps), dev)
    flat = torch.where((tt >= t0) & (tt < t0 + 4),
                       torch.take(lag, torch.clamp(tt - t0, 0, 3)), 0.0)
    sr_all, si_all = fir.fir_decimate_traced_planar(
        yr, yi, flat, sps, tail_zeros=sps)
    sr, si = _valid_mask(sr_all[1:], si_all[1:], n, sps, shift2)
    sym_planes, diag_tail = _symbol_tail(sr, si)
    diag = {"freq": f_est, "timing": t_est, "sym_phase": p_star,
            **diag_tail}
    return sym_planes, diag


def _as_complex(symbols) -> np.ndarray:
    """Accept complex [M], planar [2, M] (rx output), or pairs [M, 2],
    as numpy arrays or tensors."""
    if isinstance(symbols, torch.Tensor):
        symbols = symbols.detach().cpu().numpy()
    s = np.asarray(symbols)
    if s.ndim == 2 and s.shape[0] == 2 and s.shape[1] != 2:
        return s[0] + 1j * s[1]
    if s.ndim == 2 and s.shape[-1] == 2:
        return s[:, 0] + 1j * s[:, 1]
    return s


def decide_bits(symbols) -> np.ndarray:
    """Hard decisions back to the tx bit convention (re = 2*b0 - 1,
    im = 2*b1 - 1)."""
    s = _as_complex(symbols)
    out = np.empty(2 * len(s), dtype=np.uint8)
    out[0::2] = s.real > 0
    out[1::2] = s.imag > 0
    return out


def resolve_ambiguity(symbols, reference_bits, search: int = 1024,
                      max_lag: int = 16):
    """Resolve the 4-fold phase ambiguity and the pipeline's symbol lag
    against known bits: try the 4 rotations x lags in [0, max_lag] and
    return ``((rot, lag), errors, bits_compared)`` of the best."""
    best = None
    s = _as_complex(symbols)
    ref = np.asarray(reference_bits)
    for rot in range(4):
        cand = decide_bits(s * np.exp(1j * np.pi / 2 * rot))
        for lag in range(0, max_lag + 1):
            a = cand[2 * lag:]
            m = min(len(a), len(ref), search * 2)
            if m <= 0:
                continue
            errs = int(np.sum(a[:m] != ref[:m]))
            if best is None or errs < best[1]:
                best = ((rot, lag), errs, m)
    return best
