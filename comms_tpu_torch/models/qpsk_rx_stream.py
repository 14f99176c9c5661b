"""Streaming QPSK receivers: the Costas-loop stream receiver, and the
estimate-pipelined fast, fused and split stream steps.

Counterpart of :mod:`comms_tpu.models.qpsk_rx_stream`.

**The Costas-loop receiver** (:class:`QpskRxStreamConfig`,
:func:`init_state`, :func:`make_stream_fn`): every estimate is a carried
state smoothed across blocks, the matched filter carries its tail, and
the symbol grid is continuous across block seams (gap-free output with a
constant 2-symbol latency).  One block step runs, in order: the coarse
carrier (a lag-1 estimate smoothed by an EMA into a carried ``omega``,
the de-rotation phase ``theta`` carried so the mixer stays continuous),
the streaming matched filter (``ops.fir.fir_block`` on the banded
matrix), the NDA timing estimate (``TimingEstimator.estimate``) EMA'd
into the sampling phase ``tau``, the cubic Lagrange interpolation at
stream positions ``m*sps + tau`` over the carried 12-sample context, and
the decision-directed Costas loop at symbol rate
(``ops.demodulation.costas_loop_block``: one launch of the recurrence
kernel on the card).  Its boundary speaks float32 pairs: ``[N, 2]`` in,
``[N/sps, 2]`` out.  The 4-fold phase ambiguity and the constant lag are
resolved by the caller (``qpsk_rx.resolve_ambiguity``).

**The estimate-pipelined steps** (``cfg``: a ``qpsk_rx.QpskRxConfig``):
block k's full-rate work, the fused symbol product over the raw planes,
runs with block k-1's estimates, and block k's correlation panels give the
estimates for block k+1, so no full-rate operand waits on an estimate of
its own block.  The carried raw tail (``qpsk_rx.fused_gemm_ctx_len``
samples) keeps the symbol grid gap-free across block seams, the carried
``theta`` keeps the de-rotation phase continuous, and the symbol tail
carries its fine-carrier phase and unwraps the phase estimate against
the previous one.  Block 0 is a warm-up block (zero estimates): discard
its symbols.

* :func:`make_stream_fused_fn` is the production step: on CUDA tensors
  ONE call of the symbol kernel's ``_scalars`` entry computes the
  symbols and the panels (the estimates are read by the kernel from the
  device), then the panel-sized estimate chain runs in torch.
  With ``est_lag=2`` block k's symbols use block k-2's estimates,
  computed from the carried panels ``p1..p4`` of block k-1
  (:func:`init_state_fused2`); warm-up is two blocks.
* :func:`make_stream_fast_fn` is its separate-stages comparator: the
  fused symbol product, then the panels on their own.
* :func:`make_stream_split_fns` cuts the fast step in two: ``sym_fn``
  (the symbol kernel and the symbol tail) and ``est_fn`` (the panels and
  the estimate chain); :func:`make_split_serving_step` enqueues both a
  block and merges the estimates into the state as a dict update of
  device tensors, with no host synchronisation.

State dicts interchange between the steps and with the JAX package's
(:func:`state_from_jax`, :func:`stream_state_from_jax`), so a stream can
continue mid-way.  A step never synchronises with the host:
``StreamRunner`` can keep several blocks in flight.  The fused step marks
its three stages (symbols and panels, the symbol tail, the estimate
chain) as ``torch.profiler`` ranges named ``qpsk_stream.*``, so a trace
splits a block's time by stage.  Under ``torch.func.vmap`` (the batched
runner's ``mode="vmap"``) each of these steps (and ``sym_fn``,
``est_fn``) runs once a stream (``kernels._build.per_stream``), since the
symbol tail's and the estimate chain's sums would round otherwise on a
batch: a vmapped step equals a loop over its streams bit for bit.
Outside vmap the wrapper calls the step directly.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import qpsk_sym as _QS
from comms_tpu_torch.models import qpsk_rx as _rx
from comms_tpu_torch.ops import demodulation, fir, taps

__all__ = ["QpskRxStreamConfig", "make_stream_fn", "init_state",
           "stream_state_from_jax", "init_state_fast", "make_stream_fast_fn",
           "make_stream_fused_fn", "init_state_fused2",
           "make_stream_split_fns", "make_split_serving_step",
           "state_from_jax"]

_TWO_PI = float(np.float32(2.0 * np.pi))
_STATE_DTYPES = {"shift2": torch.int32}
_PANELS = ("p1", "p2", "p3", "p4")


class QpskRxStreamConfig:
    """Costas-loop stream receiver for the qpsk_tx waveform (RRC, sps,
    beta).

    ``block``: input samples per step (a multiple of sps).
    ``costas_alpha/beta``: symbol-rate loop gains (proportional /
    integrator).  ``g_freq``/``g_tau``: per-block EMA gains of the coarse
    carrier and the timing phase.
    """

    def __init__(self, block: int = 8192, sps: int = 4,
                 num_taps: int = 32, beta: float = 0.25,
                 timing_d: int = 5, costas_alpha: float = 0.1,
                 costas_beta: float = 0.005, g_freq: float = 0.2,
                 g_tau: float = 0.25):
        if block % sps:
            raise ValueError(f"block {block} must be a multiple of sps {sps}")
        self.block = int(block)
        self.sps = int(sps)
        # interpolator left context: the 2-symbol emission latency plus
        # the cubic window stays inside [ctx ++ block] for every tau in
        # [0, sps) (the lowest index is -2*sps + 3 relative to the block)
        self.L_CTX = max(12, 2 * self.sps + 4)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.costas_alpha = float(costas_alpha)
        self.costas_beta = float(costas_beta)
        self.g_freq = float(g_freq)
        self.g_tau = float(g_tau)
        t = taps.rrc_taps(num_taps, float(sps), beta)
        t = t / np.sqrt(np.sum(np.abs(t) ** 2))
        self.mf = fir.banded_tap_matrix(t.astype(np.complex64))
        self.timing = demodulation.TimingEstimator(
            n=self.sps, d=int(timing_d), alpha=self.beta)

    @property
    def syms_per_block(self) -> int:
        return self.block // self.sps


def init_state(cfg: QpskRxStreamConfig, device="cuda"):
    """Stream-start state of :func:`make_stream_fn` on ``device``: the JAX
    package's keys, complex tails as float32 pairs, the Costas state a
    ``(phase, freq)`` tuple."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mf_ctx": torch.zeros((cfg.num_taps - 1, 2), **f32),
        "interp_ctx": torch.zeros((cfg.L_CTX, 2), **f32),
        "theta": torch.zeros((), **f32),     # mixer phase (carried)
        "omega": torch.zeros((), **f32),     # rad/sample coarse carrier
        "tau": torch.zeros((), **f32),       # sampling phase in [0, sps)
        "costas": (torch.zeros((), **f32), torch.zeros((), **f32)),
        "warm": torch.zeros((), **f32),      # 0 = first block
    }


def stream_state_from_jax(state, device="cuda"):
    """A JAX :func:`init_state`-shaped state (dict of arrays, ``costas`` a
    pair) as this package's state on ``device``."""
    def f32(v):
        return torch.from_numpy(np.array(v, np.float32)).to(device)

    out = {k: f32(state[k]) for k in ("mf_ctx", "interp_ctx", "theta",
                                      "omega", "tau", "warm")}
    out["costas"] = tuple(f32(v) for v in state["costas"])
    return out


def _wrap_pi(a):
    return torch.remainder(a + np.pi, _TWO_PI) - np.pi


def _pairs(z):
    return torch.stack([z.real, z.imag], dim=-1)


def make_stream_fn(cfg: QpskRxStreamConfig):
    """``step(state, iq_pairs_f32[N, 2]) -> (sym_pairs_f32[M, 2],
    new_state)`` with M = N/sps symbols a block, gap-free.  Nothing is
    read back to the host."""
    sps = cfg.sps
    N = cfg.block
    M = cfg.syms_per_block
    L = cfg.L_CTX
    half = float(sps) / 2.0
    k_host = np.arange(N, dtype=np.float32)
    m_host = np.arange(M, dtype=np.float32)

    def step(state, iq_pairs):
        dev = iq_pairs.device
        xr, xi = iq_pairs[:, 0], iq_pairs[:, 1]
        warm = state["warm"]

        # -- 1. coarse carrier (EMA; the first block takes the raw
        # estimate)
        f_b = demodulation.frequency_offset_estimate(
            torch.complex(xr, xi)).to(torch.float32)
        omega = torch.where(
            warm > 0,
            state["omega"] + cfg.g_freq * _wrap_pi(f_b - state["omega"]),
            f_b)
        # x * e^{-j a} on the planes, in XLA's complex-product order
        a = state["theta"] + omega * _build.device_constant(k_host, dev)
        c, s = torch.cos(a), torch.sin(a)
        xc = torch.complex(xr * c + xi * s, xi * c - xr * s)
        theta = torch.remainder(state["theta"] + omega * N, _TWO_PI)

        # -- 2. matched filter (streaming)
        mf_ctx = torch.complex(state["mf_ctx"][:, 0], state["mf_ctx"][:, 1])
        y, mf_ctx = fir.fir_block(xc, cfg.mf, mf_ctx)

        # -- 3. timing: NDA estimate -> EMA'd sampling phase tau
        t_b = cfg.timing.estimate(y).to(torch.float32)
        tau_b = torch.remainder(t_b, float(sps))
        d = torch.remainder(tau_b - state["tau"] + half, float(sps)) - half
        tau = torch.where(warm > 0,
                          torch.remainder(state["tau"] + cfg.g_tau * d,
                                          float(sps)),
                          tau_b)

        # -- interpolate the continuous symbol grid m*sps + tau (the
        # 2-symbol latency keeps every cubic window inside [ctx ++ block])
        ictx = torch.complex(state["interp_ctx"][:, 0],
                             state["interp_ctx"][:, 1])
        y_ext = torch.cat([ictx, y])
        u = ((_build.device_constant(m_host, dev) - 2.0) * sps + tau) + L
        base = torch.floor(u).to(torch.int64)
        mu = u - base.to(torch.float32)
        p = [torch.take(y_ext, base + o) for o in (-1, 0, 1, 2)]
        w = [-mu * (mu - 1) * (mu - 2) / 6,
             (mu + 1) * (mu - 1) * (mu - 2) / 2,
             -(mu + 1) * mu * (mu - 2) / 2,
             (mu + 1) * mu * (mu - 1) / 6]
        sr = ((w[0] * p[0].real + w[1] * p[1].real) + w[2] * p[2].real
              + w[3] * p[3].real)
        si = ((w[0] * p[0].imag + w[1] * p[1].imag) + w[2] * p[2].imag
              + w[3] * p[3].imag)

        # -- 4. fine carrier: decision-directed Costas at symbol rate
        sym, costas = demodulation.costas_loop_block(
            torch.complex(sr, si), state["costas"], cfg.costas_alpha,
            cfg.costas_beta, order=4)

        new_state = {
            "mf_ctx": _pairs(mf_ctx),
            "interp_ctx": _pairs(y[-L:]),
            "theta": theta,
            "omega": omega,
            "tau": tau,
            "costas": costas,
            "warm": torch.ones_like(warm),
        }
        return _pairs(sym), new_state

    return step


def init_state_fast(cfg=None, device="cuda"):
    """Stream-start state of both steps (``cfg``: a ``QpskRxConfig``):
    zero raw tails, zero estimates, the identity interpolator."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()
    C = _rx.fused_gemm_ctx_len(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ctx_re": torch.zeros(C, **f32),
        "ctx_im": torch.zeros(C, **f32),
        "omega": torch.zeros((), **f32),
        "theta": torch.zeros((), **f32),
        "lag": torch.tensor([0.0, 1.0, 0.0, 0.0], **f32),
        "shift2": torch.zeros((), dtype=torch.int32, device=device),
        "fphase": torch.zeros((), **f32),   # fine-carrier phase
        "pfine": torch.zeros((), **f32),    # unwrapped phase estimate
        "warm": torch.zeros((), **f32),
    }


def init_state_fused2(cfg=None, device="cuda"):
    """State of ``make_stream_fused_fn(cfg, est_lag=2)``: the fast state
    plus carried zero panels ``p1..p4`` [128, 128 + 2 panel_hw] (warm-up
    is two blocks)."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()
    st = init_state_fast(cfg, device)
    for k in _PANELS:
        st[k] = torch.zeros((128, 2 * cfg.panel_hw + 128),
                            dtype=torch.float32, device=device)
    return st


def state_from_jax(state, device="cuda"):
    """A JAX fast/fused stream state (dict of arrays: ``ctx_re, ctx_im,
    omega, theta, lag, shift2, fphase, pfine, warm``, and ``p1..p4`` for
    ``est_lag=2``) as this package's state on ``device``."""
    keys = ["ctx_re", "ctx_im", "omega", "theta", "lag", "shift2", "fphase",
            "pfine", "warm"]
    keys += [k for k in _PANELS if k in state]
    out = {}
    for k in keys:
        dt = _STATE_DTYPES.get(k, torch.float32)
        out[k] = torch.from_numpy(np.array(state[k])).to(device=device,
                                                         dtype=dt)
    return out


def _clamp_shift(cfg, shift_b, p_sym):
    """The one-shot fused core's tap-window bounds on shift2."""
    return torch.clamp(shift_b - p_sym, -cfg.sps, 2 * cfg.sps - 4)


def _next_state(cfg, state, re, im, dtail, est):
    """The next block's state: ``dtail`` from ``qpsk_rx._symbol_tail``,
    ``est`` = (omega, lag, shift2)."""
    C = _rx.fused_gemm_ctx_len(cfg)
    n = re.shape[0]
    f_b, lag_b, shift2 = est
    return {
        "ctx_re": re[-C:].clone(),
        "ctx_im": im[-C:].clone(),
        "omega": f_b,
        # the block just processed advanced the carried phase by omega*n
        "theta": torch.remainder(state["theta"] + state["omega"] * n,
                                 _TWO_PI),
        "lag": lag_b,
        "shift2": shift2,
        "fphase": dtail["fphase_next"],
        "pfine": dtail["phase"],
        "warm": torch.ones_like(state["warm"]),
    }


def _symbol_tail(state, sr, si):
    return _rx._symbol_tail(sr, si, fphase=state["fphase"],
                            pfine=state["pfine"], warm=state["warm"])


def make_stream_fast_fn(cfg=None):
    """``step(state, re[N], im[N]) -> (sym_planes[2, N/sps], state)``:
    the fused symbol product with the carried estimates, the symbol
    tail, then this block's panels and estimates for the next block."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()

    def step(state, re, im):
        sr, si = _rx._fused_symbol_gemm(
            cfg, re, im, state["omega"], state["lag"], state["shift2"],
            ctx=(state["ctx_re"], state["ctx_im"]), phase0=state["theta"])
        sym_planes, dtail = _symbol_tail(state, sr, si)
        f_b, _t_b, lag_b, shift_b, p_sym = _rx._panel_estimates(cfg, re, im)
        return sym_planes, _next_state(
            cfg, state, re, im, dtail,
            (f_b, lag_b, _clamp_shift(cfg, shift_b, p_sym)))

    return _build.per_stream(step)


def make_stream_fused_fn(cfg=None, est_lag: int = 1):
    """The single-kernel stream step: symbols and panels of block k from
    one call of the symbol kernel (its ``_scalars`` entry with panels;
    the plain versions for CPU tensors), the same computation as
    :func:`make_stream_fast_fn` at ``est_lag=1``.  At ``est_lag=2`` block
    k's symbols use block k-2's estimates: the estimate chain runs on the
    carried panels of block k-1 (state from :func:`init_state_fused2`), so
    it has no data path into block k's kernel.  Needs sps 4, N %
    ``IN_PER_STEP`` == 0 and a panel halfwidth in (0, 64] (the default
    config's is 51)."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()
    if cfg.sps != _QS.SPS:
        raise ValueError(f"fused stream step needs sps={_QS.SPS}")
    if not 0 < cfg.panel_hw <= 64:
        raise ValueError(f"panel halfwidth {cfg.panel_hw} outside the "
                         f"kernel's (0, 64] bound")
    if est_lag not in (1, 2):
        raise ValueError(f"est_lag must be 1 or 2, got {est_lag}")
    meta = {"nd": cfg.panel_hw, "fdt": torch.float32}   # carried panels'

    def step(state, re, im):
        with record_function("qpsk_stream.symbols_and_panels"):
            sr, si, panels = _QS.qpsk_symbol_gemm_scalars(
                re, im, cfg.mf_taps, state["omega"], state["lag"],
                state["shift2"], phase0=state["theta"],
                ctx=(state["ctx_re"], state["ctx_im"]),
                panels_hw=cfg.panel_hw)
        with record_function("qpsk_stream.symbol_tail"):
            sym_planes, dtail = _symbol_tail(state, sr, si)
        with record_function("qpsk_stream.estimates"):
            # at est_lag 2 the carried panels of block k-1: no data path
            # into this block's kernel
            P = (panels if est_lag == 1 else
                 (*(state[k] for k in _PANELS), meta))
            f_b, _t_b, lag_b, shift_b, p_sym = _rx._estimates_from_panels(
                cfg, P)
            new_state = _next_state(
                cfg, state, re, im, dtail,
                (f_b, lag_b, _clamp_shift(cfg, shift_b, p_sym)))
            if est_lag == 2:
                new_state.update(zip(_PANELS, panels[:4]))
            return sym_planes, new_state

    return _build.per_stream(step)


def make_stream_split_fns(cfg=None):
    """The two-dispatch form of :func:`make_stream_fast_fn`, the same
    state and outputs, the two full-rate stages as separate calls:

        sym, state = sym_fn(state, re, im)     # symbol kernel + tail
        omega, lag, shift2 = est_fn(re, im)    # panels -> next block
        state = {**state, "omega": omega, "lag": lag, "shift2": shift2}

    ``sym_fn`` runs the fused symbol product (the symbol kernel's
    ``_scalars`` entry on the card) with the carried estimates and the
    symbol tail, and leaves the estimates as they are; ``est_fn`` runs the
    panels (the symbol kernel's panel entry on the card) and the estimate
    chain.  The merge is a dict update of device tensors: no
    synchronisation, no transfer.  State from :func:`init_state_fast`."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()

    def sym_fn(state, re, im):
        sr, si = _rx._fused_symbol_gemm(
            cfg, re, im, state["omega"], state["lag"], state["shift2"],
            ctx=(state["ctx_re"], state["ctx_im"]), phase0=state["theta"])
        sym_planes, dtail = _symbol_tail(state, sr, si)
        # the estimates stay as they are: est_fn's outputs replace them
        return sym_planes, _next_state(
            cfg, state, re, im, dtail,
            (state["omega"], state["lag"], state["shift2"]))

    def est_fn(re, im):
        f_b, _t_b, lag_b, shift_b, p_sym = _rx._panel_estimates(cfg, re, im)
        return f_b, lag_b, _clamp_shift(cfg, shift_b, p_sym)

    return _build.per_stream(sym_fn), _build.per_stream(est_fn)


def make_split_serving_step(cfg=None):
    """:func:`make_stream_split_fns` as one ``StreamRunner`` step
    ``(state, (re, im)) -> (sym_planes, state)``: both calls enqueued
    back to back, the estimates merged as a dict update of device tensors,
    so blocks stay in flight.  State from :func:`init_state_fast`; block 0
    is warm-up (discard its symbols).  Outputs equal driving
    :func:`make_stream_split_fns` by hand."""
    sym_fn, est_fn = make_stream_split_fns(cfg)

    def step(state, x):
        re, im = x
        sym, state = sym_fn(state, re, im)
        omega, lag, shift2 = est_fn(re, im)
        return sym, {**state, "omega": omega, "lag": lag, "shift2": shift2}

    return step
