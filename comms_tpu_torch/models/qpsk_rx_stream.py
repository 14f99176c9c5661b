"""Streaming QPSK receiver with estimate pipelining.

Counterpart of the fast and fused stream steps of
:mod:`comms_tpu.models.qpsk_rx_stream` (``est_lag=1``): block k's
full-rate work, the fused symbol product over the raw planes, runs with
block k-1's estimates, and block k's correlation panels give the
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
* :func:`make_stream_fast_fn` is its separate-stages comparator: the
  fused symbol product, then the panels on their own.

State dicts interchange between the two and with the JAX package's
(:func:`state_from_jax`), so a stream can continue mid-way.  A step never
synchronises with the host: ``StreamRunner`` can keep several blocks in
flight.  The fused step marks its three stages (symbols and panels, the
symbol tail, the estimate chain) as ``torch.profiler`` ranges named
``qpsk_stream.*``, so a trace splits a block's time by stage.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from comms_tpu_torch.kernels import qpsk_sym as _QS
from comms_tpu_torch.models import qpsk_rx as _rx

__all__ = ["init_state_fast", "make_stream_fast_fn", "make_stream_fused_fn",
           "state_from_jax"]

_TWO_PI = float(np.float32(2.0 * np.pi))
_STATE_DTYPES = {"shift2": torch.int32}


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


def state_from_jax(state, device="cuda"):
    """A JAX fast/fused stream state (dict of arrays: ``ctx_re, ctx_im,
    omega, theta, lag, shift2, fphase, pfine, warm``) as this package's
    state on ``device``."""
    out = {}
    for k in ("ctx_re", "ctx_im", "omega", "theta", "lag", "shift2",
              "fphase", "pfine", "warm"):
        dt = _STATE_DTYPES.get(k, torch.float32)
        out[k] = torch.from_numpy(np.array(state[k])).to(device=device,
                                                         dtype=dt)
    return out


def _next_state(cfg, state, re, im, dtail, f_b, lag_b, shift_b, p_sym):
    C = _rx.fused_gemm_ctx_len(cfg)
    n = re.shape[0]
    return {
        "ctx_re": re[-C:].clone(),
        "ctx_im": im[-C:].clone(),
        "omega": f_b,
        # the block just processed advanced the carried phase by omega*n
        "theta": torch.remainder(state["theta"] + state["omega"] * n,
                                 _TWO_PI),
        "lag": lag_b,
        # the one-shot fused core's tap-window bounds
        "shift2": torch.clamp(shift_b - p_sym, -cfg.sps, 2 * cfg.sps - 4),
        "fphase": dtail["fphase_next"],
        "pfine": dtail["phase"],
        "warm": torch.ones_like(state["warm"]),
    }


def make_stream_fast_fn(cfg=None):
    """``step(state, re[N], im[N]) -> (sym_planes[2, N/sps], state)``:
    the fused symbol product with the carried estimates, the symbol
    tail, then this block's panels and estimates for the next block."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()

    def step(state, re, im):
        sr, si = _rx._fused_symbol_gemm(
            cfg, re, im, state["omega"], state["lag"], state["shift2"],
            ctx=(state["ctx_re"], state["ctx_im"]), phase0=state["theta"])
        sym_planes, dtail = _rx._symbol_tail(
            sr, si, fphase=state["fphase"], pfine=state["pfine"],
            warm=state["warm"])
        f_b, _t_b, lag_b, shift_b, p_sym = _rx._panel_estimates(cfg, re, im)
        return sym_planes, _next_state(cfg, state, re, im, dtail, f_b,
                                       lag_b, shift_b, p_sym)

    return step


def make_stream_fused_fn(cfg=None):
    """The single-kernel stream step: symbols and panels of block k from
    one call of the symbol kernel (its ``_scalars`` entry with panels;
    the plain versions for CPU tensors), the same computation as
    :func:`make_stream_fast_fn`.  Needs sps 4, N % ``IN_PER_STEP`` == 0
    and a panel halfwidth in (0, 64] (the default config's is 51)."""
    cfg = cfg if cfg is not None else _rx.QpskRxConfig()
    if cfg.sps != _QS.SPS:
        raise ValueError(f"fused stream step needs sps={_QS.SPS}")
    if not 0 < cfg.panel_hw <= 64:
        raise ValueError(f"panel halfwidth {cfg.panel_hw} outside the "
                         f"kernel's (0, 64] bound")

    def step(state, re, im):
        with record_function("qpsk_stream.symbols_and_panels"):
            sr, si, panels = _QS.qpsk_symbol_gemm_scalars(
                re, im, cfg.mf_taps, state["omega"], state["lag"],
                state["shift2"], phase0=state["theta"],
                ctx=(state["ctx_re"], state["ctx_im"]),
                panels_hw=cfg.panel_hw)
        with record_function("qpsk_stream.symbol_tail"):
            sym_planes, dtail = _rx._symbol_tail(
                sr, si, fphase=state["fphase"], pfine=state["pfine"],
                warm=state["warm"])
        with record_function("qpsk_stream.estimates"):
            f_b, _t_b, lag_b, shift_b, p_sym = _rx._estimates_from_panels(
                cfg, panels)
            return sym_planes, _next_state(cfg, state, re, im, dtail, f_b,
                                           lag_b, shift_b, p_sym)

    return step
