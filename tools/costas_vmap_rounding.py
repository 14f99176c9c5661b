#!/usr/bin/env python3
"""Where the vmapped Costas stream receiver rounds apart from a loop over
its streams, and what running the stages that do once a stream costs, on
one CUDA card.

    python3 tools/costas_vmap_rounding.py [--device cpu] [--streams 8 64]

The step is a copy of ``qpsk_rx_stream.make_stream_fn``'s (8,192-sample
blocks) with its stages exposed.  Each variant runs chosen stages through
``kernels._build.per_stream`` (once a stream under vmap) or, for the
frequency estimate, sums by a tree of elementwise adds (the same adds on
one stream and on a batch):

* ``as served``: the package's step (every stage batched);
* ``freq per stream``: the frequency estimate's ``torch.sum`` once a
  stream;
* ``freq and mf per stream``: that and the matched filter's banded GEMM;
* ``tree freq, mf per stream``: the tree sum and the per-stream GEMM.

For each variant and stream count, over the phase 20 channel of
``chip_smoke.py`` (34 blocks, a seed a stream): the largest gap of each
stage's output between ``torch.func.vmap`` of the step and the step
called a stream at a time, from the same states (blocks 0, 1, 5 and 20);
the symbols' and states' largest gaps when each carries its own state
over the 34 blocks, and the first block where they part; the vmapped
step's host enqueue (median of 7, idle card) and device ms a round.  The
last line is the result as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from comms_tpu_torch.kernels import _build  # noqa: E402
from comms_tpu_torch.models import qpsk_rx_stream as ts  # noqa: E402
from comms_tpu_torch.ops import demodulation, fir  # noqa: E402

VARIANTS = {"as served": (), "freq per stream": ("freq",),
            "freq and mf per stream": ("freq", "mf"),
            "tree freq, mf per stream": ("tree", "mf")}
STAGE_BLOCKS = (0, 1, 5, 20)


def tree_sum(z):
    """The sum of ``z``'s last axis by halving it with elementwise adds
    (zero-padded to a power of two)."""
    n = z.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    z = torch.cat([z, z.new_zeros(size - n)])
    while z.shape[-1] > 1:
        h = z.shape[-1] // 2
        z = z[:h] + z[h:]
    return z[0]


def variant_step(cfg, stages):
    """``make_stream_fn``'s step, the named stages once a stream; returns
    ``(symbols, state, stage outputs)``."""
    N, M, L, sps = cfg.block, cfg.syms_per_block, cfg.L_CTX, cfg.sps
    half = float(sps) / 2.0
    k_host = np.arange(N, dtype=np.float32)
    m_host = np.arange(M, dtype=np.float32)

    def each(name, fn):
        return _build.per_stream(fn) if name in stages else fn

    def freq_est(xr, xi):
        x = torch.complex(xr, xi)
        if "tree" in stages:
            return torch.angle(tree_sum(x[1:] * torch.conj(x[:-1]))).to(
                torch.float32)
        return demodulation.frequency_offset_estimate(x).to(torch.float32)

    freq = each("freq", freq_est)
    mf = each("mf", lambda xc, ctx: fir.fir_block(xc, cfg.mf, ctx))

    def step(state, iq):
        dev = iq.device
        xr, xi = iq[:, 0], iq[:, 1]
        warm = state["warm"]
        f_b = freq(xr, xi)
        omega = torch.where(warm > 0, state["omega"] + cfg.g_freq
                            * ts._wrap_pi(f_b - state["omega"]), f_b)
        a = state["theta"] + omega * _build.device_constant(k_host, dev)
        c, s = torch.cos(a), torch.sin(a)
        xc = torch.complex(xr * c + xi * s, xi * c - xr * s)
        theta = torch.remainder(state["theta"] + omega * N, ts._TWO_PI)
        mf_ctx = torch.complex(state["mf_ctx"][:, 0], state["mf_ctx"][:, 1])
        y, mf_ctx = mf(xc, mf_ctx)
        t_b = cfg.timing.estimate(y).to(torch.float32)
        tau_b = torch.remainder(t_b, float(sps))
        d = torch.remainder(tau_b - state["tau"] + half, float(sps)) - half
        tau = torch.where(warm > 0, torch.remainder(
            state["tau"] + cfg.g_tau * d, float(sps)), tau_b)
        ictx = torch.complex(state["interp_ctx"][:, 0],
                             state["interp_ctx"][:, 1])
        y_ext = torch.cat([ictx, y])
        u = ((_build.device_constant(m_host, dev) - 2.0) * sps + tau) + L
        base = torch.floor(u).to(torch.int64)
        mu = u - base.to(torch.float32)
        p = [torch.index_select(y_ext, 0, base + o) for o in (-1, 0, 1, 2)]
        w = [-mu * (mu - 1) * (mu - 2) / 6,
             (mu + 1) * (mu - 1) * (mu - 2) / 2,
             -(mu + 1) * mu * (mu - 2) / 2,
             (mu + 1) * mu * (mu - 1) / 6]
        sr = ((w[0] * p[0].real + w[1] * p[1].real) + w[2] * p[2].real
              + w[3] * p[3].real)
        si = ((w[0] * p[0].imag + w[1] * p[1].imag) + w[2] * p[2].imag
              + w[3] * p[3].imag)
        sym, costas = demodulation.costas_loop_block(
            torch.complex(sr, si), state["costas"], cfg.costas_alpha,
            cfg.costas_beta, order=4)
        new_state = {"mf_ctx": ts._pairs(mf_ctx),
                     "interp_ctx": ts._pairs(y[-L:]), "theta": theta,
                     "omega": omega, "tau": tau, "costas": costas,
                     "warm": torch.ones_like(warm)}
        stage = {"freq estimate": f_b, "mixer": torch.view_as_real(xc),
                 "matched filter": torch.view_as_real(y), "timing": t_b,
                 "interpolator": torch.stack([sr, si], -1),
                 "costas": ts._pairs(sym)}
        return ts._pairs(sym), new_state, stage

    return step


def stack(states):
    return {k: (tuple(torch.stack([s[k][i] for s in states])
                      for i in range(2))
                if k == "costas" else torch.stack([s[k] for s in states]))
            for k in states[0]}


def stream(state, b):
    return {k: (tuple(t[b] for t in v) if k == "costas" else v[b])
            for k, v in state.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--blocks", type=int, default=cs.LINK_BLOCKS)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        print(card_name())
    cfg = ts.QpskRxStreamConfig(block=cs.LINK_BLOCK)
    N = cfg.block
    out = {}
    for S in args.streams:
        chans = [cs.link_channel(args.blocks, N, cs.LINK_SEED + b)[1]
                 for b in range(S)]
        rounds = [torch.stack([torch.from_numpy(p[k * N:(k + 1) * N])
                               for p in chans]).to(dev)
                  for k in range(args.blocks)]
        for name, stages in VARIANTS.items():
            step = variant_step(cfg, set(stages))
            vstep = torch.func.vmap(step)
            states = [ts.init_state(cfg, dev) for _ in range(S)]
            loop_sym, loop_states = [], []
            for k in range(args.blocks):
                loop_states.append(stack(states))
                ys = []
                for b in range(S):
                    y, states[b], _ = step(states[b], rounds[k][b])
                    ys.append(y)
                loop_sym.append(torch.stack(ys))
            loop_states.append(stack(states))
            stage = {}
            for k in (k for k in STAGE_BLOCKS if k < args.blocks):
                _, _, got = vstep(loop_states[k], rounds[k])
                for b in range(S):
                    _, _, want = step(stream(loop_states[k], b),
                                      rounds[k][b])
                    for q, t in want.items():
                        stage[q] = max(stage.get(q, 0.0),
                                       float((got[q][b] - t).abs().max()))
            st = stack([ts.init_state(cfg, dev) for _ in range(S)])
            sym_gap, gaps, first = 0.0, {}, None
            for k in range(args.blocks):
                y, st, _ = vstep(st, rounds[k])
                d = float((y - loop_sym[k]).abs().max())
                g = {}
                for b in range(S):
                    for q, v in cs.state_gaps(stream(st, b),
                                              stream(loop_states[k + 1], b),
                                              cfg.sps).items():
                        g[q] = max(g.get(q, 0.0), v)
                if first is None and (d or any(g.values())):
                    first = k
                sym_gap = max(sym_gap, d)
                gaps = {q: max(gaps.get(q, 0.0), v) for q, v in g.items()}
            enqueue = []
            for _ in range(7):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                vstep(st, rounds[5 % args.blocks])
                enqueue.append((time.perf_counter() - t0) * 1e3)
            dev_ms = (cs.cuda_ms(lambda: vstep(st, rounds[5 % args.blocks]),
                                 reps=5) if on_card else None)
            r = {"stage_gap": stage, "symbol_gap": sym_gap,
                 "state_gap": gaps, "first_block_apart": first,
                 "enqueue_ms": float(np.median(enqueue)),
                 "device_ms": dev_ms}
            out[f"{S} streams, {name}"] = r
            print(f"{S} streams, {name}: {json.dumps(r)}", flush=True)
    print(json.dumps(out))
    return 0


def card_name() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
