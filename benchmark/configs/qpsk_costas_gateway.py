"""Plain reference of ``qpsk_costas_gateway``: the Costas-loop QPSK
receiver of every carrier, written from comms-rs's equations alone
(plain PyTorch; no kernel, no batching rule, one carrier a row):

    carrier   f = arg(sum_n x[n+1] conj(x[n]))   (frequency_estimator.rs:27-42)
              omega <- omega + g_freq wrap(f - omega)  (f on the first block)
              xc[n] = x[n] exp(-j (theta + omega n)),  theta <- theta + omega N
    mf        y[n] = sum_t h[t] xc[n - t]         (RRC, num_taps, beta, unit
                                                   energy; the last T-1 mixed
                                                   samples carried)
    timing    r[k] = exp(-j pi k / sps),  a = conj(y) r,  d = y r
              qout[m] = sum_t q[t] a[m - t]       (zero state each block)
              s = sum_m qout[m] d[m - sps D]      (timing_estimator.rs:13-113:
              t = -sps arg(s) / (2 pi)              Mengali's q, 2 sps D + 1
                                                    taps, then an sps D delay)
              tau <- tau + g_tau (t - tau, wrapped into [-sps/2, sps/2)),
                     mod sps (t mod sps on the first block)
    interp    u[m] = (m - 2) sps + tau + 12 over [12 carried samples ++ y];
              cubic Lagrange over the 4 samples around u, at fraction
              tau - floor(tau)
    costas    c = s exp(-j ph),  e = arg(-c^4) / 4,
              fr <- fr + beta e,  ph <- ph + fr + alpha e;  the output is c
              (ph carried mod 2 pi from block to block)

The upstream's receiver chain stops at the estimates; the port's
``examples/qpsk_receiver.py:52-66`` closes them into this loop, and
departs from the upstream in these ways, which the reference shares:
the estimates are smoothed across blocks by the EMAs above; the mixer's
phase and the filter's tail are carried, so the stream is continuous
across blocks; the symbol grid runs 2 symbols late, inside the carried
context.  The phases are carried mod 2 pi and the grid's whole samples
as integers, as the program carries them, so that the float32 controls
below round as float32 arithmetic must, not as an accumulator that
grows with the stream does.

Each carrier's block is then turned by the quarter-turn that takes its
first symbol into the first quadrant (:mod:`benchlib.quadrant`), as
the served path turns the program's: a decision-directed loop locks to
any of four quarter-turns, set by the cycle slips of its pull-in, which
a float32 and a float64 receiver can count differently; this is the
check's canonical form of that ambiguity.

The ring is one period of a periodic channel, so every carrier's state
settles onto one orbit whatever block it started from.
:func:`block_output` runs every carrier from zero state at ring block
0 for ``check.settle_blocks`` blocks, then on to block g's ring index;
the settled run is cached, so the blocks checked in one run cost one
run.  The arithmetic is in the precision of :mod:`benchlib.precision`
(float64 for the reference): the controls store each stage's output in
bfloat16, or round both factors of the filters' and the timing
estimate's products to TF32.
"""

from __future__ import annotations

import math

import torch

from benchlib import precision
from benchlib.quadrant import first_quadrant

CTX = 12                    # the interpolator's carried samples
_CACHE = {}


def rrc_taps(num_taps: int, sps: int, beta: float) -> torch.Tensor:
    """Root-raised-cosine taps at ``t = (i - (T-1)/2) / sps`` symbols,
    unit energy, float64 (at sps 4, beta 0.25 and an even count no tap
    lands on a singular point of the formula)."""
    t = (torch.arange(num_taps, dtype=torch.float64) - (num_taps - 1) / 2) \
        / sps
    h = ((torch.sin(math.pi * t * (1 - beta))
          + 4 * beta * t * torch.cos(math.pi * t * (1 + beta)))
         / (math.pi * t * (1 - (4 * beta * t) ** 2)))
    return h / h.square().sum().sqrt()


def q_taps(num_taps: int, alpha: float, sps: int) -> torch.Tensor:
    """Mengali's q(t) = alpha cos(pi alpha t) / (pi (1 - (2 alpha t)^2))
    at ``t = (i - D) / sps`` symbols, its limit alpha / 4 where
    |2 alpha t| = 1; float64."""
    d = num_taps // 2
    t = (torch.arange(num_taps, dtype=torch.float64) - d) / sps
    x = 2 * alpha * t
    general = alpha * torch.cos(math.pi * alpha * t) / (math.pi * (1 - x * x))
    return torch.where((x.abs() - 1).abs() < 1e-9,
                       torch.full_like(t, alpha / 4), general)


def _planes(fn):
    """``fn`` on both planes of a complex tensor (none where ``fn`` is the
    identity, as in float64)."""
    if fn is precision.get("float64").store:
        return lambda z: z
    return lambda z: torch.complex(fn(z.real), fn(z.imag))


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


class _Chain:
    """Every carrier's receiver state ([B] a key), and one block step."""

    def __init__(self, cfg: dict, B: int, p, device):
        self.cfg, self.p = cfg, p
        self.sps = int(cfg["sps"])
        self.rt = dict(dtype=p.dt, device=device)
        self.ct = torch.complex128 if p.dt == torch.float64 \
            else torch.complex64
        T = int(cfg["num_taps"])
        # the taps as numbers: each the value in p.dt, rounded as p rounds
        # a product's factors
        self.h = p.operand(rrc_taps(T, self.sps, float(cfg["beta"]))
                           .to(**self.rt)).tolist()
        nd = self.sps * int(cfg["timing_d"])
        self.nd = nd
        self.q = p.operand(q_taps(2 * nd + 1, float(cfg["beta"]), self.sps)
                           .to(**self.rt)).tolist()
        z = torch.zeros(B, **self.rt)
        self.theta, self.omega, self.tau = z.clone(), z.clone(), z.clone()
        self.ph, self.fr = z.clone(), z.clone()
        self.warm = False
        self.graph = None
        self.mf_ctx = torch.zeros((B, T - 1), dtype=self.ct, device=device)
        self.ictx = torch.zeros((B, CTX), dtype=self.ct, device=device)

    def step(self, x):
        """Block ``x`` [B, N] (complex) to its symbols [B, N / sps]."""
        c, p, sps = self.cfg, self.p, self.sps
        B, N = x.shape
        st, op = _planes(p.store), _planes(p.operand)
        x = st(x)
        # carrier
        f = torch.angle((x[:, 1:] * x[:, :-1].conj()).sum(-1))
        self.omega = (self.omega + c["g_freq"] * _wrap(f - self.omega)
                      if self.warm else f)
        n = torch.arange(N, **self.rt)
        a = self.theta[:, None] + self.omega[:, None] * n
        xc = st(x * torch.polar(torch.ones_like(a), -a))
        self.theta = torch.remainder(self.theta + self.omega * N,
                                     2 * math.pi)
        # matched filter, the last T-1 mixed samples carried
        T = len(self.h)
        xe = torch.cat([self.mf_ctx, xc], 1)
        self.mf_ctx = xe[:, N:]
        xo = op(xe)
        y = self.h[0] * xo[:, T - 1:]
        for t in range(1, T):
            y.add_(xo[:, T - 1 - t:T - 1 - t + N], alpha=self.h[t])
        y = st(y)
        # timing: Mengali's q filter and the sps D delay, fresh each block
        r = torch.polar(torch.ones(N, **self.rt),
                        -math.pi * torch.arange(N, **self.rt) / sps)
        a = op(torch.cat([y.new_zeros(B, 2 * self.nd), y.conj() * r], 1))
        qout = self.q[0] * a[:, 2 * self.nd:]
        for t in range(1, 2 * self.nd + 1):
            qout.add_(a[:, 2 * self.nd - t:2 * self.nd - t + N],
                      alpha=self.q[t])
        d = op(y * r)
        s = (qout[:, self.nd:] * d[:, :N - self.nd]).sum(-1)
        t_b = -sps * torch.angle(s) / (2 * math.pi)
        tau_b = torch.remainder(t_b, sps)
        dt = torch.remainder(tau_b - self.tau + sps / 2, sps) - sps / 2
        self.tau = (torch.remainder(self.tau + c["g_tau"] * dt, sps)
                    if self.warm else tau_b)
        # cubic Lagrange on the grid (m - 2) sps + tau, 2 symbols late:
        # whole samples as integers, the fraction tau's
        ye = torch.cat([self.ictx, y], 1)
        self.ictx = y[:, N - CTX:]
        M = N // sps
        whole = torch.floor(self.tau)
        mu = (self.tau - whole)[:, None]
        base = ((torch.arange(M, device=y.device) - 2) * sps + CTX)[None] \
            + whole.long()[:, None]
        w = [-mu * (mu - 1) * (mu - 2) / 6,
             (mu + 1) * (mu - 1) * (mu - 2) / 2,
             -(mu + 1) * mu * (mu - 2) / 2,
             (mu + 1) * mu * (mu - 1) / 6]
        ye = op(ye)
        sym = 0
        for o, wo in zip((-1, 0, 1, 2), w):
            sym = sym + p.operand(wo) * torch.gather(ye, 1, base + o)
        sym = st(sym)
        # the order-4 decision-directed Costas loop at symbol rate
        out, ph, self.fr = self.costas(sym, self.ph, self.fr)
        self.ph = torch.remainder(ph, 2 * math.pi)
        self.warm = True
        return first_quadrant(torch.view_as_real(st(out)).to(torch.float64))


    def _loop(self, sym, ph, fr):
        """The Costas loop over ``sym`` [B, M] from ``(ph, fr)`` [B]:
        ``-c^4`` as one product, ``e / 4`` folded into the gains."""
        a, b = self.cfg["costas_alpha"] / 4, self.cfg["costas_beta"] / 4
        zero, one = torch.zeros_like(sym[:, 0]), torch.ones_like(ph)
        out = []
        for m in range(sym.shape[1]):
            cm = sym[:, m] * torch.polar(one, -ph)
            c2 = cm * cm
            e4 = torch.angle(torch.addcmul(zero, c2, c2, value=-1))
            fr = torch.add(fr, e4, alpha=b)
            ph = torch.add(ph + fr, e4, alpha=a)
            out.append(cm)
        return torch.stack(out, 1), ph, fr

    def costas(self, sym, ph, fr):
        """:meth:`_loop`; on the card one CUDA graph of it, captured on the
        first block and replayed on the others (the same kernels on the
        same values: the loop is some 16,000 launches a block)."""
        if sym.device.type != "cuda":
            return self._loop(sym, ph, fr)
        if self.graph is None:
            self.static = [sym.clone(), ph.clone(), fr.clone()]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._loop(*self.static)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.result = self._loop(*self.static)
        for t, v in zip(self.static, (sym, ph, fr)):
            t.copy_(v)
        self.graph.replay()
        return tuple(t.clone() for t in self.result)


def settled(ring: dict, cfg: dict, prec: str, periods: int = 1) -> list:
    """The outputs [B, N / sps, 2] (float64) of ``periods`` ring periods
    after ``check.settle_blocks`` blocks from zero state at ring block 0:
    item j is block ``settle_blocks + j``'s."""
    p = precision.get(prec)
    iq = ring["iq"]
    R, B = iq.shape[:2]
    S = int(cfg["check"]["settle_blocks"])
    chain = _Chain(cfg, B, p, iq.device)
    out = []
    for j in range(S + periods * R):
        x = iq[j % R].to(p.dt)
        y = chain.step(torch.complex(x[..., 0], x[..., 1]))
        if j >= S:
            out.append(y)
    return out


def block_output(ring: dict, g: int, cfg: dict, prec: str) -> torch.Tensor:
    """Symbols ``[B, N / sps, 2]`` of ring block ``g`` in precision
    ``prec``, on the settled orbit (one run a ring and precision)."""
    iq = ring["iq"]
    R = iq.shape[0]
    S = int(cfg["check"]["settle_blocks"])
    if _CACHE.get("ring") is not iq:
        _CACHE.clear()
        _CACHE["ring"] = iq
    key = (prec, S)
    if key not in _CACHE:
        _CACHE[key] = {(S + j) % R: y
                       for j, y in enumerate(settled(ring, cfg, prec))}
    return _CACHE[key][g % R]
