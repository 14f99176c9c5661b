"""B independent narrowband QPSK carriers, each already channelized to
``sps`` samples a symbol, as a ring of R rounds of float32 re/im pairs
``[R, B, N, 2]`` on the device.

The ring is one period of a periodic channel, L = R N samples a
carrier, so a carrier cycled through the ring is one continuous signal.
Per carrier, from the seed: random bits, mapped as comms-rs
``src/modulation/digital.rs:24-36`` maps a pair (b0, b1) to
``(1 - 2 b0) + j (1 - 2 b1)``; zero-stuffed by ``sps`` (``examples/
qpsk_zmq.rs:33-63``); a circular RRC of ``num_taps`` taps at ``beta``
(``examples/bpsk_mod.rs:129-131``, unit energy); a circular delay in
[0, sps) samples (a phase ramp over the period's DFT: the shaped signal
is band-limited well inside the Nyquist band); a carrier of
``omega = 2 pi k / L`` rad/sample, ``|omega| <= max_omega``, and a phase
in [0, 2 pi); complex Gaussian noise at ``esn0_db`` (Es the shaped
symbol's energy), drawn once for the period.  Computed in float64 on the
device, carrier by carrier in chunks, and stored as float32.

``make`` is handed the samples of a round, B N; it learns N from
``params["carrier_samples"]``, and the pulse from ``params``.
"""

from __future__ import annotations

import math

import torch

CHUNK = 512          # carriers made at once


def rrc(num_taps: int, sps: int, beta: float, device) -> torch.Tensor:
    """Root-raised-cosine taps at ``t = (i - (T-1)/2) / sps`` symbols,
    unit energy, float64 (no tap of an even count at sps 4 and beta 0.25
    lands on a singular point of the formula, checked)."""
    t = (torch.arange(num_taps, dtype=torch.float64, device=device)
         - (num_taps - 1) / 2) / sps
    if bool(((4 * beta * t).abs() - 1).abs().lt(1e-9).any()) \
            or bool(t.abs().lt(1e-9).any()):
        raise ValueError("an RRC tap on a singular point")
    h = ((torch.sin(math.pi * t * (1 - beta))
          + 4 * beta * t * torch.cos(math.pi * t * (1 + beta)))
         / (math.pi * t * (1 - (4 * beta * t) ** 2)))
    return h / h.square().sum().sqrt()


def make(params: dict, blocks: int, block: int, seed: int, device) -> dict:
    """``{"iq": [blocks, B, N, 2]}`` float32 and the carriers' draws
    (``omega``, ``delay``, ``phase``, [B] float64) from ``seed``."""
    N = int(params["carrier_samples"])
    if block % N:
        raise ValueError(f"a round of {block} samples is not a whole "
                         f"number of {N}-sample carrier blocks")
    B = block // N
    sps = int(params["sps"])
    L = blocks * N
    if L % sps:
        raise ValueError(f"the period {L} is not a whole number of symbols")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    kmax = math.floor(float(params["max_omega"]) * L / (2 * math.pi))
    k = torch.randint(-kmax, kmax + 1, (B,), generator=g, device=device)
    delay = sps * torch.rand(B, generator=g, **f64)
    phase = 2 * math.pi * torch.rand(B, generator=g, **f64)
    h = rrc(int(params["num_taps"]), sps, float(params["beta"]), device)
    H = torch.fft.fft(torch.nn.functional.pad(h, (0, L - h.shape[0])))
    f = torch.fft.fftfreq(L, **f64)
    n = torch.arange(L, **f64)
    es = 2.0 * float(h.square().sum())
    sigma = math.sqrt(es / 10 ** (float(params["esn0_db"]) / 10) / 2)
    iq = torch.empty((blocks, B, N, 2), dtype=torch.float32, device=device)
    for lo in range(0, B, CHUNK):
        hi = min(lo + CHUNK, B)
        c = hi - lo
        bits = torch.randint(0, 2, (2, c, L // sps), generator=g,
                             device=device).to(torch.float64)
        x = torch.zeros((c, L), dtype=torch.complex128, device=device)
        x[:, ::sps] = torch.complex(1 - 2 * bits[0], 1 - 2 * bits[1])
        X = torch.fft.fft(x) * H
        X = X * torch.polar(torch.ones_like(f), -2 * math.pi * f
                            * delay[lo:hi, None])
        s = torch.fft.ifft(X)
        # the carrier's phase from (k n mod L), exact in float64
        ph = (torch.remainder(k[lo:hi, None].to(torch.float64) * n, L)
              * (2 * math.pi / L) + phase[lo:hi, None])
        s = s * torch.polar(torch.ones_like(ph), ph)
        noise = torch.randn((2, c, L), generator=g, **f64)
        re = (s.real + sigma * noise[0]).float()
        im = (s.imag + sigma * noise[1]).float()
        iq[:, lo:hi, :, 0] = re.view(c, blocks, N).transpose(0, 1)
        iq[:, lo:hi, :, 1] = im.view(c, blocks, N).transpose(0, 1)
        del x, X, s, ph, noise, re, im
    return {"iq": iq, "omega": 2 * math.pi * k.to(torch.float64) / L,
            "delay": delay, "phase": phase}
