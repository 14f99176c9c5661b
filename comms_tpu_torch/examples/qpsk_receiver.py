"""Streaming QPSK receiver demo: continuous synchronization over a
simulated channel with a carrier-frequency step at the midpoint.

Counterpart of ``examples/qpsk_receiver.py``.  The reference ships the
estimator pieces (frequency, phase and timing, its
``src/demodulation/``) but no closed receiver; this demo serves
``models/qpsk_rx_stream``'s Costas-loop receiver (carried matched filter,
EMA'd carrier and timing, Costas fine tracking on the recurrence kernel
on a CUDA device) through ``StreamRunner`` at 8,192-sample blocks and
reports the bit error rate after acquisition.

Usage: python -m comms_tpu_torch.examples.qpsk_receiver [num_blocks]
       [--device cpu]
"""

from __future__ import annotations

import numpy as np

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.models import qpsk_rx_stream
from comms_tpu_torch.models.qpsk_rx import decide_bits
from comms_tpu_torch.ops import taps
from comms_tpu_torch.runtime.stream import StreamRunner

SPS, T, BETA = 4, 32, 0.25
SKIP = 3   # acquisition blocks


def make_channel(bits, freq1, freq2, step_at, delay, phase0):
    """The transmitted waveform of ``bits`` (RRC, sps 4), delayed by a
    fraction of a sample and turned by a carrier that steps from
    ``freq1`` to ``freq2`` rad/sample at sample ``step_at``."""
    rrc = np.asarray(taps.rrc_taps(T, float(SPS), BETA))
    rrc = rrc / np.sqrt(np.sum(np.abs(rrc) ** 2))
    pairs = bits.reshape(-1, 2)
    sym = ((2.0 * pairs[:, 0] - 1) + 1j * (2.0 * pairs[:, 1] - 1)
           ).astype(np.complex64)
    up = np.zeros(len(sym) * SPS, np.complex64)
    up[::SPS] = sym
    s = np.convolve(up, rrc.astype(np.complex64))[: len(up)]
    X = np.fft.fft(np.concatenate([s, np.zeros(256, s.dtype)]))
    k = np.fft.fftfreq(len(X))
    s = np.fft.ifft(X * np.exp(-2j * np.pi * k * delay))[: len(s)]
    n = np.arange(len(s))
    dph = np.where(n < step_at, freq1, freq2)
    return (s * np.exp(1j * (phase0 + np.cumsum(dph)))).astype(np.complex64)


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("num_blocks", nargs="?", type=int, default=24)
    return p


def main(argv=None):
    """Returns ``(bit errors, bits compared)`` after acquisition."""
    args = parser().parse_args(argv)
    n_blocks = args.num_blocks
    cfg = qpsk_rx_stream.QpskRxStreamConfig(block=8192)
    rng = np.random.default_rng(0)
    n_sym = n_blocks * cfg.syms_per_block + 64
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    r = make_channel(bits, 0.01, 0.013, n_blocks * cfg.block // 2,
                     1.4, 0.7)

    blocks = (
        np.stack([r[b * cfg.block:(b + 1) * cfg.block].real,
                  r[b * cfg.block:(b + 1) * cfg.block].imag],
                 axis=-1).astype(np.float32)
        for b in range(n_blocks)
    )
    out = []
    runner = StreamRunner(qpsk_rx_stream.make_stream_fn(cfg),
                          qpsk_rx_stream.init_state(cfg, args.device),
                          blocks, sink=out.append, device=args.device)
    meter = runner.run()

    sym = np.concatenate(out[SKIP:])
    sym = sym[:, 0] + 1j * sym[:, 1]
    best = None
    for rot in range(4):
        cand = decide_bits(sym * np.exp(1j * np.pi / 2 * rot))
        for lag in range(-24, 25):
            s0 = 2 * (SKIP * cfg.syms_per_block + lag)
            if s0 < 0:
                continue
            ref = bits[s0:]
            m = min(len(cand), len(ref))
            errs = int(np.sum(cand[:m] != ref[:m]))
            if best is None or errs < best[0]:
                best = (errs, m)
    errs, m = best
    print(f"{n_blocks} blocks ({meter.report()['samples']:,} samples), "
          f"frequency step at midpoint")
    print(f"BER after acquisition: {errs}/{m} = {errs / m:.2e}")
    return errs, m


if __name__ == "__main__":
    main()
