"""The reference transmit chain in float64 (numpy, no jax), for the
port's transmit tests on the CPU and on the card."""

import numpy as np

from comms_tpu_torch.ops import taps as ttaps


def tx_oracle_f64(bits, qpsk: bool, dphase: float = 0.0,
                  phase0: float = 0.0) -> np.ndarray:
    """single_thread_{bpsk,qpsk}.rs in float64: map (2b - 1, QPSK from
    consecutive bit pairs) -> zero-stuff x4 -> RRC(32, 4, 0.25) from a
    zero state -> mixer exp(j*(phase0 + n*dphase)) -> *8192 -> truncate.
    Returns int16 pairs [N, 2]."""
    bits = np.asarray(bits, np.float64)
    h = np.real(ttaps.rrc_taps(32, 4.0, 0.25))
    if qpsk:
        sym = (2.0 * bits[0::2] - 1) + 1j * (2.0 * bits[1::2] - 1)
    else:
        sym = (2.0 * bits - 1) + 0j
    up = np.zeros(4 * len(sym), np.complex128)
    up[::4] = sym
    y = np.convolve(up, h)[:len(up)]
    if dphase:
        n = np.arange(len(y), dtype=np.float64)
        y = y * np.exp(1j * (phase0 + n * dphase))
    return np.stack([np.trunc(y.real * 8192.0), np.trunc(y.imag * 8192.0)],
                    -1).astype(np.int16)


def lsb_diff(got, want):
    """(largest i16 difference, share of samples that differ)."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float((d.reshape(len(d), -1) > 0).any(1).mean())
