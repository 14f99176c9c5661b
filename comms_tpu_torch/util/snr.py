"""Signal-parity metrics: SNR / EVM between two sample streams.

This package's copy of :mod:`comms_tpu.util.snr` (jax-free numpy).  The
BASELINE requires chain outputs to match the reference "within
its SNR bound on file-driven I/O".  This module is the measuring
instrument: align two streams (integer lag + optimal complex gain)
and report the residual as SNR in dB.
"""

from __future__ import annotations

import numpy as np

__all__ = ["align", "snr_db", "evm_percent", "compare_iq_files"]


def align(a, b, max_lag: int = 256):
    """Find the integer lag of ``b`` relative to ``a`` maximizing
    cross-correlation; returns the overlapping (a', b') slices."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    n = min(len(a), len(b))
    best = (0, -np.inf)
    for lag in range(-max_lag, max_lag + 1):
        if lag >= 0:
            aa, bb = a[lag: n], b[: n - lag]
        else:
            aa, bb = a[: n + lag], b[-lag: n]
        if len(aa) < 16:
            continue
        c = np.abs(np.vdot(aa, bb))
        denom = np.linalg.norm(aa) * np.linalg.norm(bb)
        if denom > 0 and c / denom > best[1]:
            best = (lag, c / denom)
    lag = best[0]
    if lag >= 0:
        return a[lag: n], b[: n - lag]
    return a[: n + lag], b[-lag: n]


def snr_db(reference, test, max_lag: int = 256) -> float:
    """SNR of ``test`` vs ``reference`` after alignment and optimal
    complex-gain matching: 10 log10(|ref|^2 / |ref - g*test|^2)."""
    a, b = align(reference, test, max_lag)
    a = a.astype(np.complex128)
    b = b.astype(np.complex128)
    denom = np.vdot(b, b)
    g = np.vdot(b, a) / denom if abs(denom) > 0 else 0.0
    err = a - g * b
    p_sig = float(np.real(np.vdot(a, a)))
    p_err = float(np.real(np.vdot(err, err)))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * np.log10(p_sig / p_err)


def evm_percent(reference, test, max_lag: int = 256) -> float:
    """Error-vector magnitude (rms, percent of reference rms)."""
    s = snr_db(reference, test, max_lag)
    if s == float("inf"):
        return 0.0
    return 100.0 * 10.0 ** (-s / 20.0)


def compare_iq_files(path_a, path_b, max_lag: int = 4096) -> dict:
    """SNR/EVM between two i16-interleaved IQ files (raw_iq.rs
    layout)."""
    from comms_tpu_torch.io import raw_iq

    a = raw_iq.read_iq(path_a)
    b = raw_iq.read_iq(path_b)
    s = snr_db(a, b, max_lag)
    return {"snr_db": round(s, 2), "evm_percent":
            round(evm_percent(a, b, max_lag), 4),
            "samples": int(min(len(a), len(b)))}
