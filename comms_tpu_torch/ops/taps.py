"""Filter tap generators (host-side, float64 numpy).

Counterpart of :mod:`comms_tpu.ops.taps`: rectangular, Gaussian,
raised-cosine and root-raised-cosine pulses (``rect_taps``,
``gaussian_taps``, ``sinc``, ``rc_taps``, ``rrc_taps``) and Mengali's
q(t) taps of the NDA timing estimator (``qfilt_taps``).
Taps are parameters, not streaming data: they are computed on the host
in float64, exactly as the JAX package computes them, and cast by the op
that consumes them, so both packages hold bit-equal arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["InvalidRolloffError", "rect_taps", "gaussian_taps", "sinc",
           "rc_taps", "rrc_taps", "qfilt_taps"]

# Singularity checks of the tap formulas: parameters that should land on
# a singular point but miss it by a few ulps still take the finite limit.
_SINGULARITY_ATOL = 1e-9


class InvalidRolloffError(ValueError):
    """Rolloff/shape parameter outside [0, 1]."""


def _sym_times(n_taps: int, sam_per_sym: float) -> np.ndarray:
    """Symmetric time grid t_i = (i - (n-1)/2) / fs."""
    i = np.arange(n_taps, dtype=np.float64)
    return (i - (n_taps - 1) / 2.0) / float(sam_per_sym)


def rect_taps(n_taps: int, dtype=np.complex128) -> np.ndarray:
    """Rectangular pulse-shaping taps: ``n_taps`` ones."""
    return np.ones(n_taps, dtype=dtype)


def gaussian_taps(n_taps: int, sam_per_sym: float, alpha: float,
                  dtype=np.complex128) -> np.ndarray:
    """Gaussian impulse response: sqrt(a/pi) * exp(-a t^2) on the
    symmetric grid."""
    t = _sym_times(n_taps, sam_per_sym)
    taps = np.sqrt(alpha / np.pi) * np.exp(-alpha * t ** 2)
    return taps.astype(dtype)


def sinc(x):
    """Normalized sinc: sin(pi x)/(pi x), sinc(0) = 1."""
    return np.sinc(x)


def rc_taps(n_taps: int, sam_per_sym: float, beta: float,
            dtype=np.complex128) -> np.ndarray:
    """Raised-cosine taps with Tsym = 1.

    h(t) = sinc(t) * cos(pi b t) / (1 - (2 b t)^2), with the
    L'Hopital limit (pi/4) * sinc(1/(2b)) at |t| = 1/(2b).
    """
    if beta < 0.0 or beta > 1.0:
        raise InvalidRolloffError(f"beta={beta} not in [0, 1]")
    t = _sym_times(n_taps, sam_per_sym)
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = (np.sinc(t) * np.cos(np.pi * beta * t)
                / (1.0 - (2.0 * beta * t) ** 2))
    if beta != 0.0:
        t_sing = 1.0 / (2.0 * beta)
        limit = (np.pi / 4.0) * np.sinc(1.0 / (2.0 * beta))
        singular = np.isclose(np.abs(t), t_sing, rtol=0.0,
                              atol=_SINGULARITY_ATOL)
        vals = np.where(singular, limit, vals)
    return vals.astype(dtype)


def rrc_taps(n_taps: int, sam_per_sym: float, beta: float,
             dtype=np.complex128) -> np.ndarray:
    """Root-raised-cosine taps with Tsym = 1.

    h(t) = [sin(pi t (1-b)) + 4 b t cos(pi t (1+b))]
           / [pi t (1 - (4 b t)^2)]
    with limits h(0) = 1 + b(4/pi - 1) and the standard closed form at
    |t| = 1/(4b).
    """
    if beta < 0.0 or beta > 1.0:
        raise InvalidRolloffError(f"beta={beta} not in [0, 1]")
    t = _sym_times(n_taps, sam_per_sym)
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = (
            np.sin(np.pi * t * (1.0 - beta))
            + 4.0 * beta * t * np.cos(np.pi * t * (1.0 + beta))
        ) / (np.pi * t * (1.0 - (4.0 * beta * t) ** 2))
    f_zero = 1.0 + beta * (4.0 / np.pi - 1.0)
    vals = np.where(
        np.isclose(t, 0.0, rtol=0.0, atol=_SINGULARITY_ATOL), f_zero, vals)
    if beta != 0.0:
        t_sing = 1.0 / (4.0 * beta)
        f_sing = (beta / np.sqrt(2.0)) * (
            (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
            + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
        singular = np.isclose(np.abs(t), t_sing, rtol=0.0,
                              atol=_SINGULARITY_ATOL)
        vals = np.where(singular, f_sing, vals)
    return vals.astype(dtype)


def qfilt_taps(n_taps: int, alpha: float, sam_per_sym: int) -> np.ndarray:
    """Mengali's q(t) taps for feedforward NDA ML timing estimation.

    Forces an odd tap count (even counts are incremented).
    q(t) = a cos(pi a t) / (pi (1 - (2 a t)^2)) with the L'Hopital limit
    sin(pi a t)/(8 t) at |2 a t| = 1.  Returns float64.
    """
    if alpha < 0.0 or alpha > 1.0:
        raise InvalidRolloffError(f"alpha={alpha} not in [0, 1]")
    n = int(n_taps)
    if n % 2 == 0:
        n += 1
    d = n // 2
    tt = (np.arange(n, dtype=np.float64) - d) / float(sam_per_sym)
    two_alpha_tt = 2.0 * alpha * tt
    with np.errstate(divide="ignore", invalid="ignore"):
        general = (alpha * np.cos(np.pi * alpha * tt)) / (
            np.pi * (1.0 - two_alpha_tt ** 2))
        lhopital = np.sin(np.pi * alpha * tt) / (8.0 * tt)
    singular = np.isclose(np.abs(two_alpha_tt), 1.0, rtol=0.0,
                          atol=_SINGULARITY_ATOL)
    return np.where(singular, lhopital, general)
