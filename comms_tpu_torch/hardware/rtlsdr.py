"""RTL-SDR device binding (optional, like the reference's ``rtlsdr_node``
cargo feature).

This package's copy of :mod:`comms_tpu.hardware.rtlsdr`, in parity with
the reference's ``src/hardware/rtlsdr_radio.rs:11-53``:
``init_radio(freq, sample_rate, gain)``, ``set_agc``, and a blocking
``recv_samples`` returning interleaved u8 IQ.  It needs the ``pyrtlsdr``
package and a dongle; without the package ``HAVE_RTLSDR`` is False and
:class:`comms_tpu_torch.hardware.radio.FileReplayRadio` stands in.  Only
a missing package is taken for "not installed": any other error of the
import propagates (the JAX package takes every error for it).
"""

from __future__ import annotations

import numpy as np

__all__ = ["RtlSdrRadio", "HAVE_RTLSDR"]

try:
    from rtlsdr import RtlSdr as _RtlSdr  # type: ignore

    HAVE_RTLSDR = True
except ImportError:
    _RtlSdr = None
    HAVE_RTLSDR = False


class RtlSdrRadio:
    """RadioRx over a physical RTL-SDR dongle."""

    def __init__(self, index: int = 0):
        if not HAVE_RTLSDR:
            raise RuntimeError(
                "pyrtlsdr not available; use FileReplayRadio with a "
                "recorded capture")
        self._sdr = _RtlSdr(device_index=index)

    def init_radio(self, freq_hz: int, sample_rate: int, gain) -> None:
        """rtlsdr_radio.rs:17-28."""
        self._sdr.center_freq = int(freq_hz)
        self._sdr.sample_rate = int(sample_rate)
        self._sdr.gain = gain

    def set_agc(self, enabled: bool) -> None:
        """rtlsdr_radio.rs:31-34."""
        self._sdr.set_agc_mode(bool(enabled))

    def recv_samples(self, num_samples: int, input_idx: int = 0):
        """Blocking read of interleaved u8 IQ [n, 2]
        (rtlsdr_radio.rs:41-53)."""
        raw = self._sdr.read_bytes(num_samples * 2)
        return np.frombuffer(bytes(raw), dtype=np.uint8).reshape(-1, 2)

    def close(self) -> None:
        self._sdr.close()
