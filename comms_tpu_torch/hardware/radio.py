"""Radio source/sink protocols and the file-replay implementation.

This package's copy of :mod:`comms_tpu.hardware.radio`, in parity with
the reference's ``src/hardware/radio.rs:6-80``: the ``RadioTx`` /
``RadioRx`` traits (``send_samples`` / ``recv_samples`` with an antenna
or stream index).  Hardware SDRs are replaced by recorded IQ files; the
rtl-sdr binding is an optional extra (:mod:`.rtlsdr`), gated like the
reference's ``rtlsdr_node`` cargo feature.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from comms_tpu_torch.io import raw_iq

__all__ = ["RadioRx", "RadioTx", "FileReplayRadio", "FileSinkRadio"]


@runtime_checkable
class RadioRx(Protocol):
    """recv_samples(num_samples, input_idx) -> ndarray (radio.rs:11-14)."""

    def recv_samples(self, num_samples: int, input_idx: int = 0): ...


@runtime_checkable
class RadioTx(Protocol):
    """send_samples(samples, output_idx) (radio.rs:6-9)."""

    def send_samples(self, samples, output_idx: int = 0) -> None: ...


class FileReplayRadio:
    """RadioRx over a recorded IQ capture.

    ``fmt``: 'u8' = interleaved unsigned bytes as rtl-sdr delivers them
    (rtlsdr_radio.rs:41-53; returns a [n, 2] uint8 array), or 'i16' =
    the raw_iq.rs file format (returns complex64).  ``loop_forever``
    replays from the start at EOF so that a steady stream never starves
    (instead of the reference's sleep-forever EOF); without it the last
    read returns what is left, then empty arrays.
    """

    def __init__(self, path, fmt: str = "u8", loop_forever: bool = True):
        if fmt not in ("u8", "i16"):
            raise ValueError(f"bad fmt {fmt!r}")
        self.fmt = fmt
        self.loop_forever = loop_forever
        self._data = np.fromfile(
            path, dtype=np.uint8 if fmt == "u8" else np.int16)
        self._pos = 0
        if len(self._data) == 0:
            raise ValueError(f"empty capture {path}")

    def recv_samples(self, num_samples: int, input_idx: int = 0):
        need = num_samples * 2          # interleaved re/im
        out = np.empty(need, dtype=self._data.dtype)
        got = 0
        while got < need:
            avail = len(self._data) - self._pos
            if avail == 0:
                if not self.loop_forever:
                    out = out[:got]
                    break
                self._pos = 0
                avail = len(self._data)
            take = min(avail, need - got)
            out[got: got + take] = self._data[self._pos: self._pos + take]
            self._pos += take
            got += take
        if self.fmt == "u8":
            return out.reshape(-1, 2)
        f = out.astype(np.float32).reshape(-1, 2)
        return (f[:, 0] + 1j * f[:, 1]).astype(np.complex64)


class FileSinkRadio:
    """RadioTx writing i16-interleaved IQ to a file
    (:class:`comms_tpu_torch.io.raw_iq.IQWriter`)."""

    def __init__(self, path, scale: float = 1.0):
        self._writer = raw_iq.IQWriter(path, scale=scale)

    def send_samples(self, samples, output_idx: int = 0) -> None:
        self._writer.write(samples)

    def close(self) -> None:
        self._writer.close()
