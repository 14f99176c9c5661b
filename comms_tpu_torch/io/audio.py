"""Audio sink: WAV file writer (and a live device where one exists).

This package's copy of :mod:`comms_tpu.io.audio`, in functional parity
with the reference's ``src/io/audio.rs:10-53`` (``AudioNode``: a sink fed
per-block sample buffers with a channel count and a sample rate).  Audio
lands in a WAV file by default; where ``sounddevice`` is installed a
live sink with the same ``write(block)`` interface is available.

Blocks may be numpy arrays or tensors (on any device); they are scaled
and rounded in float64 as in the JAX package, so the WAV bytes of the
same blocks are the same.
"""

from __future__ import annotations

import wave

import numpy as np
import torch

__all__ = ["WavSink", "open_sink"]


def _host(block, dtype) -> np.ndarray:
    if isinstance(block, torch.Tensor):
        block = block.detach().cpu().numpy()
    return np.asarray(block, dtype=dtype)


class WavSink:
    """Streaming WAV writer: float blocks in [-1, 1] -> 16-bit PCM.

    ``channels``/``sample_rate`` mirror ``AudioNode::new``
    (audio.rs:24-42).
    """

    def __init__(self, path, channels: int = 1, sample_rate: int = 44100):
        self._w = wave.open(str(path), "wb")
        self._w.setnchannels(int(channels))
        self._w.setsampwidth(2)
        self._w.setframerate(int(sample_rate))

    def write(self, block) -> None:
        x = _host(block, np.float64)
        pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
        self._w.writeframes(pcm.tobytes())

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _LiveSink:
    """A started ``sounddevice`` output stream behind ``write(block)``."""

    def __init__(self, sd, channels: int, sample_rate: int):
        self._stream = sd.OutputStream(samplerate=sample_rate,
                                       channels=channels)
        self._stream.start()

    def write(self, block) -> None:
        self._stream.write(_host(block, np.float32))

    def close(self) -> None:
        self._stream.stop()
        self._stream.close()


def open_sink(path=None, channels: int = 1, sample_rate: int = 44100):
    """WAV sink if ``path`` is given; else a live ``sounddevice`` stream
    (gated like the reference's ``audio_node`` cargo feature).  Without
    ``sounddevice`` this raises RuntimeError; an error of the device
    itself propagates as it is (the JAX package turns every error into
    the RuntimeError)."""
    if path is not None:
        return WavSink(path, channels, sample_rate)
    try:
        import sounddevice as sd
    except ImportError as e:
        raise RuntimeError(
            "no audio device available; pass a WAV path instead"
        ) from e
    return _LiveSink(sd, channels, sample_rate)
