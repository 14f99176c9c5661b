"""Audio playback pipeline: the ``play_audio`` example.

Counterpart of :mod:`comms_tpu.models.play_audio`, in parity with the
reference's ``examples/play_audio.rs`` (file-fed audio samples -> audio
sink): reads PCM samples from a file (f32 or i16) and streams them block
by block into an audio sink, a WAV file by default, the live device
where one exists (:mod:`comms_tpu_torch.io.audio`).  Host work only: no
sample goes to a device.
"""

from __future__ import annotations

import numpy as np

from comms_tpu_torch.io import audio as caudio

__all__ = ["play_file"]


def play_file(pcm_path, out_path=None, dtype="f32", channels: int = 1,
              sample_rate: int = 44100, block: int = 65536) -> int:
    """Stream a raw PCM file into an audio sink.  Returns samples
    played.  ``dtype``: 'f32' ([-1, 1] floats) or 'i16'."""
    np_dtype = np.float32 if dtype == "f32" else np.int16
    sink = caudio.open_sink(out_path, channels=channels,
                            sample_rate=sample_rate)
    total = 0
    try:
        with open(pcm_path, "rb") as f:
            while True:
                raw = f.read(block * np_dtype().itemsize)
                if not raw:
                    break
                x = np.frombuffer(raw, dtype=np_dtype)
                if np_dtype is np.int16:
                    x = x.astype(np.float32) / 32768.0
                sink.write(x)
                total += len(x)
    finally:
        sink.close()
    return total
