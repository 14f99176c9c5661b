"""comms_tpu_torch.io.audio and models.play_audio against the JAX
package's: WAV files byte-equal for the same blocks, ``play_file``'s f32
and i16 outputs byte-equal, and the live sink's gate (``sounddevice``
imported only when asked for; only its absence becomes the
RuntimeError)."""

import sys
import types
import wave

import numpy as np
import pytest
import torch

from comms_tpu.io import audio as jaudio
from comms_tpu.models import play_audio as jplay
from comms_tpu_torch.io import audio as taudio
from comms_tpu_torch.models import play_audio as tplay


def _blocks(seed):
    """Blocks that reach past [-1, 1] (clipped), land on .5 boundaries
    (rounded half to even) and vary in length."""
    rng = np.random.default_rng(seed)
    out = [rng.uniform(-1.2, 1.2, size=n) for n in (1000, 1, 4097)]
    out.append(np.array([0.0, 0.5 / 32767, -1.5 / 32767, 1.0, -1.0,
                         2.5 / 32767]))
    return out


@pytest.mark.parametrize("channels,rate", [(1, 45600), (2, 8000)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_wav_sink_bytes_equal_jax(tmp_path, channels, rate, as_tensor):
    blocks = [b[: (len(b) // channels) * channels] for b in _blocks(3)]
    jp, tp = tmp_path / "jax.wav", tmp_path / "port.wav"
    with jaudio.WavSink(jp, channels, rate) as sink:
        for b in blocks:
            sink.write(b.astype(np.float32))
    with taudio.WavSink(tp, channels, rate) as sink:
        for b in blocks:
            b = b.astype(np.float32)
            sink.write(torch.from_numpy(b) if as_tensor else b)
    assert tp.read_bytes() == jp.read_bytes()
    with wave.open(str(tp)) as w:
        assert (w.getnchannels(), w.getframerate()) == (channels, rate)


@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_play_file_bytes_equal_jax(tmp_path, dtype):
    rng = np.random.default_rng(5)
    n = 3 * 4096 + 123
    if dtype == "f32":
        pcm = rng.uniform(-1.1, 1.1, size=n).astype(np.float32)
    else:
        pcm = rng.integers(-32768, 32768, size=n).astype(np.int16)
    src = tmp_path / f"in.{dtype}"
    pcm.tofile(src)
    jp, tp = tmp_path / "jax.wav", tmp_path / "port.wav"
    nj = jplay.play_file(src, jp, dtype=dtype, sample_rate=22050,
                         block=4096)
    nt = tplay.play_file(src, tp, dtype=dtype, sample_rate=22050,
                         block=4096)
    assert nt == nj == n
    assert tp.read_bytes() == jp.read_bytes()


def test_open_sink_without_sounddevice_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)  # import fails
    with pytest.raises(RuntimeError, match="no audio device"):
        taudio.open_sink(None)


class _FakeStream:
    def __init__(self, samplerate, channels):
        self.args = (samplerate, channels)
        self.written = []
        self.state = "made"

    def start(self):
        self.state = "started"

    def write(self, x):
        self.written.append(x)

    def stop(self):
        self.state = "stopped"

    def close(self):
        self.state = "closed"


def test_open_sink_live_device(monkeypatch):
    fake = types.ModuleType("sounddevice")
    fake.OutputStream = _FakeStream
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    sink = taudio.open_sink(None, channels=1, sample_rate=48000)
    stream = sink._stream
    assert stream.args == (48000, 1) and stream.state == "started"
    sink.write(torch.tensor([0.5, -0.25], dtype=torch.float64))
    assert stream.written[0].dtype == np.float32
    assert np.array_equal(stream.written[0], [0.5, -0.25])
    sink.close()
    assert stream.state == "closed"


def test_open_sink_device_error_propagates(monkeypatch):
    """A broken device raises its own error; the JAX package would turn
    it into "no audio device available"."""
    class PortAudioError(Exception):
        pass

    def broken(samplerate, channels):
        raise PortAudioError("device unavailable")
    fake = types.ModuleType("sounddevice")
    fake.OutputStream = broken
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    with pytest.raises(PortAudioError):
        taudio.open_sink(None)
