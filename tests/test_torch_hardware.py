"""comms_tpu_torch.hardware against comms_tpu.hardware: the file-replay
radio on u8 and i16 captures (wrapping, end of file without looping, an
empty capture), the file-sink radio's bytes, the rtl-sdr binding against
a mocked ``rtlsdr`` module (as tests/test_rtlsdr_mock.py), its import
gate, and the radio protocols."""

import importlib
import sys
import types

import numpy as np
import pytest
import torch

from comms_tpu.hardware import radio as jradio
from comms_tpu_torch.hardware import radio as tradio
from comms_tpu_torch.hardware import rtlsdr as trtl


@pytest.mark.parametrize("fmt", ["u8", "i16"])
@pytest.mark.parametrize("loop", [True, False])
def test_file_replay_matches_jax(tmp_path, fmt, loop):
    rng = np.random.default_rng(9)
    if fmt == "u8":
        data = rng.integers(0, 256, size=2 * 37, dtype=np.uint8)
    else:
        data = rng.integers(-32768, 32768, size=2 * 37).astype(np.int16)
    p = tmp_path / "cap.bin"
    data.tofile(p)
    j = jradio.FileReplayRadio(p, fmt=fmt, loop_forever=loop)
    t = tradio.FileReplayRadio(p, fmt=fmt, loop_forever=loop)
    # reads that end mid-file, run past the end (wrap or EOF), and
    # read again after it
    for n in (10, 20, 15, 50, 3, 0, 7):
        want = j.recv_samples(n)
        got = t.recv_samples(n)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    if not loop:
        assert t.recv_samples(5).shape[0] == 0


def test_file_replay_wrap_point(tmp_path):
    # tests/test_aux.py:103-117 on the port
    p = tmp_path / "cap.bin"
    np.arange(20, dtype=np.uint8).tofile(p)
    r = tradio.FileReplayRadio(p, fmt="u8", loop_forever=True)
    a = r.recv_samples(6)
    assert a.shape == (6, 2) and a[0, 0] == 0
    b = r.recv_samples(6)           # 8 remaining + 4 from the start
    assert b[4, 0] == 0 and b[4, 1] == 1


@pytest.mark.parametrize("fmt", ["u8", "i16"])
def test_file_replay_empty_and_bad_format(tmp_path, fmt):
    p = tmp_path / "empty.bin"
    p.write_bytes(b"")
    with pytest.raises(ValueError, match="empty capture"):
        tradio.FileReplayRadio(p, fmt=fmt)
    with pytest.raises(ValueError, match="empty capture"):
        jradio.FileReplayRadio(p, fmt=fmt)
    p.write_bytes(b"\0\0")
    with pytest.raises(ValueError, match="bad fmt"):
        tradio.FileReplayRadio(p, fmt=fmt + "x")


@pytest.mark.parametrize("scale", [1.0, 8192.0])
def test_file_sink_bytes_equal_jax(tmp_path, scale):
    rng = np.random.default_rng(4)
    blocks = [(rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64) * np.float32(3.0) for n in (100, 1, 333)]
    jp, tp = tmp_path / "jax.iq", tmp_path / "port.iq"
    js, ts = jradio.FileSinkRadio(jp, scale), tradio.FileSinkRadio(tp, scale)
    for b in blocks:
        js.send_samples(b)
        ts.send_samples(b)
    js.close()
    ts.close()
    assert tp.read_bytes() == jp.read_bytes()


def test_radio_protocols(tmp_path):
    p = tmp_path / "cap.bin"
    np.arange(8, dtype=np.uint8).tofile(p)
    rx = tradio.FileReplayRadio(p)
    tx = tradio.FileSinkRadio(tmp_path / "out.iq")
    assert isinstance(rx, tradio.RadioRx)
    assert isinstance(tx, tradio.RadioTx)
    assert not isinstance(rx, tradio.RadioTx)
    assert not isinstance(tx, tradio.RadioRx)
    tx.close()


# ---- rtl-sdr against a mocked pyrtlsdr (tests/test_rtlsdr_mock.py)

class _FakeSdr:
    def __init__(self, device_index=0):
        self.device_index = device_index
        self.center_freq = None
        self.sample_rate = None
        self.gain = None
        self.agc = None
        self.closed = False

    def set_agc_mode(self, enabled):
        self.agc = enabled

    def read_bytes(self, n):
        # a deterministic interleaved IQ ramp, like a dongle's read
        return bytes(bytearray(i % 256 for i in range(n)))

    def close(self):
        self.closed = True


@pytest.fixture
def rtl_with(monkeypatch):
    """Reload the port's rtlsdr module over a given ``rtlsdr`` module (or
    None: not installed); the real gating is restored afterwards."""
    def load(mod):
        monkeypatch.setitem(sys.modules, "rtlsdr", mod)
        return importlib.reload(trtl)
    yield load
    monkeypatch.undo()
    importlib.reload(trtl)


def _fake_module():
    fake = types.ModuleType("rtlsdr")
    fake.RtlSdr = _FakeSdr
    return fake


def test_rtlsdr_radio_mocked_roundtrip(rtl_with):
    rtl = rtl_with(_fake_module())
    assert rtl.HAVE_RTLSDR
    radio = rtl.RtlSdrRadio(index=3)
    assert radio._sdr.device_index == 3
    radio.init_radio(88_700_000, 1_140_000, "auto")    # rtlsdr_radio.rs:17-28
    assert (radio._sdr.center_freq, radio._sdr.sample_rate,
            radio._sdr.gain) == (88_700_000, 1_140_000, "auto")
    radio.set_agc(True)
    assert radio._sdr.agc is True
    iq = radio.recv_samples(1024)
    assert iq.shape == (1024, 2) and iq.dtype == np.uint8
    assert iq[0, 0] == 0 and iq[0, 1] == 1 and iq[1, 0] == 2
    assert isinstance(radio, tradio.RadioRx)
    radio.close()
    assert radio._sdr.closed


def test_rtlsdr_missing_package(rtl_with):
    rtl = rtl_with(None)            # ``import rtlsdr`` raises ImportError
    assert not rtl.HAVE_RTLSDR
    with pytest.raises(RuntimeError, match="pyrtlsdr not available"):
        rtl.RtlSdrRadio()


def test_rtlsdr_gate_other_errors_propagate(rtl_with):
    """Only a missing package reads as "not installed": an installed
    package whose import fails otherwise (here librtlsdr failing to load)
    raises.  The JAX package's gate takes every error for a missing
    package."""
    class _Broken(types.ModuleType):
        def __getattr__(self, name):
            raise OSError("librtlsdr.so: cannot open shared object file")
    with pytest.raises(OSError, match="librtlsdr"):
        rtl_with(_Broken("rtlsdr"))


def test_rtlsdr_recv_feeds_the_fm_step(rtl_with):
    """The dongle's u8 pairs are the FM receiver's block input as they
    are."""
    from comms_tpu_torch.models import fm_receiver as tfm

    rtl = rtl_with(_fake_module())
    cfg = tfm.FmReceiverConfig(block=25 * 64)
    iq = rtl.RtlSdrRadio().recv_samples(cfg.block)
    audio, _ = tfm.make_block_fn(cfg)(tfm.init_state(cfg, "cpu"),
                                      torch.from_numpy(iq.copy()))
    assert audio.shape == (cfg.block // 25,)
    assert torch.isfinite(audio).all()
