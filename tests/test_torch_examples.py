"""The eleven examples on the port, each ``main`` on the CPU (``--device
cpu``) at a small size: the fm_radio and play_audio WAVs against the JAX
examples' WAVs on the same input (run through ``runpy`` with ``sys.argv``
set; within 1 LSB), the bpsk_mod/qpsk_mod output files byte for byte
against the JAX examples' at their defaults (qpsk_mod with its mixer on
within 1 LSB), zero bit errors from qpsk_receiver, and each other
example's own check."""

import runpy
import socket
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from comms_tpu_torch.examples import (
    bpsk_mod,
    channelizer_demo,
    fm_band_monitor,
    fm_radio,
    fused_sharded_fm,
    multi_stream_serving,
    play_audio,
    qpsk_mod,
    qpsk_receiver,
    qpsk_zmq,
    wideband_psd,
)
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.models import fm_receiver as tfm

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
NAMES = ("bpsk_mod", "channelizer_demo", "fm_band_monitor", "fm_radio",
         "fused_sharded_fm", "multi_stream_serving", "play_audio",
         "qpsk_mod", "qpsk_receiver", "qpsk_zmq", "wideband_psd")


def _run_jax_example(name, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", [name + ".py", *map(str, args)])
    runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                   run_name="__main__")


def _frames(path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _fm_capture(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 + 0.02 * rng.normal(size=n))
    z = np.exp(1j * ph)
    return np.stack([np.clip(np.round(z.real * 100 + 127.5), 0, 255),
                     np.clip(np.round(z.imag * 100 + 127.5), 0, 255)],
                    axis=-1).astype(np.uint8)


def test_every_example_is_a_module_with_main_and_device():
    import comms_tpu_torch.examples as ex

    found = sorted(p.stem for p in Path(ex.__file__).parent.glob("*.py")
                   if not p.stem.startswith("_"))
    assert tuple(found) == NAMES
    assert sorted(p.stem for p in (REPO / "examples").glob("*.py")) == found
    for name in NAMES:
        mod = sys.modules[f"comms_tpu_torch.examples.{name}"]
        assert callable(mod.main)
        device = mod.parser().get_default("device")
        # play_audio runs on the host only and takes no --device
        assert device == (None if name == "play_audio" else "cuda"), name


def test_run_as_main_module(monkeypatch, capsys):
    """``python -m comms_tpu_torch.examples.<name>`` reaches ``main``:
    each prints its usage under --help."""
    for name in NAMES:
        monkeypatch.setattr(sys, "argv", [name, "--help"])
        # run_module executes a fresh copy, as ``python -m`` does
        monkeypatch.delitem(sys.modules, f"comms_tpu_torch.examples.{name}")
        with pytest.raises(SystemExit) as e:
            runpy.run_module(f"comms_tpu_torch.examples.{name}",
                             run_name="__main__")
        assert e.value.code == 0
        assert "usage:" in capsys.readouterr().out


def test_fm_radio_wav_matches_jax(tmp_path, monkeypatch):
    cap = tmp_path / "cap.u8"
    _fm_capture(2 * 262144 + 3777, seed=1).tofile(cap)
    n = fm_radio.main([str(cap), str(tmp_path / "port.wav"), *CPU])
    _run_jax_example("fm_radio", monkeypatch, cap, tmp_path / "jax.wav")
    got, want = _frames(tmp_path / "port.wav"), _frames(tmp_path / "jax.wav")
    assert got.shape == want.shape == (n,)
    assert np.max(np.abs(got.astype(int) - want)) <= 1


def test_fm_radio_short_capture_exits(tmp_path):
    cap = tmp_path / "short.u8"
    cap.write_bytes(b"")
    with pytest.raises(SystemExit):
        fm_radio.main([str(cap), str(tmp_path / "x.wav"), *CPU])


def test_play_audio_wav_matches_jax(tmp_path, monkeypatch):
    pcm = np.random.default_rng(2).uniform(-1, 1, 70000).astype(np.float32)
    src = tmp_path / "in.f32"
    pcm.tofile(src)
    n = play_audio.main([str(src), str(tmp_path / "port.wav"), "22050"])
    _run_jax_example("play_audio", monkeypatch, src, tmp_path / "jax.wav",
                     22050)
    got, want = _frames(tmp_path / "port.wav"), _frames(tmp_path / "jax.wav")
    assert n == 70000 and got.shape == want.shape == (n,)
    assert np.max(np.abs(got.astype(int) - want)) <= 1
    with wave.open(str(tmp_path / "port.wav")) as w:
        assert w.getframerate() == 22050


@pytest.mark.parametrize("name", ["bpsk_mod", "qpsk_mod"])
def test_transmit_files_equal_jax(name, tmp_path, monkeypatch):
    """At the examples' defaults the files are equal byte for byte."""
    mod = {"bpsk_mod": bpsk_mod, "qpsk_mod": qpsk_mod}[name]
    port, jax_out = tmp_path / "port.bin", tmp_path / "jax.bin"
    n = mod.main(["2", str(port), *CPU])
    _run_jax_example(name, monkeypatch, 2, jax_out)
    assert n > 0 and port.stat().st_size == 4 * n
    assert port.read_bytes() == jax_out.read_bytes()


def test_qpsk_mod_mixed_within_one_lsb_of_jax(tmp_path, monkeypatch):
    """With the mixer on (dphase) the samples' float32 products may round
    to the other side of an integer: within 1 LSB, under 1% of samples
    differing, the bound tests/test_torch_tx.py holds run_to_file to
    (the JAX tests' bound between the JAX package's own paths)."""
    port, jax_out = tmp_path / "port.bin", tmp_path / "jax.bin"
    n = qpsk_mod.main(["4", str(port), "0.01", *CPU])
    _run_jax_example("qpsk_mod", monkeypatch, 4, jax_out, 0.01)
    got = np.fromfile(port, "<i2").astype(np.int64)
    want = np.fromfile(jax_out, "<i2").astype(np.int64)
    assert got.shape == want.shape == (2 * n,)
    diff = np.abs(got - want).reshape(-1, 2).max(axis=1)
    assert diff.max() <= 1 and np.mean(diff > 0) < 0.01


def test_qpsk_receiver_zero_bit_errors():
    errs, m = qpsk_receiver.main(["8", *CPU])
    assert m >= 2 * 5 * 2048 - 2 * 24
    assert errs == 0


@pytest.mark.parametrize("K", [16, 64])
def test_channelizer_demo_finds_its_tones(K):
    tones, detected = channelizer_demo.main([str(K), *CPU])
    assert detected == tones == sorted([3, K // 2, K - 5])


def test_fm_band_monitor_writes_each_channel(tmp_path, monkeypatch):
    K = 8
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(K * 4 * 1000 + 13, 2)).astype(np.float32)
    cap = tmp_path / "wide.f32"
    raw.tofile(cap)
    monkeypatch.chdir(tmp_path)
    audio = fm_band_monitor.main([str(cap), str(K), *CPU])
    cfg = tbm.BandMonitorConfig(num_channels=K, block=K * 4 * 1000)
    want, _ = tbm.make_block_fn(cfg)(tbm.init_state(cfg, "cpu"),
                                     torch.from_numpy(raw[: cfg.block]))
    assert np.array_equal(audio, want.numpy())
    for k in range(K):
        frames = _frames(tmp_path / f"fm_ch{k}.wav")
        a = audio[k]
        scaled = (a / (np.max(np.abs(a)) or 1.0)).astype(np.float64)
        assert np.array_equal(frames, np.clip(
            np.round(scaled * 32767), -32768, 32767))


def test_multi_stream_serving_equals_separate_runs(tmp_path):
    block = 25 * 4096                 # the example's block off the card
    caps = []
    for s, nblk in ((0, 2), (1, 3)):
        p = tmp_path / f"cap{s}.u8"
        _fm_capture(nblk * block + 100, seed=10 + s).tofile(p)
        caps.append(p)
    meter = multi_stream_serving.main([*map(str, caps), *CPU])
    assert meter.blocks == 2          # the rounds stop at the shorter one
    for p in caps:
        audio = tfm.run_file(p, tfm.FmReceiverConfig(block=block),
                             device="cpu")
        per = block // 25
        want = []
        for b in range(2):
            a = audio[b * per:(b + 1) * per]
            scaled = (a / (np.max(np.abs(a)) or 1.0)).astype(np.float64)
            want.append(np.clip(np.round(scaled * 32767), -32768, 32767))
        assert np.array_equal(_frames(str(p) + ".wav"), np.concatenate(want))


def test_qpsk_zmq_send_and_recv(tmp_path):
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ep = f"tcp://127.0.0.1:{port}"
    got = {}

    def recv():
        got["blocks"] = qpsk_zmq.main(["recv", ep, "3"])
    t = threading.Thread(target=recv)
    t.start()
    sent = qpsk_zmq.main(["send", ep, "3", *CPU])
    t.join(timeout=60)
    assert not t.is_alive()
    blocks = got["blocks"]
    assert len(blocks) == 3 and sum(len(b) for b in blocks) == sent


def test_wideband_psd_recovers_the_carriers():
    top = wideband_psd.main(["12", *CPU])
    assert top == sorted(int(round(f * 4096)) for f in wideband_psd.CARRIERS)


@pytest.mark.parametrize("shards", [2, 8])
def test_fused_sharded_fm_is_bit_exact(shards):
    assert fused_sharded_fm.main([str(shards), *CPU]) is True
