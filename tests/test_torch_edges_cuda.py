"""The I/O edges on a CUDA card: ``run_file`` through the native reader
against the numpy reads (bit for bit) and against the CPU run, the
capture served from ``FileReplayRadio`` through ``StreamRunner`` against
``run_file``'s blocks (bit for bit), and each example's ``main`` on the
card against its CPU run or its own check, with the launches of the
kernels it reaches.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_edges_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import socket
import threading
import wave

import numpy as np
import pytest
import torch

from comms_tpu_torch import native
from comms_tpu_torch.examples import (
    bpsk_mod,
    channelizer_demo,
    fm_band_monitor,
    fm_radio,
    fused_sharded_fm,
    multi_stream_serving,
    qpsk_mod,
    qpsk_receiver,
    qpsk_zmq,
    wideband_psd,
)
from comms_tpu_torch.hardware import FileReplayRadio
from comms_tpu_torch.kernels import channelizer as CK
from comms_tpu_torch.kernels import fm_chain as K
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.kernels import recurrence as R
from comms_tpu_torch.models import fm_receiver as fm
from comms_tpu_torch.runtime import StreamRunner

Q = fm.FUSED_BLOCK_QUANTUM
# the fused kernel against the tensor path (chip_smoke.TOL_PATHS, the
# JAX package's bound between its paths), and the tensor path on the
# card against the CPU (chip_smoke.TOL_DENSE)
TOL_PATHS = 1e-3
TOL_DENSE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _capture(n, seed=0):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 + 0.02 * rng.normal(size=n))
    z = np.exp(1j * ph)
    return np.stack([np.clip(np.round(z.real * 100 + 127.5), 0, 255),
                     np.clip(np.round(z.imag * 100 + 127.5), 0, 255)],
                    axis=-1).astype(np.uint8)


def _numpy_reads(monkeypatch):
    def unavailable(*args, **kwargs):
        raise RuntimeError("native reader made unavailable (test)")
    monkeypatch.setattr(native, "NativeBlockReader", unavailable)


def _frames(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_run_file_native_on_the_card(cuda, fused, tmp_path, monkeypatch):
    p = tmp_path / "cap.iq"
    _capture(3 * Q + 3777).tofile(p)
    cfg = fm.FmReceiverConfig(block=Q)
    assert native.native_available()
    K.launches = 0
    got = fm.run_file(p, cfg, fused=fused, device=cuda)
    assert K.launches == (3 if fused else 0)
    cpu = fm.run_file(p, cfg, device="cpu")
    _numpy_reads(monkeypatch)
    numpy_reads = fm.run_file(p, cfg, fused=fused, device=cuda)
    assert np.array_equal(got, numpy_reads)
    assert got.shape == cpu.shape
    assert np.max(np.abs(got - cpu)) < (TOL_PATHS if fused else TOL_DENSE)


@pytest.mark.cuda
def test_radio_served_audio_equals_run_file(cuda, tmp_path):
    p = tmp_path / "cap.iq"
    block = 2 * Q
    _capture(3 * block + 500, seed=1).tofile(p)
    cfg = fm.FmReceiverConfig(block=block)
    want = fm.run_file(p, cfg, device=cuda)
    radio = FileReplayRadio(p, "u8", loop_forever=False)

    def blocks():
        while (x := radio.recv_samples(block)).shape[0] == block:
            yield np.ascontiguousarray(x[:, 0]), np.ascontiguousarray(x[:, 1])
    fblock = fm.make_fused_block_fn(cfg)
    out = []
    K.launches = 0
    StreamRunner(lambda s, x: fblock(s, *x), fm.fused_init_state(cuda),
                 blocks(), sink=out.append,
                 samples_of=lambda x: x[0].shape[0], depth=4,
                 device=cuda).run()
    assert K.launches == 3
    assert np.array_equal(np.concatenate(out), want[:3 * (block // 25)])


@pytest.mark.cuda
def test_fm_radio_on_the_card(cuda, tmp_path):
    cap = tmp_path / "cap.u8"
    _capture(2 * 262144 + 77, seed=2).tofile(cap)
    n = fm_radio.main([str(cap), str(tmp_path / "card.wav")])
    fm_radio.main([str(cap), str(tmp_path / "cpu.wav"), "--device", "cpu"])
    got, want = _frames(tmp_path / "card.wav"), _frames(tmp_path / "cpu.wav")
    assert got.shape == want.shape == (n,)
    assert np.max(np.abs(got.astype(int) - want)) <= 1


@pytest.mark.cuda
def test_multi_stream_serving_on_the_card(cuda, tmp_path):
    block = 16 * Q
    caps = []
    for s in range(2):
        caps.append(str(tmp_path / f"cap{s}.u8"))
        _capture(2 * block, seed=3 + s).tofile(caps[-1])
    K.launches = 0
    meter = multi_stream_serving.main(caps)
    assert meter.blocks == 2 and K.launches == 4
    per = block // 25
    for c in caps:
        a = fm.run_file(c, fm.FmReceiverConfig(block=block), device=cuda)
        want = np.concatenate([np.clip(np.round(
            (a[b * per:(b + 1) * per] / np.max(np.abs(
                a[b * per:(b + 1) * per]))).astype(np.float64) * 32767),
            -32768, 32767) for b in range(2)])
        assert np.array_equal(_frames(c + ".wav"), want)


@pytest.mark.cuda
def test_qpsk_receiver_on_the_card(cuda):
    R.launches["costas_loop"] = 0
    errs, m = qpsk_receiver.main(["12"])
    assert errs == 0 and m > 0
    assert R.launches["costas_loop"] == 12


@pytest.mark.cuda
def test_channelizer_and_band_monitor_on_the_card(cuda, tmp_path,
                                                  monkeypatch):
    CK.launches = 0
    tones, found = channelizer_demo.main([])
    assert found == tones and CK.launches == 1
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(16 * 16384, 2)).astype(np.float32)
    raw.tofile(tmp_path / "wide.f32")
    monkeypatch.chdir(tmp_path)
    CK.launches = 0
    card = fm_band_monitor.main([str(tmp_path / "wide.f32"), "16"])
    assert CK.launches == 1
    cpu = fm_band_monitor.main([str(tmp_path / "wide.f32"), "16",
                                "--device", "cpu"])
    # the kernels against the tensor path (chip_smoke.TOL_BM, relative)
    assert np.max(np.abs(card - cpu)) <= 2e-4 * np.max(np.abs(cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [bpsk_mod, qpsk_mod])
def test_transmit_examples_on_the_card(cuda, mod, tmp_path):
    mod.main(["3", str(tmp_path / "card.bin")])
    mod.main(["3", str(tmp_path / "cpu.bin"), "--device", "cpu"])
    a = np.fromfile(tmp_path / "card.bin", "<i2").astype(np.int64)
    b = np.fromfile(tmp_path / "cpu.bin", "<i2").astype(np.int64)
    diff = np.abs(a - b).reshape(-1, 2).max(axis=1)
    assert a.shape == b.shape and diff.max() <= 1
    assert np.mean(diff > 0) < 0.01


@pytest.mark.cuda
def test_qpsk_zmq_on_the_card(cuda):
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        ep = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    rx = {}
    t = threading.Thread(target=lambda: rx.update(
        blocks=qpsk_zmq.main(["recv", ep, "4"])))
    t.start()
    sent = qpsk_zmq.main(["send", ep, "4"])
    t.join(timeout=60)
    assert not t.is_alive()
    assert sum(len(b) for b in rx["blocks"]) == sent


@pytest.mark.cuda
def test_sharded_examples_on_the_card(cuda):
    assert wideband_psd.main(["14"]) == sorted(
        int(round(f * (1 << 14))) for f in wideband_psd.CARRIERS)
    K.launches = HR.launches = 0
    assert fused_sharded_fm.main(["4"]) is True
    assert K.launches == 8 and HR.launches >= 1
