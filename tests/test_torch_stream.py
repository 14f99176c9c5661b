"""comms_tpu_torch.runtime: StreamRunner gives a plain loop's outputs in
order at any depth, lends its own host buffers to the sink while fewer
than ``depth`` lent blocks are alive (driven here with a stand-in for a
completed CUDA event), and the package imports neither jax nor
comms_tpu."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.runtime import StreamRunner, ThroughputMeter, device_sync
from comms_tpu_torch.runtime.stream import BatchedStreamRunner

REPO = Path(__file__).resolve().parents[1]


def _blocks(nb, block, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(block, 2), dtype=np.uint8)
            for _ in range(nb)]


def _loop(cfg, blocks):
    blk = tfm.make_block_fn(cfg)
    st = tfm.init_state(cfg, device="cpu")
    outs = []
    for xb in blocks:
        a, st = blk(st, torch.from_numpy(xb))
        outs.append(a.numpy())
    return outs, st


@pytest.mark.parametrize("depth", [1, 4])
def test_stream_runner_equals_plain_loop(depth):
    cfg = tfm.FmReceiverConfig(block=2000)
    blocks = _blocks(6, cfg.block)
    want, st_want = _loop(cfg, blocks)
    got = []
    meter = ThroughputMeter()
    runner = StreamRunner(tfm.make_block_fn(cfg),
                          tfm.init_state(cfg, device="cpu"),
                          iter(blocks), sink=got.append, meter=meter,
                          depth=depth, device="cpu")
    runner.run()
    assert runner.blocks_done == 6 and meter.blocks == 6
    assert meter.samples == 6 * cfg.block
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for a, b in zip(runner.state, st_want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_stream_runner_source_reusing_its_buffer():
    # A source that refills one buffer per block (as a borrowed ring
    # does) still yields every block's own output.
    cfg = tfm.FmReceiverConfig(block=2000)
    blocks = _blocks(4, cfg.block, seed=1)
    want, _ = _loop(cfg, blocks)
    buf = np.empty_like(blocks[0])

    def source():
        for xb in blocks:
            buf[:] = xb
            yield buf

    got = []
    StreamRunner(tfm.make_block_fn(cfg), tfm.init_state(cfg, device="cpu"),
                 source(),
                 sink=got.append, depth=4, device="cpu").run()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_stream_runner_fused_step_with_tuple_blocks():
    cfg = tfm.FmReceiverConfig(block=tfm.FUSED_BLOCK_QUANTUM)
    blocks = _blocks(2, cfg.block, seed=2)
    fblock = tfm.make_fused_block_fn(cfg)
    got = []
    runner = StreamRunner(
        lambda s, x: fblock(s, *x), tfm.fused_init_state(device="cpu"),
        ((np.ascontiguousarray(b[:, 0]), np.ascontiguousarray(b[:, 1]))
         for b in blocks),
        sink=got.append, samples_of=lambda x: len(x[0]), depth=2,
        device="cpu")
    meter = runner.run(max_blocks=2)
    assert meter.samples == 2 * cfg.block
    want, _ = _loop(cfg, blocks)
    for g, w in zip(got, want):
        assert np.max(np.abs(g - w)) < 1e-3


def test_stream_runner_meter_covers_the_final_drain():
    # With depth 4 and 6 blocks, 4 blocks reach the sink only in the
    # final drain; the meter's seconds must include their time.
    delay = 0.02
    runner = StreamRunner(lambda s, x: (x, s), None,
                          (np.zeros(10, np.float32) for _ in range(6)),
                          sink=lambda y: time.sleep(delay), depth=4,
                          device="cpu")
    meter = runner.run()
    assert meter.blocks == 6 and meter.samples == 60
    assert meter.seconds >= 6 * delay


class _Done:
    """Stands in for a block's CUDA event once its copies have completed."""

    def synchronize(self):
        pass


def _lent(a, buf) -> bool:
    return np.shares_memory(a, buf.numpy())


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_drain_lends_while_fewer_than_depth_lent_blocks_live(depth):
    got = []
    r = StreamRunner(None, None, (), sink=got.append, depth=depth,
                     device="cpu")
    n = depth + 3
    bufs = [r._own(torch.full((8,), float(k))) for k in range(n)]
    for b in bufs:
        r._drain(b, _Done())
    # a sink that keeps every block: the first ``depth`` are lent, the
    # rest copied, whatever still holds the buffers themselves
    assert [_lent(a, b) for a, b in zip(got, bufs)] == \
        [k < depth for k in range(n)]
    for k, a in enumerate(got):
        np.testing.assert_array_equal(a, np.full(8, k, np.float32))
    assert r.blocks_lent == depth and r.blocks_drained == n
    # dropping a lent array frees its block's place
    del got[0]
    b = r._own(torch.full((8,), 9.0))
    r._drain(b, _Done())
    assert _lent(got[-1], b) and r.blocks_lent == depth + 1


def test_drain_lends_every_block_to_a_dropping_sink():
    seen = []
    r = StreamRunner(None, None, (),
                     sink=lambda y: seen.append(y[0].flags.owndata), depth=2,
                     device="cpu")
    for k in range(7):
        r._drain((r._own(torch.full((4,), float(k))),), _Done())
    assert seen == [False] * 7
    assert r.blocks_lent == r.blocks_drained == 7


def test_drain_copies_what_the_runner_did_not_make():
    got = []
    r = StreamRunner(None, None, (), sink=got.append, depth=2, device="cpu")
    mine, steps = r._own(torch.arange(4.0)), torch.arange(3.0)
    r._drain({"a": mine, "b": steps}, _Done())
    assert _lent(got[0]["a"], mine) and not _lent(got[0]["b"], steps)
    assert r.blocks_lent == 1
    # a block with none of the runner's buffers is copied and not counted
    r._drain((steps,), _Done())
    assert not _lent(got[1][0], steps) and r.blocks_lent == 1
    # a buffer is lent once: its drain forgets it
    r._drain((mine,), _Done())
    assert not _lent(got[2][0], mine) and r.blocks_lent == 1


def test_drain_counts_a_batched_round_alive_through_its_streams_views():
    B = 3
    outs = [[] for _ in range(B)]
    r = BatchedStreamRunner(lambda s, x: (x, s), [None] * B,
                            batched_source=[], sinks=[o.append for o in outs],
                            depth=1, device="cpu")
    rounds = [r._own(torch.arange(24.0).reshape(B, 2, 4) + 100 * k)
              for k in range(3)]
    r._drain(rounds[0], _Done())
    # each stream keeps a view of its row: the round stays lent
    assert all(_lent(o[0], rounds[0]) for o in outs)
    r._drain(rounds[1], _Done())
    assert not any(_lent(o[1], rounds[1]) for o in outs)
    for o in outs:
        o.clear()
    r._drain(rounds[2], _Done())
    assert all(_lent(o[0], rounds[2]) for o in outs)
    assert r.blocks_lent == 2
    for b, o in enumerate(outs):
        np.testing.assert_array_equal(o[0], rounds[2][b].numpy())


def test_device_sync_checksum():
    t = (torch.tensor([1.5, 2.0]), {"a": torch.tensor([2.0 + 1j])})
    assert device_sync(t) == 3.5


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import comms_tpu_torch\n"
        "for m in pkgutil.walk_packages(comms_tpu_torch.__path__,"
        " 'comms_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'comms_tpu' or k.startswith('comms_tpu.')"
        " or k == 'triton']\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(k for k in sys.modules"
        " if k.startswith('comms_tpu_torch'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    imported = set(res.stdout.split())
    for name in ("ops.fir", "ops.demodulation", "ops.channelizer",
                 "ops.taps", "ops.mixer", "ops.interp", "ops.fft",
                 "ops.spectrum", "ops.random", "ops.modulation",
                 "ops.pulse", "ops.prns", "ops.txshape",
                 "models.bpsk_tx", "models.qpsk_tx", "io.raw_iq",
                 "errors", "io.cbor", "io.net", "models.qpsk_stream",
                 "ops.agc", "kernels.recurrence",
                 "ops.resample", "runtime.block", "runtime.pipeline",
                 "runtime.graph", "runtime.checkpoint", "runtime.boundary",
                 "runtime.metrics", "runtime.stream", "runtime._tree",
                 "util.snr",
                 "kernels._build", "kernels.fm_chain", "kernels.channelizer",
                 "kernels.decim_fir", "kernels.band_monitor", "kernels.fir",
                 "kernels.qpsk_sym", "kernels.panel_reduce", "kernels.fft",
                 "kernels.fft_big",
                 "models.fm_receiver", "models.channelizer",
                 "models.fm_band_monitor", "models.qpsk_rx",
                 "models.qpsk_rx_stream", "runtime.metrics",
                 "runtime.stream", "kernels.halo_ring", "parallel.sharding",
                 "parallel.dfft", "parallel.wideband",
                 "parallel.fused_wideband", "parallel.wideband2d",
                 "parallel.qpsk_rx_sharded", "parallel.scaling",
                 "parallel.dryrun", "parallel.multihost",
                 "native", "native.loader", "io.audio",
                 "models.play_audio", "hardware", "hardware.radio",
                 "hardware.rtlsdr", "examples", "examples._cli",
                 "examples.fm_radio", "examples.play_audio",
                 "examples.multi_stream_serving", "examples.qpsk_receiver",
                 "examples.fm_band_monitor", "examples.channelizer_demo",
                 "examples.bpsk_mod", "examples.qpsk_mod",
                 "examples.qpsk_zmq", "examples.wideband_psd",
                 "examples.fused_sharded_fm"):
        assert "comms_tpu_torch." + name in imported
