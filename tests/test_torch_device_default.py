"""The port's entry points run on the card unless the caller asks for the
CPU: every function with a ``device`` argument defaults to "cuda", and on
a machine without a CUDA device a call that does not name one raises
instead of returning CPU tensors.  (The CPU tests pass device="cpu".)"""

import inspect

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import band_monitor as TBM
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.kernels import fir as TFIR
from comms_tpu_torch.kernels import fm_chain as TK
from comms_tpu_torch.models import bpsk_tx as tbt
from comms_tpu_torch.models import channelizer as tchm
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_tx as tqt
from comms_tpu_torch.models import qpsk_rx_stream as tstream
from comms_tpu_torch.models import qpsk_stream as tqstream
from comms_tpu_torch.ops import agc as tagc
from comms_tpu_torch.ops import channelizer as tchan
from comms_tpu_torch.ops import demodulation as tdem
from comms_tpu_torch.ops import fir as tfir
from comms_tpu_torch.ops import prns as tprns
from comms_tpu_torch.ops import pulse as tpulse
from comms_tpu_torch.ops import random as trand
from comms_tpu_torch.parallel import dryrun as tdry
from comms_tpu_torch.parallel import scaling as tscal
from comms_tpu_torch.parallel import sharding as tsh
from comms_tpu_torch.parallel import wideband as twb
from comms_tpu_torch.parallel import wideband2d as tw2
from comms_tpu_torch import runtime as trt
from comms_tpu_torch.ops import resample as tres
from comms_tpu_torch.runtime import StreamRunner
from comms_tpu_torch.runtime import block as tblock
from comms_tpu_torch.runtime import checkpoint as tck
from comms_tpu_torch.runtime import metrics as tmet

_FM = tfm.FmReceiverConfig(block=2000)
_BM = tbm.BandMonitorConfig(num_channels=8, block=TBM.step_samples())
_CH = tchm.ChannelizerConfig(num_channels=8, block=4096)
_WB = twb.WidebandConfig(tfm.FM_LPF_TAPS, block=8 * 400)
_BT = tbt.BpskTxConfig(syms_per_block=64)
_QT = tqt.QpskTxConfig(bits_per_block=128, dphase=0.1)
_PRN = tprns.PrnSpec.make(0xC0, 8, 16)


def _run_file(tmp_path):
    p = tmp_path / "cap.iq"
    np.zeros((2 * _FM.block, 2), np.uint8).tofile(p)
    return tfm.run_file(p, _FM)


def _tx_file(mod, cfg, fast):
    return lambda tmp_path: mod.run_to_file(tmp_path / "tx.iq", 1, cfg,
                                            fast=fast)


def _stream_runner(tmp_path):
    runner = StreamRunner(lambda s, x: (x, s), None,
                          [np.zeros(16, np.float32)], sink=lambda y: None)
    return runner.run()


def _batched_runner(tmp_path):
    runner = trt.BatchedStreamRunner(
        lambda s, x: (x, s), [None, None],
        sources=[[np.zeros(16, np.float32)]] * 2,
        sinks=[lambda y: None] * 2)
    return runner.run()


def _pipe():
    return trt.Pipeline([trt.FirDecimate.make(np.ones(8), 2), trt.FmDemod()])


def _graph():
    g = trt.Graph()
    g.add_input("x")
    g.add_node("f", trt.Fir.make(np.ones(4)), ["x"])
    g.set_outputs(["f"])
    return g


# the BlockOps whose state lives on the device (Mixer's is host words,
# the rest have none: their signatures are checked below)
_OPS = {
    "Fir": trt.Fir.make(np.ones(4)),
    "FirDecimate": trt.FirDecimate.make(np.ones(8), 2),
    "Nco": trt.Nco(0.1),
    "FmDemod": trt.FmDemod(),
    "Decimate": trt.Decimate(2, streaming=True),
    "RationalResample": trt.RationalResample.make(np.ones(6), 3, 2),
    "PulseShape": trt.PulseShape.make(np.ones(8), 4),
    "PrnSource": trt.PrnSource.make(0xC0, 1, 8, 16),
    "UniformSource": trt.UniformSource(16),
    "NormalSource": trt.NormalSource(16),
    "RandomBitSource": trt.RandomBitSource(16),
}

ENTRY_POINTS = {
    "run_file": (tfm.run_file, _run_file),
    "StreamRunner.run": (StreamRunner.__init__, _stream_runner),
    "fm_receiver.init_state": (tfm.init_state,
                               lambda _: tfm.init_state(_FM)),
    "fm_receiver.state_from_jax": (
        tfm.state_from_jax,
        lambda _: tfm.state_from_jax([np.zeros((2, 2)), np.zeros(2)])),
    "fm_receiver.fused_init_state": (tfm.fused_init_state,
                                     lambda _: tfm.fused_init_state()),
    "fm_receiver.fused_state_from_jax": (
        tfm.fused_state_from_jax,
        lambda _: tfm.fused_state_from_jax({"d": np.zeros(4)})),
    "fm_band_monitor.init_state": (tbm.init_state,
                                   lambda _: tbm.init_state(_BM)),
    "fm_band_monitor.init_state_fused": (
        tbm.init_state_fused, lambda _: tbm.init_state_fused(_BM)),
    "fm_band_monitor.state_from_jax": (
        tbm.state_from_jax, lambda _: tbm.state_from_jax([np.zeros(3)])),
    "fm_band_monitor.fused_state_from_jax": (
        tbm.fused_state_from_jax,
        lambda _: tbm.fused_state_from_jax([np.zeros(3)])),
    "channelizer.init_state": (tchm.init_state,
                               lambda _: tchm.init_state(_CH)),
    "channelizer.state_from_jax": (
        tchm.state_from_jax, lambda _: tchm.state_from_jax(np.zeros(3))),
    "qpsk_rx_stream.init_state_fast": (
        tstream.init_state_fast,
        lambda _: tstream.init_state_fast(trx.QpskRxConfig())),
    "qpsk_rx_stream.state_from_jax": (
        tstream.state_from_jax,
        lambda _: tstream.state_from_jax(
            {k: np.zeros(2) for k in ("ctx_re", "ctx_im", "omega", "theta",
                                      "lag", "shift2", "fphase", "pfine",
                                      "warm")})),
    "qpsk_rx_stream.init_state": (
        tstream.init_state,
        lambda _: tstream.init_state(tstream.QpskRxStreamConfig(block=64))),
    "qpsk_rx_stream.init_state_fused2": (
        tstream.init_state_fused2,
        lambda _: tstream.init_state_fused2(trx.QpskRxConfig())),
    "qpsk_rx_stream.stream_state_from_jax": (
        tstream.stream_state_from_jax,
        lambda _: tstream.stream_state_from_jax(
            {**{k: np.zeros(2) for k in ("mf_ctx", "interp_ctx", "theta",
                                         "omega", "tau", "warm")},
             "costas": (np.zeros(()), np.zeros(()))})),
    "qpsk_stream.stream_blocks": (
        tqstream.stream_blocks,
        lambda _: tqstream.stream_blocks(
            "tcp://127.0.0.1:1", 1, tqt.QpskTxConfig(bits_per_block=128),
            backend="tcp")),
    "ops.agc.agc_init": (tagc.agc_init, lambda _: tagc.agc_init()),
    "ops.fir.ctx_from_reference_state": (
        tfir.ctx_from_reference_state,
        lambda _: tfir.ctx_from_reference_state(np.ones(4))),
    "fm_chain.zero_ctx": (TK.zero_ctx, lambda _: TK.zero_ctx()),
    "fir.planar_ctx_zero": (TFIR.planar_ctx_zero,
                            lambda _: TFIR.planar_ctx_zero()),
    "decim_fir.decim_ctx_zero": (TDF.decim_ctx_zero,
                                 lambda _: TDF.decim_ctx_zero(4)),
    "band_monitor.zero_spec_halo": (TBM.zero_spec_halo,
                                    lambda _: TBM.zero_spec_halo(8, 32)),
    "ops.fir.init_ctx": (tfir.init_ctx, lambda _: tfir.init_ctx(8)),
    "ops.demodulation.fm_demod_init": (tdem.fm_demod_init,
                                       lambda _: tdem.fm_demod_init()),
    "ops.channelizer.channelizer_init_ctx": (
        tchan.channelizer_init_ctx,
        lambda _: tchan.channelizer_init_ctx(64)),
    "parallel.sharding.time_mesh": (tsh.time_mesh,
                                    lambda _: tsh.time_mesh(8)),
    "parallel.wideband2d.mesh_2d": (tw2.mesh_2d,
                                    lambda _: tw2.mesh_2d(2, 4)),
    "parallel.wideband.init_state": (twb.init_state,
                                     lambda _: twb.init_state(_WB)),
    "parallel.wideband.state_from_jax": (
        twb.state_from_jax, lambda _: twb.state_from_jax([np.zeros(3)])),
    "parallel.scaling.weak_scaling": (
        tscal.weak_scaling,
        lambda _: tscal.weak_scaling(tfm.FM_LPF_TAPS, per_shard=400,
                                     shard_counts=(1,), iters=1, reps=1)),
    "ops.random.source_init": (trand.source_init,
                               lambda _: trand.source_init(7)),
    "ops.random.PRNGKey": (trand.PRNGKey, lambda _: trand.PRNGKey(7)),
    "ops.random.key_from_words": (trand.key_from_words,
                                  lambda _: trand.key_from_words([0, 7])),
    "ops.pulse.pulse_init_ctx": (tpulse.pulse_init_ctx,
                                 lambda _: tpulse.pulse_init_ctx(32, 4)),
    "ops.prns.PrnSpec.init_state": (tprns.PrnSpec.init_state,
                                    lambda _: _PRN.init_state(1)),
    "bpsk_tx.init_state": (tbt.init_state, lambda _: tbt.init_state(_BT)),
    "bpsk_tx.init_state_fast": (tbt.init_state_fast,
                                lambda _: tbt.init_state_fast(_BT)),
    "bpsk_tx.state_from_jax": (
        tbt.state_from_jax,
        lambda _: tbt.state_from_jax((np.zeros(2), np.zeros((7, 2))))),
    "bpsk_tx.fast_state_from_jax": (
        tbt.fast_state_from_jax,
        lambda _: tbt.fast_state_from_jax((np.zeros(2), np.zeros(7)))),
    "bpsk_tx.run_to_file": (tbt.run_to_file, _tx_file(tbt, _BT, False)),
    "bpsk_tx.run_to_file_fast": (tbt.run_to_file, _tx_file(tbt, _BT, True)),
    "qpsk_tx.init_state": (tqt.init_state, lambda _: tqt.init_state(_QT)),
    "qpsk_tx.init_state_fast": (tqt.init_state_fast,
                                lambda _: tqt.init_state_fast(_QT)),
    "qpsk_tx.state_from_jax": (
        tqt.state_from_jax,
        lambda _: tqt.state_from_jax((np.zeros(2), np.zeros((7, 2)),
                                      (0, 0)))),
    "qpsk_tx.fast_state_from_jax": (
        tqt.fast_state_from_jax,
        lambda _: tqt.fast_state_from_jax((np.zeros(2), np.zeros(14),
                                           (0, 0)))),
    "qpsk_tx.run_to_file": (tqt.run_to_file, _tx_file(tqt, _QT, False)),
    "qpsk_tx.run_to_file_fast": (tqt.run_to_file, _tx_file(tqt, _QT, True)),
    **{f"runtime.{k}.init_state": (type(op).init_state,
                                   lambda _, op=op: op.init_state())
       for k, op in _OPS.items()},
    "runtime.Pipeline.init_state": (trt.Pipeline.init_state,
                                    lambda _: _pipe().init_state()),
    "runtime.Graph.init_state": (trt.Graph.init_state,
                                 lambda _: _graph().init_state()),
    "runtime.checkpoint.state_from_jax": (
        tck.state_from_jax,
        lambda _: tck.state_from_jax(_pipe(), [np.zeros(7), np.zeros(())])),
    "runtime.BatchedStreamRunner.run": (trt.BatchedStreamRunner.__init__,
                                        _batched_runner),
    "runtime.metrics.sync_overhead": (tmet.sync_overhead,
                                      lambda _: tmet.sync_overhead(1)),
    "ops.resample.decimate_stream_init": (
        tres.decimate_stream_init, lambda _: tres.decimate_stream_init()),
    "ops.resample.rational_resample_init": (
        tres.rational_resample_init,
        lambda _: tres.rational_resample_init([np.ones((2, 2))])),
    "parallel.dryrun.dryrun_multichip": (
        tdry.dryrun_multichip, lambda _: tdry.dryrun_multichip(2)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, tmp_path):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call is valid")
    with pytest.raises((RuntimeError, AssertionError)):
        call(tmp_path)


@pytest.mark.parametrize("name", sorted(
    n for n in tblock.__all__ if isinstance(getattr(tblock, n), type)))
def test_every_blockop_state_defaults_to_the_card(name):
    cls = getattr(tblock, name)
    sig = inspect.signature(cls.init_state)
    assert sig.parameters["device"].default == "cuda"


def _capture(tmp_path, n=4096, dtype=np.uint8):
    p = tmp_path / "cap.bin"
    np.zeros(2 * n, dtype).tofile(p)
    return str(p)


# Each example's main without --device: every one but play_audio (host
# work only, no --device) runs on the card by default.
EXAMPLE_CALLS = {
    "fm_radio": lambda t: [_capture(t), str(t / "a.wav")],
    "multi_stream_serving": lambda t: [_capture(t, 1 << 21)],
    "qpsk_receiver": lambda t: ["4"],
    "fm_band_monitor": lambda t: [_capture(t, 1 << 12, np.float32), "8"],
    "channelizer_demo": lambda t: ["16"],
    "bpsk_mod": lambda t: ["1", str(t / "b.bin")],
    "qpsk_mod": lambda t: ["1", str(t / "q.bin")],
    "qpsk_zmq": lambda t: ["send", "tcp://127.0.0.1:1", "1"],
    "wideband_psd": lambda t: ["10"],
    "fused_sharded_fm": lambda t: ["2"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLE_CALLS))
def test_example_defaults_to_the_card(name, tmp_path, monkeypatch):
    import importlib

    mod = importlib.import_module(f"comms_tpu_torch.examples.{name}")
    assert mod.parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        mod.main(EXAMPLE_CALLS[name](tmp_path))
