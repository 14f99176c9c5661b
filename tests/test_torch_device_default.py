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
from comms_tpu_torch.models import channelizer as tchm
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_rx_stream as tstream
from comms_tpu_torch.ops import channelizer as tchan
from comms_tpu_torch.ops import demodulation as tdem
from comms_tpu_torch.ops import fir as tfir
from comms_tpu_torch.parallel import dryrun as tdry
from comms_tpu_torch.parallel import scaling as tscal
from comms_tpu_torch.parallel import sharding as tsh
from comms_tpu_torch.parallel import wideband as twb
from comms_tpu_torch.parallel import wideband2d as tw2
from comms_tpu_torch.runtime import StreamRunner

_FM = tfm.FmReceiverConfig(block=2000)
_BM = tbm.BandMonitorConfig(num_channels=8, block=TBM.step_samples())
_CH = tchm.ChannelizerConfig(num_channels=8, block=4096)
_WB = twb.WidebandConfig(tfm.FM_LPF_TAPS, block=8 * 400)


def _run_file(tmp_path):
    p = tmp_path / "cap.iq"
    np.zeros((2 * _FM.block, 2), np.uint8).tofile(p)
    return tfm.run_file(p, _FM)


def _stream_runner(tmp_path):
    runner = StreamRunner(lambda s, x: (x, s), None,
                          [np.zeros(16, np.float32)], sink=lambda y: None)
    return runner.run()


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
