"""Each model's ``make_pipeline`` on the port's runtime layer: equal to
the port's ``make_block_fn`` from the same seed and state, and to the
JAX package's ``make_pipeline`` (as tests/test_models.py:388-420 holds
the JAX ones to theirs).

Bounds: the transmitters equal the port's ``make_block_fn`` bit for bit
and JAX's ``make_pipeline`` within 1 i16 LSB on under 1% of samples (the
port's pair paths against JAX's, tests/test_torch_tx.py); FM on the
GEMM route (blocks of 10,000) equal to ``make_block_fn`` bit for bit, on
K2's route (25,600: its plain version here) within TOL_K2 of the largest
output, and within TOL_BLOCK of JAX's ``make_pipeline`` (the bound
between the two packages' FM chains, tests/test_torch_fm_receiver.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import bpsk_tx as jbt
from comms_tpu.models import fm_receiver as jfm
from comms_tpu.models import qpsk_tx as jqt
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.models import bpsk_tx as tbt
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.models import qpsk_tx as tqt
from comms_tpu_torch.runtime import block as TB
from tests._tx_oracle import lsb_diff

CPU = "cpu"
TOL_K2 = 5e-5      # tests/test_torch_decim_fir.py's TOL_SPLIT
TOL_BLOCK = 2e-4   # tests/test_torch_fm_receiver.py's TOL_BLOCK


@pytest.mark.parametrize("block,kernel", [(10000, False), (25600, True)])
def test_fm_pipeline_matches_block_fn_and_jax(block, kernel):
    cfg = tfm.FmReceiverConfig(block=block)
    pipe = tfm.make_pipeline(cfg)
    stage1, stage2 = pipe.ops[1], pipe.ops[3]
    assert TB.takes_kernel(torch.complex64, block, stage1._taps_np,
                           5) is kernel
    assert TB.takes_kernel(torch.float32, block // 5, stage2._taps_np,
                           5) is kernel
    blk = tfm.make_block_fn(cfg)
    jcfg = jfm.FmReceiverConfig(block=block)
    jpipe = jfm.make_pipeline(jcfg)
    rng = np.random.default_rng(8)
    iq = rng.integers(0, 256, size=(3, block, 2), dtype=np.uint8)
    s_pipe, s_blk = pipe.init_state(CPU), tfm.init_state(cfg, CPU)
    ys, s_run = pipe.run(pipe.init_state(CPU), torch.from_numpy(iq))
    jys, _ = jpipe.run(jpipe.init_state(), jnp.asarray(iq))
    launches = TDF.launches
    for b in range(3):
        x = torch.from_numpy(iq[b])
        y, s_pipe = pipe.step(s_pipe, x)
        want, s_blk = blk(s_blk, x)
        if kernel:
            assert (y - want).abs().max() <= TOL_K2 * want.abs().max()
        else:
            assert torch.equal(y, want), b
        assert torch.equal(ys[b], y)                  # run == step
        np.testing.assert_allclose(y.numpy(), np.asarray(jys[b]),
                                   atol=TOL_BLOCK, rtol=0)
    assert TDF.launches == launches        # the CPU runs the plain version
    # the same carried stream: the block fn's pair tail is the pipeline's
    # complex tail
    assert torch.equal(torch.view_as_real(s_pipe[1]), s_blk[0])
    assert torch.equal(s_pipe[3], s_blk[2])


@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_tx_pipeline_matches_block_fn_and_jax(kind):
    if kind == "bpsk":
        cfg, jcfg = (tbt.BpskTxConfig(syms_per_block=2048),
                     jbt.BpskTxConfig(syms_per_block=2048))
        T, J = tbt, jbt
    else:
        kw = dict(bits_per_block=4096, dphase=0.21, phase0=0.5)
        cfg, jcfg = tqt.QpskTxConfig(**kw), jqt.QpskTxConfig(**kw)
        T, J = tqt, jqt
    pipe, jpipe = T.make_pipeline(cfg, seed=0), J.make_pipeline(jcfg, seed=0)
    blk = T.make_block_fn(cfg)
    s_ref, s_pipe = T.init_state(cfg, 0, CPU), pipe.init_state(CPU)
    js = jpipe.init_state()
    for b in range(3):
        iq_ref, s_ref = blk(s_ref)
        iq_pipe, s_pipe = pipe.step(s_pipe)
        jiq, js = jpipe.step(js)
        assert iq_pipe.dtype == torch.int16
        assert torch.equal(iq_pipe, iq_ref), b
        big, share = lsb_diff(iq_pipe.numpy(), np.asarray(jiq))
        assert big <= 1 and share < 0.01, (b, big, share)
    assert torch.equal(s_pipe[0], s_ref[0])          # the same key
