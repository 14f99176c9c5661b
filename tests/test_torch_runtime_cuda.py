"""The runtime layer on a CUDA card, at small shapes: the FIR BlockOps on
K2's kernel (and K4's entry at D = 1) against the GEMM route on the same
input, one launch a block; the composed FM pipeline against the port's
block function; the transmitters' pipelines bit-equal to their block
functions and to the CPU; a sharded pipeline against the unsharded one
with K12's launches counted; a checkpoint resumed bit for bit; the Graph
feedback loop; the batched runner against separate runs, and vmap
refusing a step that launches a ctypes kernel.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch import runtime as T
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.kernels import fir as TFIR
from comms_tpu_torch.kernels import halo_ring as THR
from comms_tpu_torch.models import bpsk_tx as tbt
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.models import qpsk_tx as tqt
from comms_tpu_torch.ops import fir as tfir
from comms_tpu_torch.parallel import sharding as tsh
from comms_tpu_torch.runtime import checkpoint as tck
from comms_tpu_torch.runtime.block import takes_kernel

# float32 on both sides in other summation orders (the port's K2 tests)
TOL_FIR = 5e-5
# the FM chain against its tensor path (the port's FM tests' TOL_BLOCK)
TOL_BLOCK = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dec,T_,ctaps,cx", [(5, 63, False, True),
                                              (4, 32, True, True),
                                              (5, 63, False, False),
                                              (1, 32, False, True),
                                              (1, 32, False, False),
                                              (1, 257, True, True)])
def test_fir_ops_on_the_kernel(cuda, dec, T_, ctaps, cx):
    rng = np.random.default_rng(T_ + dec)
    h = rng.normal(size=T_) + (1j * rng.normal(size=T_) if ctaps else 0)
    h = h.astype(np.complex64 if ctaps else np.float32)
    n = 4 * 1024 * max(dec, 1)
    x = rng.normal(size=2 * n) + (1j * rng.normal(size=2 * n) if cx else 0)
    x = torch.from_numpy(x.astype(np.complex64 if cx else np.float32)).to(
        cuda)
    op = T.FirDecimate.make(h, dec) if dec > 1 else T.Fir.make(h)
    assert takes_kernel(x.dtype, n, h, dec)
    mod = TDF if dec > 1 else TFIR
    s = op.init_state(dtype=x.dtype, device=cuda)
    s_ref = op.init_state(dtype=x.dtype, device=cuda)
    C = tfir.decimating_branch_taps(h, dec) if dec > 1 else None
    for b in range(2):
        xb = x[b * n:(b + 1) * n]
        before = mod.launches
        y, s = op.apply(s, xb)
        assert mod.launches == before + 1
        if dec > 1:
            want, s_ref = tfir.fir_decimate_poly(xb, C, s_ref)
        else:
            want, s_ref = tfir.fir_block(xb, h, s_ref)
        assert y.dtype == want.dtype and _err(y, want) < TOL_FIR
        assert torch.equal(s, s_ref)           # the carried input tail


@pytest.mark.cuda
def test_fm_pipeline_on_the_card(cuda):
    cfg = tfm.FmReceiverConfig(block=8 * 25600)
    pipe, blk = tfm.make_pipeline(cfg), tfm.make_block_fn(cfg)
    rng = np.random.default_rng(8)
    s_pipe, s_blk = pipe.init_state(cuda), tfm.init_state(cfg, cuda)
    for b in range(3):
        iq = torch.from_numpy(rng.integers(0, 256, size=(cfg.block, 2),
                                           dtype=np.uint8)).to(cuda)
        before = TDF.launches
        y, s_pipe = pipe.step(s_pipe, iq)
        assert TDF.launches == before + 2
        want, s_blk = blk(s_blk, iq)
        assert float((y - want).abs().max()) <= TOL_BLOCK
        assert torch.equal(torch.view_as_real(s_pipe[1]), s_blk[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_tx_pipelines_on_the_card(cuda, kind):
    if kind == "bpsk":
        mod, cfg = tbt, tbt.BpskTxConfig(syms_per_block=4096)
    else:
        mod, cfg = tqt, tqt.QpskTxConfig(bits_per_block=8192, dphase=0.01,
                                          phase0=0.6)
    pipe, blk = mod.make_pipeline(cfg, seed=3), mod.make_block_fn(cfg)
    s_pipe, s_blk = pipe.init_state(cuda), mod.init_state(cfg, 3, cuda)
    s_cpu = pipe.init_state("cpu")
    for b in range(3):
        y, s_pipe = pipe.step(s_pipe)
        want, s_blk = blk(s_blk)
        y_cpu, s_cpu = pipe.step(s_cpu)
        assert torch.equal(y, want), b
        if kind == "bpsk":      # the QPSK pair path: 1 LSB on the card
            assert torch.equal(y.cpu(), y_cpu), b


@pytest.mark.cuda
def test_sharded_fm_pipeline_on_the_card(cuda):
    cfg = tfm.FmReceiverConfig(block=8 * 25600)
    pipe = tfm.make_pipeline(cfg)
    mesh = tsh.time_mesh(8, device=cuda)
    step = pipe.make_sharded_step(mesh, block=cfg.block)
    rng = np.random.default_rng(2)
    s_ref, s_sh = pipe.init_state(cuda), pipe.init_state(cuda)
    for b in range(2):
        iq = torch.from_numpy(rng.integers(0, 256, size=(cfg.block, 2),
                                           dtype=np.uint8)).to(cuda)
        y_ref, s_ref = pipe.step(s_ref, iq)
        k12, k2 = THR.launches, TDF.launches
        y_sh, s_sh = step(s_sh, iq)
        # one ring exchange per op with a halo, one K2 launch a shard
        assert THR.launches - k12 == 3 and TDF.launches - k2 == 16
        assert torch.equal(y_sh, y_ref), b      # the kernel's FMA chains
        for a, c in zip(s_sh, s_ref):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, c)


@pytest.mark.cuda
def test_checkpoint_and_graph_on_the_card(cuda, tmp_path):
    pipe = tqt.make_pipeline(tqt.QpskTxConfig(bits_per_block=4096,
                                              dphase=0.2), seed=1)
    s = pipe.init_state(cuda)
    for _ in range(2):
        _, s = pipe.step(s)
    tck.save_state(tmp_path / "ck", s)
    y_cont, _ = pipe.step(s)
    y_res, _ = pipe.step(tck.load_state(tmp_path / "ck",
                                        pipe.init_state(cuda)))
    assert torch.equal(y_cont, y_res)
    g = T.Graph()
    g.add_node("double", lambda prev: prev * 2, ["double"],
               feedback_from={"double": torch.ones(1, device=cuda)})
    g.set_outputs(["double"])
    step, st = g.compile(), g.init_state(device=cuda)
    for k in range(1, 11):
        (out,), st = step(st, {})
        assert float(out[0]) == 2.0 ** k


@pytest.mark.cuda
def test_batched_runner_on_the_card(cuda):
    cfg = tfm.FmReceiverConfig(block=25600)
    pipe = tfm.make_pipeline(cfg)
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.integers(0, 256, size=(3, 2, cfg.block, 2),
                                       dtype=np.uint8)).to(cuda)
    want = []
    for b in range(3):
        s, got = pipe.init_state(cuda), []
        for k in range(2):
            y, s = pipe.step(s, xs[b, k])
            got.append(y.cpu().numpy())
        want.append(got)
    outs = [[] for _ in range(3)]
    T.BatchedStreamRunner(pipe.step, [pipe.init_state(cuda)] * 3,
                          batched_source=[xs[:, k] for k in range(2)],
                          sinks=[o.append for o in outs], depth=2,
                          device=cuda).run()
    for b in range(3):
        for k in range(2):
            np.testing.assert_array_equal(outs[b][k], want[b][k])
    r = T.BatchedStreamRunner(pipe.step, [pipe.init_state(cuda)] * 2,
                              batched_source=[xs[:2, 0]], mode="vmap",
                              device=cuda)
    with pytest.raises(ValueError, match="vmap"):
        r.run()
