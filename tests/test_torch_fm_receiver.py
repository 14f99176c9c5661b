"""comms_tpu_torch.models.fm_receiver against comms_tpu.models.fm_receiver:
block functions (polyphase and dense), streaming, the fused block step,
run_file's ragged tail, and state carried from one package to the
other."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import fm_receiver as jfm
from comms_tpu_torch.models import fm_receiver as tfm

# tests/test_models.py:127-162 hold the XLA chain to 2e-4 against an
# f64 oracle; both packages run float32, so 2e-4 bounds them together.
TOL_BLOCK = 2e-4
# tests/test_fused_chain.py: the fused chain against the XLA chain.
TOL_FUSED = 1e-3


def _fm_capture(n, step=0.3, wobble=0.02, amp=100, seed=0):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(step + wobble * rng.normal(size=n))
    z = np.exp(1j * ph)
    return np.stack([
        np.clip(np.round(z.real * amp + 127.5), 0, 255),
        np.clip(np.round(z.imag * amp + 127.5), 0, 255),
    ], axis=-1).astype(np.uint8)


def _jax_blocks(cfg_block, iq_blocks):
    cfg = jfm.FmReceiverConfig(block=cfg_block)
    blk = jfm.make_block_fn(cfg)
    st = jfm.init_state(cfg)
    outs = []
    for xb in iq_blocks:
        a, st = blk(st, jnp.asarray(xb))
        outs.append(np.asarray(a))
    return outs, st


def _port_blocks(cfg_block, iq_blocks, state=None):
    cfg = tfm.FmReceiverConfig(block=cfg_block)
    blk = tfm.make_block_fn(cfg)
    st = tfm.init_state(cfg, device="cpu") if state is None else state
    outs = []
    for xb in iq_blocks:
        a, st = blk(st, torch.from_numpy(xb))
        outs.append(a.numpy())
    return outs, st


@pytest.mark.parametrize("block,polyphase", [(4000, True), (4001, False)])
@pytest.mark.parametrize("nblocks", [1, 2])
def test_make_block_fn_matches_jax(block, polyphase, nblocks):
    iq = _fm_capture(nblocks * block, seed=block)
    blocks = [iq[b * block:(b + 1) * block] for b in range(nblocks)]
    assert tfm.FmReceiverConfig(block=block).polyphase is polyphase
    want, st_j = _jax_blocks(block, blocks)
    got, st_t = _port_blocks(block, blocks)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= TOL_BLOCK
    for a, b in zip(st_t, st_j):
        assert a.shape == np.asarray(b).shape
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= TOL_BLOCK


def test_make_scan_fn_matches_jax():
    block, nb = 2000, 3
    iq = _fm_capture(nb * block, seed=3).reshape(nb, block, 2)
    cfg_j = jfm.FmReceiverConfig(block=block)
    want, _ = jfm.make_scan_fn(cfg_j)(jfm.init_state(cfg_j),
                                      jnp.asarray(iq))
    cfg_t = tfm.FmReceiverConfig(block=block)
    got, _ = tfm.make_scan_fn(cfg_t)(tfm.init_state(cfg_t, device="cpu"),
                                     torch.from_numpy(iq))
    assert tuple(got.shape) == np.asarray(want).shape
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL_BLOCK


def test_fused_block_fn_two_blocks_matches_jax_oracle():
    # tests/test_fused_chain.py:50-68 with the port's fused step.
    N = tfm.FUSED_BLOCK_QUANTUM
    rng = np.random.default_rng(1)
    iq = rng.integers(0, 256, size=(2 * N, 2), dtype=np.uint8)
    blk = tfm.make_fused_block_fn(tfm.FmReceiverConfig(block=N))
    st = tfm.fused_init_state(device="cpu")
    outs = []
    for b in range(2):
        xb = torch.from_numpy(iq[b * N:(b + 1) * N])
        a, st = blk(st, xb[:, 0].contiguous(), xb[:, 1].contiguous())
        outs.append(a.numpy())
    got = np.concatenate(outs)
    (want,), _ = _jax_blocks(2 * N, [iq])
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < TOL_FUSED


def test_fused_block_fn_rejects_bad_block():
    with pytest.raises(ValueError, match="102400"):
        tfm.make_fused_block_fn(tfm.FmReceiverConfig(block=262144))


def test_run_file_ragged_tail_matches_jax(tmp_path):
    B = 25 * 400
    L = 2 * B + 4321
    iq = _fm_capture(L, seed=7)
    p = tmp_path / "capture.iq"
    iq.tofile(p)
    want = jfm.run_file(p, jfm.FmReceiverConfig(block=B))
    got = tfm.run_file(p, tfm.FmReceiverConfig(block=B), device="cpu")
    assert got.shape == want.shape == (
        tfm._tail_valid_out(tfm.FmReceiverConfig(block=B), L),)
    assert np.max(np.abs(got - want)) < 1e-5


def test_run_file_fused_ragged_tail_matches_jax(tmp_path):
    # tests/test_fused_chain.py:79-104: fused full blocks + the tensor-op
    # ragged tail from the converted context, against the XLA path.
    B = tfm.FUSED_BLOCK_QUANTUM
    L = 2 * B + 3777
    iq = _fm_capture(L, seed=4)
    p = tmp_path / "cap.iq"
    iq.tofile(p)
    want = jfm.run_file(p, jfm.FmReceiverConfig(block=B), fused=False)
    got = tfm.run_file(p, tfm.FmReceiverConfig(block=B), fused=True,
                       device="cpu")
    unfused = tfm.run_file(p, tfm.FmReceiverConfig(block=B), device="cpu")
    assert got.shape == want.shape == unfused.shape
    assert np.max(np.abs(got - want)) < TOL_FUSED
    assert np.max(np.abs(unfused - want)) < 1e-5


@pytest.mark.parametrize("block", [4000, 4001])
def test_state_from_jax_continues_the_stream(block):
    iq = _fm_capture(2 * block, seed=5)
    blocks = [iq[:block], iq[block:]]
    want, _ = _jax_blocks(block, blocks)
    # JAX runs block 0; the port takes its state and runs block 1.
    _, st_j = _jax_blocks(block, blocks[:1])
    st_t = tfm.state_from_jax([np.asarray(s) for s in st_j], device="cpu")
    got, _ = _port_blocks(block, blocks[1:], state=st_t)
    assert np.max(np.abs(got[0] - want[1])) <= TOL_BLOCK


def test_fused_state_from_jax_continues_the_stream():
    from comms_tpu.kernels import fm_chain_pallas as JK

    N = tfm.FUSED_BLOCK_QUANTUM
    rng = np.random.default_rng(8)
    iq = rng.integers(0, 256, size=(2, 2 * N), dtype=np.uint8)
    ctx_j = jfm.fused_ctx_from_raw_tail(
        jnp.asarray(iq[0, N - jfm.FUSED_TAIL_SAMPLES:N]),
        jnp.asarray(iq[1, N - jfm.FUSED_TAIL_SAMPLES:N]))
    ctx_np = {k: np.asarray(v) for k, v in ctx_j.items()}
    want = np.asarray(JK.fm_chain_fused(
        jnp.asarray(iq[0, N:]), jnp.asarray(iq[1, N:]), ctx_np,
        jfm.FM_LPF_TAPS, jfm.FM_LPF_TAPS, interpret=True))
    blk = tfm.make_fused_block_fn(tfm.FmReceiverConfig(block=N))
    got, st = blk(tfm.fused_state_from_jax(ctx_np, device="cpu"),
                  torch.from_numpy(iq[0, N:].copy()),
                  torch.from_numpy(iq[1, N:].copy()))
    assert np.max(np.abs(got.numpy() - want)) < TOL_FUSED
    # The port derives the same context from the same raw tail.
    ctx_t = tfm.fused_ctx_from_raw_tail(
        torch.from_numpy(iq[0, :N].copy()), torch.from_numpy(iq[1, :N].copy()))
    for k, v in ctx_np.items():
        assert ctx_t[k].shape == v.shape
        assert np.max(np.abs(ctx_t[k].numpy() - v)) < 1e-5, k
