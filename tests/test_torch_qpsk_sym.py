"""The QPSK symbol kernel's entries (the contract of the JAX package's
qpsk_sym_pallas) against that Pallas kernel in interpret mode, at one
IN_PER_STEP block.  Here the wrappers run the plain PyTorch versions,
because the tensors lie on the CPU; the kernel itself is compared with
them on the card by tests/test_torch_qpsk_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import qpsk_sym_pallas as JQS
from comms_tpu.models import qpsk_rx as jrx
from comms_tpu_torch.kernels import qpsk_sym as TQS
from comms_tpu_torch.models import qpsk_rx as trx

# The JAX test's bound for its kernel against the XLA form
# (tests/test_qpsk_rx.py): the two sides round the de-rotation angle
# differently (here the plain version follows the kernel's
# decomposition, but the bf16-free products still differ in order).
TOL_SYM = 1e-3
TOL_PANEL = 1e-5
N = JQS.IN_PER_STEP
W, PHASE0 = 0.011, 0.31
LAG = np.array([-0.05, 0.7, 0.4, -0.06], np.float32)


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(5)
    return (rng.normal(size=N).astype(np.float32),
            rng.normal(size=N).astype(np.float32),
            rng.normal(size=43).astype(np.float32),
            rng.normal(size=43).astype(np.float32))


def test_in_per_step_is_the_kernels_block():
    assert TQS.IN_PER_STEP == JQS.IN_PER_STEP == 512 * 512
    assert TQS.kernel_ok(N, 44, 4) and not TQS.kernel_ok(N // 2, 44, 4)
    assert not TQS.kernel_ok(N, 133, 4) and not TQS.kernel_ok(N, 44, 2)


@pytest.mark.parametrize("shift2,with_ctx", [(-4, False), (-4, True),
                                             (3, False), (3, True)])
def test_symbol_gemm_matches_jax_kernel(planes, shift2, with_ctx):
    re, im, cr, ci = planes
    jcfg = jrx.QpskRxConfig()
    fr, fi = jrx.modulated_taps(jcfg, jnp.float32(W), jnp.asarray(LAG),
                                jnp.int32(shift2))
    fr, fi = np.array(fr, np.float32), np.array(fi, np.float32)
    jctx = (jnp.asarray(cr), jnp.asarray(ci)) if with_ctx else None
    wr, wi = JQS.qpsk_symbol_gemm(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fr), jnp.asarray(fi),
        jnp.float32(W) * 4, phase0=PHASE0, ctx=jctx, interpret=True)
    tctx = (torch.from_numpy(cr), torch.from_numpy(ci)) if with_ctx else None
    gr, gi = TQS.qpsk_symbol_gemm(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(fr),
        torch.from_numpy(fi), torch.tensor(W) * 4, PHASE0, tctx)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    got = gr.numpy() + 1j * gi.numpy()
    scale = float(np.abs(np.asarray(wr)).max())
    assert got.shape == (N // 4,)
    assert np.max(np.abs(got - want)) < TOL_SYM * scale
    # the in-kernel-taps entry against the traced-taps entry
    kr, ki = TQS.qpsk_symbol_gemm_scalars(
        torch.from_numpy(re), torch.from_numpy(im), jcfg.mf_taps,
        torch.tensor(W), torch.from_numpy(LAG),
        torch.tensor(shift2, dtype=torch.int32), phase0=PHASE0, ctx=tctx)
    assert np.max(np.abs(kr.numpy() + 1j * ki.numpy() - got)) < \
        TOL_SYM * scale


def test_scalars_entry_matches_jax_kernel(planes):
    re, im, cr, ci = planes
    jcfg = jrx.QpskRxConfig()
    wr, wi = JQS.qpsk_symbol_gemm_scalars(
        jnp.asarray(re), jnp.asarray(im), jcfg.mf_taps, jnp.float32(W),
        jnp.asarray(LAG), jnp.int32(-1), phase0=PHASE0,
        ctx=(jnp.asarray(cr), jnp.asarray(ci)), interpret=True)
    gr, gi = TQS.qpsk_symbol_gemm_scalars(
        torch.from_numpy(re), torch.from_numpy(im), jcfg.mf_taps, W,
        torch.from_numpy(LAG), -1, phase0=PHASE0,
        ctx=(torch.from_numpy(cr), torch.from_numpy(ci)))
    scale = float(np.abs(np.asarray(wr)).max())
    assert np.max(np.abs(gr.numpy() - np.asarray(wr))) < TOL_SYM * scale
    assert np.max(np.abs(gi.numpy() - np.asarray(wi))) < TOL_SYM * scale


def test_modulated_taps_match_jax():
    for shift2 in (-4, 0, 4):
        jr, ji = jrx.modulated_taps(jrx.QpskRxConfig(), jnp.float32(W),
                                    jnp.asarray(LAG), jnp.int32(shift2))
        tr, ti = trx.modulated_taps(trx.QpskRxConfig(), torch.tensor(W),
                                    torch.from_numpy(LAG),
                                    torch.tensor(shift2))
        assert np.max(np.abs(tr.numpy() - np.asarray(jr))) < 1e-6
        assert np.max(np.abs(ti.numpy() - np.asarray(ji))) < 1e-6


def test_panels_match_jax_kernel(planes):
    re, im, _, _ = planes
    hw = jrx.QpskRxConfig().panel_hw
    want = JQS.qpsk_panels(jnp.asarray(re), jnp.asarray(im), hw,
                           interpret=True)
    got = TQS.qpsk_panels(torch.from_numpy(re), torch.from_numpy(im), hw)
    scale = max(float(np.abs(np.asarray(p)).max()) for p in want[:4])
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - np.asarray(w))) < TOL_PANEL * scale
    assert set(got[4]) == set(want[4])
    for k in ("nd", "K", "Kp", "R", "width"):
        assert got[4][k] == want[4][k]
    # the symbol entry with panels returns the same panels
    z = torch.zeros(44)
    _, _, p2 = TQS.qpsk_symbol_gemm(torch.from_numpy(re), torch.from_numpy(im),
                                    z, z, 0.0, panels_hw=hw)
    for a, b in zip(got[:4], p2[:4]):
        assert torch.equal(a, b)


def test_entry_errors():
    z = torch.zeros(N)
    t = torch.zeros(44)
    with pytest.raises(ValueError, match="outside kernel bounds"):
        TQS.qpsk_symbol_gemm(z[:N // 2].contiguous(), z[:N // 2].contiguous(),
                             t, t, 0.0)
    with pytest.raises(ValueError, match="outside kernel bounds"):
        TQS.qpsk_symbol_gemm(z, z, torch.zeros(136), torch.zeros(136), 0.0)
    with pytest.raises(ValueError, match="panels_hw"):
        TQS.qpsk_symbol_gemm(z, z, t, t, 0.0, panels_hw=65)
    with pytest.raises(ValueError, match="panels_hw"):
        TQS.qpsk_panels(z, z, 0)
    with pytest.raises(ValueError, match="MD-1"):
        TQS.qpsk_symbol_gemm(z, z, t, t, 0.0, ctx=(t, t))
    with pytest.raises(ValueError, match="shift-row"):
        TQS.qpsk_symbol_gemm_scalars(z, z, np.zeros(117), 0.0, t[:4], 0)
