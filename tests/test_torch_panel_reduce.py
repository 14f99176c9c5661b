"""The panel-reduction kernel's contract (the JAX package's
panel_reduce_pallas) against that Pallas kernel in interpret mode, at
the receiver's panel halfwidth (51) and at the bounds of
tests/test_kernels.py.  Here the wrapper runs the plain PyTorch version,
because the tensors lie on the CPU; the kernel itself is compared with
it on the card by tests/test_torch_qpsk_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import panel_reduce_pallas as JPR
from comms_tpu.models import qpsk_rx as jrx
from comms_tpu_torch.kernels import panel_reduce as TPR
from comms_tpu_torch.models import qpsk_rx as trx

TOL = 1e-4           # relative to the largest lag sum
TOL_F = 1e-5         # rad


def _packed(hw, seed):
    """The fused kernel's [256, 256] accumulators of random planes'
    panels (numpy), and the panels (torch)."""
    cfg = trx.QpskRxConfig()
    rng = np.random.default_rng(seed)
    N = 1 << 14
    re = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    panels = cfg.timing.corr_panels(re, im, halfwidth=hw)
    P1, P2, P3, P4, meta = panels
    width = meta["width"]
    p13 = np.zeros((256, 256), np.float32)
    p24 = np.zeros((256, 256), np.float32)
    p13[:128, :width] = P1.numpy()
    p13[128:, :width] = P3.numpy()
    p24[:128, :width] = -P2.numpy()
    p24[128:, :width] = -P4.numpy()
    return cfg, panels, p13, p24


def _check_against_lag_sums(cfg, panels, got, hw, scale):
    """The lag sums are TimingEstimator.lag_sums_r2, row 2 the angle of
    its v = -1 entry, and what the TPU kernel leaves unwritten is 0."""
    V = 2 * hw + 1
    gr, gi = (g.numpy() for g in cfg.timing.lag_sums_r2(panels))
    assert np.max(np.abs(got[0, :V] - gr)) < TOL * scale
    assert np.max(np.abs(got[1, :V] - gi)) < TOL * scale
    assert abs(got[2, 0] - np.arctan2(gi[hw - 1], gr[hw - 1])) < TOL_F
    written = np.zeros((16, 128), bool)
    written[[0, 1] + [8 + a for a in range(cfg.sps)], :V] = True
    written[2, 0] = True
    assert not np.any(got[~written])


def test_panel_reductions_match_jax_kernel():
    # the receiver's halfwidth; the Pallas kernel unrolls a loop per lag,
    # so one halfwidth costs ~15 s in interpret mode
    hw = 51
    cfg, panels, p13, p24 = _packed(hw, 3)
    want = np.asarray(JPR.panel_reductions(jnp.asarray(p13),
                                           jnp.asarray(p24), hw,
                                           interpret=True))
    n0 = TPR.launches
    got = TPR.panel_reductions(torch.from_numpy(p13), torch.from_numpy(p24),
                               hw).numpy()
    assert TPR.launches == n0                 # CPU tensors: no kernel
    V = 2 * hw + 1
    scale = float(np.max(np.abs(want[:2, :V])))
    for r in [0, 1] + [8 + a for a in range(cfg.sps)]:
        assert np.max(np.abs(got[r, :V] - want[r, :V])) < TOL * scale, r
    assert abs(got[2, 0] - want[2, 0]) < TOL_F
    _check_against_lag_sums(cfg, panels, got, hw, scale)
    # rows 0/1 give the receiver's timing estimate
    w = torch.tensor(0.01)
    t_panels = cfg.timing.estimate_from_panels(panels, weights=cfg.wq2,
                                               lag_rot=w)
    t_rows = cfg.timing.estimate_from_lag_sums(
        torch.from_numpy(got[0, :V]), torch.from_numpy(got[1, :V]),
        weights=cfg.wq2, lag_rot=w)
    assert abs(float(t_rows) - float(t_panels)) < 1e-4


@pytest.mark.parametrize("hw,seed", [(20, 4), (63, 5)])
def test_panel_reductions_other_halfwidths(hw, seed):
    cfg, panels, p13, p24 = _packed(hw, seed)
    got = TPR.panel_reductions(torch.from_numpy(p13), torch.from_numpy(p24),
                               hw).numpy()
    scale = float(np.max(np.abs(got[:2])))
    _check_against_lag_sums(cfg, panels, got, hw, scale)
    Er = (panels[0] - panels[3]).numpy()     # r2 = 1 on rows j = 0 mod 4
    for v in (0, 7, 2 * hw):
        ref = sum(Er[j, j + v] for j in range(0, 128, cfg.sps))
        assert abs(got[8, v] - ref) < TOL * scale


def test_row2_is_not_the_receivers_frequency_estimate():
    """Row 2 is the angle of the r2-ROTATED v = -1 lag sum; the
    receiver's frequency estimate sums the unrotated diagonal."""
    cfg, panels, p13, p24 = _packed(51, 6)
    got = TPR.panel_reductions(torch.from_numpy(p13), torch.from_numpy(p24),
                               51)
    f_est = trx._estimates_from_panels(cfg, panels)[0]
    jf = jrx._estimates_from_panels(
        jrx.QpskRxConfig(),
        tuple(jnp.asarray(p.numpy()) for p in panels[:4])
        + ({"nd": 51, "fdt": jnp.float32},))[0]
    assert abs(float(f_est) - float(jf)) < TOL_F
    assert abs(float(got[2, 0]) - float(f_est)) > TOL_F


def test_panel_reductions_bounds():
    z = torch.zeros((256, 256))
    with pytest.raises(ValueError, match="hw"):
        TPR.panel_reductions(z, z, 64)
    with pytest.raises(ValueError, match="hw"):
        TPR.panel_reductions(z, z, 0)
    with pytest.raises(ValueError, match="sps"):
        TPR.panel_reductions(z, z, 51, sps=9)
    with pytest.raises(ValueError, match=r"\[256, 256\]"):
        TPR.panel_reductions(z[:128], z[:128], 51)
