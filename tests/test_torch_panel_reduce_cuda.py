"""The panel-reduction kernel (K11) on a CUDA card, at hw 20, 51 and 63
and every sps 1..8: two calls on the same panels give the same bits; rows
0, 1 and 8+a lie within 1e-4 (relative to the largest lag sum, the
tolerance of chip_smoke.TOL_REDUCE) of ``panel_reductions_plain``; row 2
within 1e-5 rad of plain and, at the receiver's sps, of the angle of the
r2-rotated v = -1 lag sum; every other entry is 0; the timing estimate
from rows 0/1 within 1e-4 of the one from the panels.  The kernel sums
in another order than plain (row groups, then the groups in order), so
the check is a tolerance, not bits.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_panel_reduce_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import panel_reduce as TPR
from comms_tpu_torch.models import qpsk_rx as trx

TOL = 1e-4
TOL_F = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _panels(card, hw: int, seed: int):
    cfg = trx.QpskRxConfig()
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    re = torch.randn(1 << 18, generator=g, device=card)
    im = torch.randn(1 << 18, generator=g, device=card)
    qp = cfg.timing.corr_panels(re, im, halfwidth=hw)
    w = qp[4]["width"]
    p13 = torch.zeros((256, 256), device=card)
    p24 = torch.zeros((256, 256), device=card)
    p13[:128, :w], p13[128:, :w] = qp[0], qp[2]
    p24[:128, :w], p24[128:, :w] = -qp[1], -qp[3]
    return cfg, qp, p13, p24


@pytest.mark.cuda
@pytest.mark.parametrize("sps", range(1, 9))
@pytest.mark.parametrize("hw", [20, 51, 63])
def test_kernel_against_plain(card, hw, sps):
    cfg, qp, p13, p24 = _panels(card, hw, hw * 10 + sps)
    n0 = TPR.launches
    got = TPR.panel_reductions(p13, p24, hw, sps)
    again = TPR.panel_reductions(p13, p24, hw, sps)
    want = TPR.panel_reductions_plain(p13, p24, hw, sps)
    torch.cuda.synchronize()
    assert TPR.launches == n0 + 2
    assert torch.equal(got, again)
    V = 2 * hw + 1
    rows = [0, 1] + [8 + a for a in range(sps)]
    scale = float(want[:2, :V].abs().max())
    assert float((got[rows][:, :V] - want[rows][:, :V]).abs().max()) \
        <= TOL * scale
    assert abs(float(got[2, 0]) - float(want[2, 0])) <= TOL_F
    written = torch.zeros((16, 128), dtype=torch.bool, device=card)
    written[rows, :V] = True
    written[2, 0] = True
    assert not bool((got[~written] != 0).any())
    if sps == cfg.sps:
        gr, gi = cfg.timing.lag_sums_r2(qp)
        assert abs(float(got[2, 0])
                   - float(torch.atan2(gi[hw - 1], gr[hw - 1]))) <= TOL_F


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [20, 51, 63])
def test_timing_from_the_lag_sums(card, hw):
    # the receiver's folded weights (over its 2 * 51 + 1 lags), cut or
    # zero-padded about the centre to this halfwidth's lags
    cfg, qp, p13, p24 = _panels(card, hw, hw)
    got = TPR.panel_reductions(p13, p24, hw)
    V = 2 * hw + 1
    c = cfg.panel_hw
    wq = np.zeros(2 * max(hw, c) + 1, np.complex128)
    wq[max(hw, c) - c:max(hw, c) + c + 1] = cfg.wq2
    wq = wq[max(hw, c) - hw:max(hw, c) + hw + 1]
    w = torch.tensor(0.01, device=card)
    t_panels = cfg.timing.estimate_from_panels(qp, weights=wq, lag_rot=w)
    t_rows = cfg.timing.estimate_from_lag_sums(got[0, :V], got[1, :V],
                                               weights=wq, lag_rot=w)
    assert abs(float(t_rows) - float(t_panels)) < 1e-4
