"""The panel-reduction kernel's contract (the JAX package's
panel_reduce_pallas) against that Pallas kernel in interpret mode, at
the receiver's panel halfwidth (51) and at the bounds of
tests/test_kernels.py.  Here the wrapper runs the plain PyTorch version,
because the tensors lie on the CPU; the kernel itself is compared with
it on the card by tests/test_torch_qpsk_cuda.py and chip_smoke.py."""

import re
from pathlib import Path

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


@pytest.mark.parametrize("sps", [2, 8])
def test_panel_reductions_other_sps_match_jax_kernel(sps):
    # the residue rows 8+a at other samples per symbol; hw 20 keeps the
    # interpret-mode kernel to a few seconds
    hw = 20
    _, _, p13, p24 = _packed(hw, 10 + sps)
    want = np.asarray(JPR.panel_reductions(jnp.asarray(p13),
                                           jnp.asarray(p24), hw, sps=sps,
                                           interpret=True))
    got = TPR.panel_reductions(torch.from_numpy(p13), torch.from_numpy(p24),
                               hw, sps).numpy()
    V = 2 * hw + 1
    scale = float(np.max(np.abs(want[:2, :V])))
    for r in [0, 1] + [8 + a for a in range(sps)]:
        assert np.max(np.abs(got[r, :V] - want[r, :V])) < TOL * scale, r
    assert abs(got[2, 0] - want[2, 0]) < TOL_F
    written = np.zeros((16, 128), bool)
    written[[0, 1] + [8 + a for a in range(sps)], :V] = True
    written[2, 0] = True
    assert not np.any(got[~written])


_SRC = (Path(__file__).resolve().parents[1] / "comms_tpu_torch" / "csrc"
        / "panel_reduce.cu").read_text()


def _k11_const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", _SRC)
    expr = m.group(1).split("//")[0]
    return int(eval(expr, {}, {k: _k11_const(k) for k in
                               re.findall(r"k[A-Z]\w*", expr)}))


def _k11_replay(p13, p24, hw: int, sps: int):
    """The kernel's arithmetic in numpy float32, in its order: c2/s2 once
    per residue from the float32 angle, each row group's rows summed in
    order, the groups' partial sums combined in group order; the block
    written entry by entry as the kernel's threads write it."""
    groups, lanes = _k11_const("kGroups"), _k11_const("kLanes")
    grows, threads = _k11_const("kGroupRows"), _k11_const("kThreads")
    f = np.float32
    dphi = f(2.0 * np.pi / sps)
    ang = np.arange(sps, dtype=f) * dphi
    c2s, s2s = np.cos(ang).astype(f), np.sin(ang).astype(f)
    V = 2 * hw + 1
    part = np.zeros((groups, 10, lanes), f)
    v = np.arange(V)
    for g in range(groups):
        gr = np.zeros(V, f)
        gi = np.zeros(V, f)
        ga = np.zeros((8, V), f)
        for i in range(grows):
            j = g * grows + i
            a = j % sps
            c2, s2 = c2s[a], s2s[a]
            P1, P3 = p13[j, j + v], p13[lanes + j, j + v]
            P2, P4 = -p24[j, j + v], -p24[lanes + j, j + v]
            er = (c2 * P1 + s2 * P3) - (c2 * P4 - s2 * P2)
            ei = (c2 * P2 + s2 * P4) + (c2 * P3 - s2 * P1)
            gr, gi = gr + er, gi + ei
            ga[a] += er
        part[g, 0, :V], part[g, 1, :V], part[g, 2:, :V] = gr, gi, ga
    out = np.full((16, lanes), np.nan, f)
    for t in range(threads):
        for k in range(16 * lanes // threads):
            e = t + k * threads
            row, lane = divmod(e, lanes)
            assert np.isnan(out[row, lane])           # written once
            s = row if row < 2 else (2 + row - 8 if 0 <= row - 8 < sps
                                     else -1)
            val = f(0)
            if s >= 0 and lane <= 2 * hw:
                for g in range(groups):
                    val = f(val + part[g, s, lane])
            if row == 2 and lane == 0:
                gr = gi = f(0)
                for g in range(groups):
                    gr, gi = f(gr + part[g, 0, hw - 1]), f(gi + part[g, 1,
                                                                   hw - 1])
                val = f(np.arctan2(gi, gr))
            out[row, lane] = val
    return out


def test_k11_replay_layout():
    # the source's plan: one block of at most 1,024 threads, row groups
    # of whole load batches, its partial sums within static shared memory
    groups, lanes = _k11_const("kGroups"), _k11_const("kLanes")
    threads, rows = _k11_const("kThreads"), _k11_const("kRows")
    assert threads == groups * lanes <= 1024 and lanes == 128
    assert rows % groups == 0
    assert _k11_const("kGroupRows") % _k11_const("kBatch") == 0
    assert (16 * lanes) % threads == 0
    smem = 4 * (2 * 8 + groups * _k11_const("kSums") * lanes)
    assert smem <= 48 * 1024


@pytest.mark.parametrize("sps", range(1, 9))
@pytest.mark.parametrize("hw", [20, 51, 63])
def test_k11_replay_matches_plain(hw, sps):
    _, _, p13, p24 = _packed(hw, 20 + sps)
    got = _k11_replay(p13, p24, hw, sps)
    want = TPR.panel_reductions_plain(torch.from_numpy(p13),
                                      torch.from_numpy(p24), hw, sps).numpy()
    V = 2 * hw + 1
    scale = float(np.max(np.abs(want[:2, :V])))
    assert np.max(np.abs(got - want)) < TOL * scale
    assert abs(got[2, 0] - want[2, 0]) < TOL_F
