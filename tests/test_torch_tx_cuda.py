"""The transmit slice on a CUDA card: the threefry known answers, the
card's bits, packed words and fixed-point phase equal to the CPU's over
chained blocks, both transmitters within 1 LSB of the float64 oracle
(under 1% of samples differing) at small shapes, and prn_block against
the bit-serial oracle.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: they hold the card to the CPU.
"""

import numpy as np
import pytest
import torch

from _tx_oracle import lsb_diff, tx_oracle_f64
from comms_tpu_torch.models import bpsk_tx as tb
from comms_tpu_torch.models import qpsk_tx as tq
from comms_tpu_torch.ops import prns as tprns
from comms_tpu_torch.ops import random as trand
from comms_tpu_torch.ops import txshape as ttx

# XLA's erf_inv polynomial through the card's log1p/sqrt vs the CPU's.
ULP_NORMAL = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (holds the card to the CPU)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_threefry_known_answers_on_the_card(cuda):
    cases = [((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0)),
             ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7))]
    for (k1, k2), (x1, x2), want in cases:
        t = [torch.tensor(v, dtype=torch.int64, device=cuda)
             for v in (k1, k2, x1, x2)]
        assert [int(v) for v in trand.threefry2x32(*t)] == list(want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 5])
def test_bits_and_samples_on_the_card_equal_the_cpu(cuda, seed):
    kc, kd = trand.source_init(seed, "cpu"), trand.source_init(seed, cuda)
    for _ in range(5):
        bc, kc = trand.random_bits_packed_block(kc, 4096)
        bd, kd = trand.random_bits_packed_block(kd, 4096)
        assert torch.equal(bd.cpu(), bc)
        ic, kc = trand.random_bits_block(kc, 1000)
        idd, kd = trand.random_bits_block(kd, 1000)
        assert torch.equal(idd.cpu(), ic)
        uc, kc = trand.uniform_block(kc, 1000, -3.5, 2.25)
        ud, kd = trand.uniform_block(kd, 1000, -3.5, 2.25)
        assert torch.equal(ud.cpu(), uc)
        nc, kc = trand.normal_block(kc, 10000)
        nd, kd = trand.normal_block(kd, 10000)
        sp = np.spacing(np.abs(nc.numpy()))
        assert (np.abs(nd.cpu().numpy() - nc.numpy()) <= ULP_NORMAL * sp).all()
    assert torch.equal(kd.cpu(), kc)


def _run(mod, cfg, fast, dev, blocks, seed=3):
    fn = mod.make_block_fn_fast(cfg) if fast else mod.make_block_fn(cfg)
    init = mod.init_state_fast if fast else mod.init_state
    st = init(cfg, seed, dev)
    outs = []
    for _ in range(blocks):
        out, st = fn(st)
        outs.append(out.cpu())
    return outs, st


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_packed_words_and_phase_on_the_card_equal_the_cpu(cuda, kind):
    if kind == "bpsk":
        mod, cfg = tb, tb.BpskTxConfig(syms_per_block=1 << 14)
    else:
        mod, cfg = tq, tq.QpskTxConfig(bits_per_block=1 << 15, dphase=0.01,
                                       phase0=0.6)
    got, sd = _run(mod, cfg, True, cuda, 4)
    want, sc = _run(mod, cfg, True, "cpu", 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert torch.equal(sd[0].cpu(), sc[0]) and torch.equal(sd[1].cpu(), sc[1])
    if kind == "qpsk":
        assert sd[2] == sc[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_pair_path_on_the_card_within_one_lsb_of_the_cpu(cuda, kind):
    if kind == "bpsk":
        mod, cfg = tb, tb.BpskTxConfig()
    else:
        mod, cfg = tq, tq.QpskTxConfig(dphase=0.01, phase0=0.6)
    got, sd = _run(mod, cfg, False, cuda, 3)
    want, sc = _run(mod, cfg, False, "cpu", 3)
    mx, frac = lsb_diff(torch.cat(got).numpy(), torch.cat(want).numpy())
    assert mx <= 1 and frac < 0.01
    assert torch.equal(sd[0].cpu(), sc[0])


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_blocks_on_the_card_match_the_float64_oracle(cuda, kind, fast):
    n, blocks, seed = 4096, 3, 11
    if kind == "bpsk":
        mod, cfg, dph, ph0 = tb, tb.BpskTxConfig(syms_per_block=n), 0.0, 0.0
    else:
        dph, ph0 = 0.01, 0.6
        mod, cfg = tq, tq.QpskTxConfig(bits_per_block=n, dphase=dph,
                                       phase0=ph0)
    outs, _ = _run(mod, cfg, fast, cuda, blocks, seed)
    got = np.concatenate([ttx.unpack_iq(o) if fast else o.numpy()
                          for o in outs])
    draw = (trand.random_bits_packed_block if fast
            else trand.random_bits_block)
    key, bits = trand.source_init(seed, cuda), []
    for _ in range(blocks):
        b, key = draw(key, n)
        bits.append(b.cpu().numpy())
    want = tx_oracle_f64(np.concatenate(bits), kind == "qpsk", dph, ph0)
    mx, frac = lsb_diff(got, want)
    assert mx <= 1 and frac < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("poly,width,block,seed", [
    (0xC0, 8, 256, 0xFF), (0xC000, 16, 200, 0x0001), (0xB8, 8, 4096, 0x5A)])
def test_prn_block_on_the_card_matches_the_host_oracle(cuda, poly, width,
                                                       block, seed):
    spec = tprns.PrnSpec.make(poly, width, block)
    st = spec.init_state(seed, device=cuda)
    got = []
    for _ in range(3):
        bits, st = tprns.prn_block(spec, st)
        assert bits.device.type == "cuda" and bits.dtype == torch.int8
        got.append(bits.cpu().numpy())
    np.testing.assert_array_equal(
        np.concatenate(got), tprns.prn_bits_host(poly, seed, width,
                                                 3 * block))
