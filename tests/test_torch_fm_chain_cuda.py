"""The fused FM kernel against its plain PyTorch version on a CUDA card.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_fm_chain_cuda.py

Without a CUDA device the test skips: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import fm_chain as TK
from comms_tpu_torch.models import fm_receiver as tfm

TAPS = tfm.FM_LPF_TAPS
# White-noise input can put z near the atan2 branch cut, where the two
# summation orders may land on either side; the JAX package's parity
# bound for this chain covers that.
TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_kernel_matches_plain_on_card(start):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(12)
    N = 2 * TK.IN_PER_STEP
    iq = torch.from_numpy(rng.integers(0, 256, size=(4, N),
                                       dtype=np.uint8)).cuda()
    ctx = (TK.zero_ctx("cuda") if start == "zero"
           else tfm.fused_ctx_from_raw_tail(iq[2], iq[3]))
    launches = TK.launches
    got = TK.fm_chain_fused(iq[0], iq[1], ctx, TAPS, TAPS)
    want = TK.fm_chain_plain(iq[0], iq[1], ctx, TAPS, TAPS)
    torch.cuda.synchronize()
    assert TK.launches == launches + 1
    assert got.shape == want.shape == (N // 25,)
    assert torch.isfinite(got).all()
    assert torch.max(torch.abs(got - want)).item() < TOL


def _fm_capture(n: int, seed: int) -> np.ndarray:
    """u8 IQ [2, n] of a station-like capture: a carrier frequency-
    modulated by two tones (phase steps within +-0.25 rad, far from the
    atan2 branch cut), amplitude 100 around 127.5, noise sigma 2."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    ph = np.cumsum(0.05 + 0.12 * np.sin(2 * np.pi * 1.3e-4 * t)
                   + 0.08 * np.sin(2 * np.pi * 3.1e-5 * t + 1.0))
    iq = np.stack([100 * np.cos(ph), 100 * np.sin(ph)]) + 127.5
    iq += rng.normal(scale=2.0, size=iq.shape)
    return np.clip(np.round(iq), 0, 255).astype(np.uint8)


def _planes(signal: str, n: int, seed: int) -> torch.Tensor:
    if signal == "fm_capture":
        iq = _fm_capture(n, seed)
    else:
        iq = np.random.default_rng(seed).integers(0, 256, size=(2, n),
                                                  dtype=np.uint8)
    return torch.from_numpy(iq).cuda()


def _assert_near_plain(got, want, signal):
    """The capture within chip_smoke.py's 1e-4.  White noise within TOL,
    except where a phase step sits at the atan2 branch cut and the two
    summation orders land on either side of it: that moves the up to 13
    audio outputs whose window holds the flipped d by up to 2 pi |h2|.
    At most one such flip is allowed a call."""
    err = torch.abs(got - want)
    if signal == "fm_capture":
        assert err.max().item() < 1e-4
        return
    flip = 2 * np.pi * float(np.max(np.abs(TAPS))) + TOL
    assert int((err > TOL).sum()) <= 13
    assert err.max().item() < flip


@pytest.mark.cuda
@pytest.mark.parametrize("steps,signal", [
    (1, "fm_capture"), (1, "white_noise"), (2, "fm_capture"),
    (2, "white_noise"), (32, "fm_capture"), (32, "white_noise"),
    (256, "fm_capture")])
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_kernel_one_launch_repeatable_and_near_plain(steps, start, signal):
    # 1 and 2 steps take the small tiles, 32 (one shard of the wideband
    # block) and 256 (the block) the big ones.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    N = steps * TK.IN_PER_STEP
    tail = tfm.FUSED_TAIL_SAMPLES
    iq = _planes(signal, tail + N, seed=steps)
    if start == "zero":
        re, im, ctx = iq[0, :N].clone(), iq[1, :N].clone(), TK.zero_ctx()
    else:
        re, im = iq[0, tail:].clone(), iq[1, tail:].clone()
        ctx = tfm.fused_ctx_from_raw_tail(iq[0, :tail], iq[1, :tail])
    launches = TK.launches
    got = TK.fm_chain_fused(re, im, ctx, TAPS, TAPS)
    assert TK.launches == launches + 1
    again = TK.fm_chain_fused(re, im, ctx, TAPS, TAPS)
    assert TK.launches == launches + 2
    want = TK.fm_chain_plain(re, im, ctx, TAPS, TAPS)
    torch.cuda.synchronize()
    assert TK.launches == launches + 2
    assert got.shape == want.shape == (N // 25,)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    _assert_near_plain(got, want, signal)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 16])
def test_unaligned_planes_equal_aligned_copies(offset):
    # Planes that start off a 4-byte boundary are read a byte at a time;
    # the audio is the same, bit for bit.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    N = 2 * TK.IN_PER_STEP
    iq = _planes("fm_capture", offset + N, seed=4)
    view = (iq[0, offset:], iq[1, offset:])
    ctx = TK.zero_ctx()
    got = TK.fm_chain_fused(*view, ctx, TAPS, TAPS)
    want = TK.fm_chain_fused(view[0].clone(), view[1].clone(), ctx, TAPS,
                             TAPS)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
