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
