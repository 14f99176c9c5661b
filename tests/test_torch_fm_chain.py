"""The fused FM chain: comms_tpu_torch.kernels.fm_chain against the JAX
package's Pallas kernel (run in interpret mode, as its own tests run it
on the CPU).  Here the wrapper runs the plain PyTorch version, because
the tensors lie on the CPU; the kernel itself is compared with the
plain version on the card by tests/test_torch_fm_chain_cuda.py and by
chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import fm_chain_pallas as JK
from comms_tpu.models import fm_receiver as jfm
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import fm_chain as TK
from comms_tpu_torch.models import fm_receiver as tfm

TAPS = jfm.FM_LPF_TAPS
# The JAX kernel's own parity bound against the XLA chain
# (tests/test_fused_chain.py): its stage-1 taps are quantized to ~23
# bits, the port's are float32.  Measured max on the CPU: 4.9e-7 to
# 2.6e-6 over the four cases below.
TOL = 1e-3


def _jax_chain(re, im, ctx):
    return np.asarray(JK.fm_chain_fused(
        jnp.asarray(re), jnp.asarray(im), ctx, TAPS, TAPS, interpret=True))


def _port_chain(re, im, ctx):
    return TK.fm_chain_fused(torch.from_numpy(re), torch.from_numpy(im),
                             tfm.fused_state_from_jax(ctx, device="cpu"), TAPS,
                             TAPS).numpy()


def _mid_stream_ctx(rng):
    tail = rng.integers(0, 256, size=(2, jfm.FUSED_TAIL_SAMPLES),
                        dtype=np.uint8)
    ctx = jfm.fused_ctx_from_raw_tail(jnp.asarray(tail[0]),
                                      jnp.asarray(tail[1]))
    return {k: np.asarray(v, np.float32) for k, v in ctx.items()}


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_plain_matches_jax_kernel(steps, start):
    rng = np.random.default_rng(steps * 10 + (start == "zero"))
    N = steps * TK.IN_PER_STEP
    iq = rng.integers(0, 256, size=(2, N), dtype=np.uint8)
    ctx = ({k: np.asarray(v) for k, v in JK.zero_ctx().items()}
           if start == "zero" else _mid_stream_ctx(rng))
    want = _jax_chain(iq[0], iq[1], ctx)
    launches = TK.launches
    got = _port_chain(iq[0], iq[1], ctx)
    assert TK.launches == launches          # CPU tensors: no kernel
    assert got.shape == want.shape == (N // 25,)
    err = np.max(np.abs(got - want))
    assert err < TOL, f"max abs err {err}"


def test_stream_start_third_quadrant_first_samples():
    # mid[0] = h[0] * x[0] with h[0] < 0, so x[0] in the first quadrant
    # puts mid[0] in the third: d[0] = atan2(+0, -0) = pi, and audio
    # 0..12 (the outputs whose window holds d[0]) carry h2[t] * pi.
    rng = np.random.default_rng(9)
    N = TK.IN_PER_STEP
    iq = rng.integers(0, 256, size=(2, N), dtype=np.uint8)
    iq[:, 0] = 200
    ctx = {k: np.asarray(v) for k, v in JK.zero_ctx().items()}
    want = _jax_chain(iq[0], iq[1], ctx)[:13]
    got = _port_chain(iq[0], iq[1], ctx)[:13]
    assert np.max(np.abs(got - want)) < 1e-5
    # audio[0] = h2[0] * d[0] exactly: d[0] is pi, not 0.
    assert abs(got[0] - np.float32(TAPS[0]) * np.pi) < 1e-6
    assert abs(want[0] - np.float32(TAPS[0]) * np.pi) < 1e-6


def test_wrapper_rejects_bad_operands():
    z = torch.zeros(TK.IN_PER_STEP, dtype=torch.uint8)
    ctx = TK.zero_ctx(device="cpu")
    with pytest.raises(ValueError, match="102400"):
        TK.fm_chain_fused(z[:1000], z[:1000], ctx, TAPS, TAPS)
    with pytest.raises(ValueError, match="uint8"):
        TK.fm_chain_fused(z.float(), z.float(), ctx, TAPS, TAPS)
    with pytest.raises(ValueError, match="xre"):
        TK.fm_chain_fused(z, z, dict(ctx, xre=ctx["xre"][:100]), TAPS, TAPS)
    with pytest.raises(ValueError, match="63 taps"):
        TK.fm_chain_fused(z, z, ctx, TAPS[:31], TAPS)


def test_non_cpu_request_raises_without_fallback(monkeypatch):
    # The plain version runs only for CPU tensors: any other device gets
    # the kernel or an exception, never the plain version.
    def no_plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(TK, "_plain", no_plain)
    z = torch.empty(TK.IN_PER_STEP, dtype=torch.uint8, device="meta")
    ctx = TK.zero_ctx("meta")
    launches = TK.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TK.fm_chain_fused(z, z, ctx, TAPS, TAPS)
    assert TK.launches == launches


def test_cuda_request_without_cuda_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # No CUDA device: asking for one raises instead of running elsewhere.
    with pytest.raises((RuntimeError, AssertionError)):
        tfm.fused_init_state("cuda")
    p = tmp_path / "cap.iq"
    np.zeros((2 * TK.IN_PER_STEP, 2), np.uint8).tofile(p)
    with pytest.raises((RuntimeError, AssertionError)):
        tfm.run_file(p, tfm.FmReceiverConfig(block=TK.IN_PER_STEP),
                     device="cuda")
    # And no compiler: the kernel build raises with a clear message.
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not _build.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()
