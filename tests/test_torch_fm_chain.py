"""The fused FM chain: comms_tpu_torch.kernels.fm_chain against the JAX
package's Pallas kernel (run in interpret mode, as its own tests run it
on the CPU).  Here the wrapper runs the plain PyTorch version, because
the tensors lie on the CPU; the kernel itself is compared with the
plain version on the card by tests/test_torch_fm_chain_cuda.py and by
chip_smoke.py.  ``k1_replay`` replays the kernel's tiling and its
register-blocked windows (csrc/fm_chain.cu) in numpy, so that their
index algebra is held to the JAX kernel here, before any card runs it."""

import functools
import re
from fractions import Fraction

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import fm_chain_pallas as JK
from comms_tpu.models import fm_receiver as jfm
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import fm_chain as TK
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.ops import demodulation

TAPS = jfm.FM_LPF_TAPS
# The JAX kernel's own parity bound against the XLA chain
# (tests/test_fused_chain.py): its stage-1 taps are quantized to ~23
# bits, the port's are float32.  Measured max on the CPU: 4.9e-7 to
# 2.6e-6 over the four cases below.
TOL = 1e-3


def _jax_chain(re, im, ctx):
    return np.asarray(JK.fm_chain_fused(
        jnp.asarray(re), jnp.asarray(im), ctx, TAPS, TAPS, interpret=True))


@functools.lru_cache(maxsize=None)
def _case(steps, start):
    """The white-noise planes, the context (numpy) and the JAX kernel's
    audio of one case, made once per file."""
    rng = np.random.default_rng(steps * 10 + (start == "zero"))
    N = steps * TK.IN_PER_STEP
    iq = rng.integers(0, 256, size=(2, N), dtype=np.uint8)
    ctx = ({k: np.asarray(v) for k, v in JK.zero_ctx().items()}
           if start == "zero" else _mid_stream_ctx(rng))
    return iq, ctx, _jax_chain(iq[0], iq[1], ctx)


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
    N = steps * TK.IN_PER_STEP
    iq, ctx, want = _case(steps, start)
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


# ---- K1's tiling (csrc/fm_chain.cu), replayed in numpy float32

_SRC = (_build.CSRC_DIR / "fm_chain.cu").read_text()


def _tile_shapes():
    """{name: (A, R1, R2)} of the kernel's tile shapes and the tile count
    below which it takes the small one, read from the source."""
    shapes = {m[0]: tuple(int(v) for v in m[1:4]) for m in re.findall(
        r"using (\w+) = Tile<(\d+), (\d+), (\d+), \d+>;", _SRC)}
    below = int(re.search(r"kSmallTilesBelow = (\d+);", _SRC)[1])
    return shapes, below


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even, exactly."""
    f = np.float32(float(x))
    cands = (f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(c.view(np.int32)) & 1))


@functools.lru_cache(maxsize=None)
def byte_conversion() -> np.ndarray:
    """The kernel's ``convert_byte`` for u = 0..255, each operation
    rounded exactly: a2 = 2u - 255, h = rn(1/127.5) / 2, q0 = a2 h, then
    fma(fma(-q0, 255, a2), h, q0)."""
    h = Fraction(float(_rn32(Fraction(2, 255)))) / 2
    out = []
    for u in range(256):
        a2 = Fraction(2 * u - 255)
        q0 = Fraction(float(_rn32(a2 * h)))
        r2 = Fraction(float(_rn32(a2 - 255 * q0)))
        out.append(_rn32(r2 * h + q0))
    return np.array(out, np.float32)


def _fmaf(a, b, c):
    """fmaf emulated in float64, rounded to float32."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _fir_windows(B, base, taps, R):
    """fir_window<R>: acc[.., g, r] = sum_t taps[t] * v[5 r - t] over the
    rotating windows, v = B[:, base[g] + ...] (B: [tiles, shared])."""
    taps = np.asarray(taps, np.float32)
    acc = np.zeros(B.shape[:1] + base.shape + (R,), np.float32)
    w = {}
    for t in range(63):
        q, p = divmod(t, 5)
        if q == 0:
            for k in range(R):
                w[p, k] = B[:, base + 5 * k - p]
        else:
            w[p, -q] = B[:, base - 5 * q - p]
        for r in range(R):
            acc[..., r] = _fmaf(taps[t], w[p, r - q], acc[..., r])
    return acc


def k1_replay(re_u8, im_u8, ctx, h1, h2, shape=None):
    """The kernel's function, indexed as fm_chain.cu indexes it: the tile
    shape it picks for N, each tile's 16-byte aligned x window with its
    context and zero chunks, the byte conversion, stage 1 in windows of
    R1 mids, the demod over the padded d range and stage 2 in windows of
    R2 outputs.  numpy float32, fmaf in float64; the atan2 is the plain
    version's ``fast_atan2``.  ``shape`` ("kBig" or "kSmall") replays
    that tile shape instead of the kernel's pick."""
    shapes, below = _tile_shapes()
    N = re_u8.shape[0]
    n_audio = N // 25
    if shape is None:
        shape = "kBig" if n_audio // shapes["kBig"][0] >= below else "kSmall"
    A, R1, R2 = shapes[shape]
    kD = 5 * (A - 1) + 63
    kG1 = -(-(kD + 1) // R1)
    kMidP = kG1 * R1
    kXL = -(-(5 * kMidP + 65) // 16) * 16
    kG2 = -(-A // R2)
    kDP = 5 * kG2 * R2 + 58
    tiles = n_audio // A
    f0 = np.arange(tiles, dtype=np.int64)[:, None] * A
    d0 = 5 * f0 - 62
    m0 = d0 - 1
    xa = 5 * m0 - 69
    assert np.all(xa % 16 == 0)
    n = xa + np.arange(kXL)                       # [tiles, kXL]
    tab = byte_conversion()
    inside, before = (n >= 0) & (n < N), n < 0
    # a 4-sample chunk lies wholly inside [0, N) or wholly outside
    chunk = inside.reshape(tiles, -1, 4)
    assert np.all(chunk.all(-1) | ~chunk.any(-1))
    mids = []
    for plane, key in ((re_u8, "xre"), (im_u8, "xim")):
        x = np.zeros(n.shape, np.float32)
        x[inside] = tab[plane[n[inside]]]
        raw = np.asarray(ctx[key], np.float32)[20480 + n[before]]
        x[before] = (raw - np.float32(127.5)) / np.float32(127.5)
        acc = _fir_windows(x, 5 * R1 * np.arange(kG1) + 69, h1, R1)
        mid = acc.reshape(tiles, kMidP)
        m = m0 + np.arange(kMidP)
        mid = np.where(m < -1, np.float32(0), mid)
        mids.append(np.where(m == -1, np.float32(ctx["prev"][len(mids)]),
                             mid))
    mr, mi = mids[0][:, 1:kD + 1], mids[1][:, 1:kD + 1]
    lr, li = mids[0][:, :kD], mids[1][:, :kD]
    zre = mr * lr + mi * li
    zim = mi * lr - mr * li
    d = demodulation.fast_atan2(torch.from_numpy(zim),
                                torch.from_numpy(zre)).numpy()
    j = d0 + np.arange(kD)
    d = np.where(j >= 0, d, np.asarray(ctx["d"], np.float32)[
        np.clip(5120 + j, 0, 5119)])
    d = np.concatenate([d, np.zeros((tiles, kDP - kD), np.float32)], 1)
    acc = _fir_windows(d, 5 * R2 * np.arange(kG2) + 62, h2, R2)
    return acc.reshape(tiles, kG2 * R2)[:, :A].reshape(-1)


def test_byte_conversion_equals_division_for_every_byte():
    # The kernel converts a byte without the division; for each of the
    # 256 values it gives the IEEE quotient (u - 127.5f) / 127.5f, which
    # is the plain version's conversion, bit for bit.
    conv = byte_conversion()
    div = ((np.arange(256, dtype=np.float32) - np.float32(127.5))
           / np.float32(127.5))
    u8 = torch.arange(256, dtype=torch.uint8)
    assert np.array_equal(conv.view(np.int32), div.view(np.int32))
    assert np.array_equal(conv.view(np.int32),
                          TK._convert(u8).numpy().view(np.int32))
    assert conv[0] == -1 and conv[255] == 1 and np.all(np.diff(conv) > 0)
    # the reciprocal alone is not enough: it misses most bytes
    inv = np.float32(1) / np.float32(127.5)
    assert np.sum((np.arange(256, dtype=np.float32) - np.float32(127.5))
                  * inv != div) > 100


@pytest.mark.parametrize("shape", ["kBig", "kSmall"])
@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_k1_replay_matches_jax_kernel_and_plain(steps, start, shape):
    iq, ctx, want = _case(steps, start)
    got = k1_replay(iq[0], iq[1], ctx, TAPS, TAPS, shape)
    plain = _port_chain(iq[0], iq[1], ctx)
    assert got.shape == want.shape == (steps * TK.IN_PER_STEP // 25,)
    assert np.max(np.abs(got - want)) < TOL
    assert np.max(np.abs(got - plain)) < 1e-4


def test_k1_replay_tile_shapes():
    # Both tile shapes hold their windows inside shared memory, the big
    # one is taken at the full wideband block and at one of its 8 shards,
    # the small one at the block quantum, and a call needs whole big
    # tiles.
    shapes, below = _tile_shapes()
    assert set(shapes) == {"kBig", "kSmall"}
    assert TK.IN_PER_STEP // 25 % shapes["kBig"][0] == 0
    assert 3_276_800 // 25 // shapes["kBig"][0] >= below
    assert TK.IN_PER_STEP // 25 // shapes["kBig"][0] < below
    for A, R1, R2 in shapes.values():
        assert A % 16 == 0 and R1 % 2 == 1 and R2 % 2 == 1
        kG1 = -(-(5 * A + 59) // R1)
        # the last x index read is within the window, the first >= 0
        assert 5 * R1 * (kG1 - 1) + 69 + 5 * (R1 - 1) < 5 * kG1 * R1 + 65
        assert 69 - 5 * 12 - 2 >= 0
