"""The four-step kernel's entries (K10: the contract of the JAX package's
fft_big_pallas) against that Pallas kernel in interpret mode, at the JAX
tests' 256 x 256 and 256 x 512 sizes and bounds
(tests/test_fft_big_pallas.py: 1e-5 relative for FFTs, the means PSD and
the plain no-window PSD, 2e-5 for the zero-mean sparse demean, 5e-4 for
the sparse demean at a large DC offset).  Here the wrappers run the plain
PyTorch versions, because the tensors lie on the CPU; the stages
themselves are compared with them on the card by
tests/test_torch_fft_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from comms_tpu.kernels import fft_big_pallas as JFB
from comms_tpu.kernels import fft_pallas as JFP
from comms_tpu.ops import spectrum as jspec
from comms_tpu_torch.kernels import fft as TFK
from comms_tpu_torch.kernels import fft_big as TFB


def _relmax(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cx(rng, shape, offset=0.0):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            + offset).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("n", [1 << 16, 1 << 18, 1 << 19, 1 << 20, 1 << 22,
                               1 << 23, 3 * (1 << 16), 1 << 12])
def test_factorize_matches_jax(n):
    assert TFB.factorize(n) == JFB.factorize(n)
    assert TFB.supported_big(n) == JFB.supported_big(n)


def test_factorize_values():
    assert TFB.factorize(1 << 20) == (1024, 1024)
    assert TFB.factorize(1 << 18) == (512, 512)
    assert TFB.supported_big(1 << 16) and TFB.supported_big(1 << 22)
    assert not TFB.supported_big(1 << 23)


def test_fft_big_matches_jax_kernel():
    n1, n2 = 256, 512
    x = _cx(np.random.default_rng(0), (2, n1 * n2))
    jr, ji = JFB.fft_big_pallas_planar(x.real.copy(), x.imag.copy(), n1, n2,
                                       interpret=True)
    yr, yi = TFB.fft_big_planar(_t(x.real), _t(x.imag), n1, n2)
    got = yr.numpy() + 1j * yi.numpy()
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert yr.shape == (2, n1 * n2)
    assert _relmax(got, ref) < 1e-5
    assert _relmax(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-5


@pytest.mark.parametrize("windowed", [True, False])
def test_psd_big_matches_jax_kernel(windowed):
    n1, n2, B = 256, 256, 3
    N = n1 * n2
    x = _cx(np.random.default_rng(1), (B, N), offset=0.5 - 0.25j)
    w = np.hanning(N).astype(np.float32) if windowed else None
    means = (np.stack([x.real.mean(1), x.imag.mean(1)], -1).astype(
        np.float32) if windowed else None)
    want = np.asarray(JFB.psd_big_pallas_planar(
        x.real.copy(), x.imag.copy(), n1, n2, window=w, means=means,
        interpret=True))
    got = TFB.psd_big_planar(_t(x.real), _t(x.imag), n1, n2, window=w,
                             means=means).numpy()
    xm = x.astype(np.complex128)
    if windowed:
        xm = (xm - xm.mean(axis=1, keepdims=True)) * w[None, :]
    ref = (np.abs(np.fft.fft(xm, axis=1)) ** 2).sum(0)
    assert got.shape == (N,)
    assert _relmax(got, ref) < 1e-5
    assert _relmax(got, want) < 1e-5


@pytest.mark.parametrize("offset, bound", [(0.0, 2e-5), (5.0 - 3.0j, 5e-4)])
def test_sparse_demean_matches_jax_kernel(offset, bound):
    n1, n2 = 256, 256
    N = n1 * n2
    x = _cx(np.random.default_rng(10), (2, N), offset=offset)
    w = jspec.hann(N).astype(np.float32)     # periodic: 3-sparse FFT
    ks, _ = TFB.sparse_window_bins(w, n1, n2)
    assert list(ks) == [0, 1, N - 1]
    want = np.asarray(JFB.psd_big_pallas_planar(
        x.real.copy(), x.imag.copy(), n1, n2, window=w, sparse_demean=True,
        interpret=True))
    got = TFB.psd_big_planar(_t(x.real), _t(x.imag), n1, n2, window=w,
                             sparse_demean=True).numpy()
    xm = x.astype(np.complex128)
    xm = xm - xm.mean(axis=1, keepdims=True)
    ref = (np.abs(np.fft.fft(xm * w[None, :], axis=1)) ** 2).sum(0)
    assert _relmax(got, ref) < bound
    assert _relmax(got, want) < bound


def test_validation_errors():
    z = torch.zeros((1, 256 * 256))
    with pytest.raises(ValueError, match="matches none"):
        TFB.psd_big_planar(z, z, 256, 512)
    with pytest.raises(ValueError, match="supported"):
        TFB.fft_big_planar(torch.zeros((1, 128 * 512)),
                           torch.zeros((1, 128 * 512)), 128, 512)
    with pytest.raises(ValueError, match="planar"):
        TFB.fft_big_planar(z.reshape(-1), z.reshape(-1), 256, 256)
    w = np.hanning(256 * 256)
    with pytest.raises(ValueError, match="either means or sparse_demean"):
        TFB.psd_big_planar(z, z, 256, 256, window=w,
                           means=np.zeros((1, 2)), sparse_demean=True)
    with pytest.raises(ValueError, match="requires a window"):
        TFB.psd_big_planar(z, z, 256, 256, sparse_demean=True)
    noise = np.random.default_rng(11).normal(size=256 * 256)
    with pytest.raises(ValueError, match="edge-sparse"):
        TFB.psd_big_planar(z, z, 256, 256, window=noise,
                           sparse_demean=True)
    with pytest.raises(ValueError, match="edge-sparse"):
        JFB.psd_big_pallas_planar(np.zeros((1, 256 * 256), np.float32),
                                  np.zeros((1, 256 * 256), np.float32),
                                  256, 256, window=noise.astype(np.float32),
                                  sparse_demean=True, interpret=True)


@pytest.mark.parametrize("n1, n2", [(4096, 256), (256, 4096), (8192, 512)])
def test_port_rejects_factors_the_stages_do_not_take(n1, n2):
    # The JAX package's _prep admits 4096..16384 (a reference fault,
    # ROADMAP Queue 3); the port raises, and no parity test runs there.
    z = torch.zeros((1, n1 * n2))
    with pytest.raises(ValueError, match="supported"):
        TFB.fft_big_planar(z, z, n1, n2)
    with pytest.raises(ValueError, match="supported"):
        TFB.psd_big_planar(z, z, n1, n2)


def test_3d_and_blocked_ingest_match_2d():
    n1, n2, ct, B = 256, 256, 128, 2
    x = _cx(np.random.default_rng(7), (B, n1, n2))
    x4 = np.transpose(x.reshape(B, n1, n2 // ct, ct), (0, 2, 1, 3))
    w = np.hanning(n1 * n2).astype(np.float32)
    means = np.stack([x.real.mean((1, 2)), x.imag.mean((1, 2))],
                     -1).astype(np.float32)
    flat = TFB.psd_big_planar(_t(x.real.reshape(B, -1)),
                              _t(x.imag.reshape(B, -1)), n1, n2, window=w,
                              means=means).numpy()
    for xs in (x, x4):
        got = TFB.psd_big_planar(_t(xs.real), _t(xs.imag), n1, n2,
                                 window=w, means=means).numpy()
        np.testing.assert_array_equal(got, flat)
    want = np.asarray(JFB.psd_big_pallas_planar(
        x4.real.copy(), x4.imag.copy(), n1, n2, window=w, means=means,
        interpret=True))
    assert _relmax(flat, want) < 1e-5
    fr, fi = TFB.fft_big_planar(_t(x.real), _t(x.imag), n1, n2)
    gr, gi = TFB.fft_big_planar(_t(x4.real), _t(x4.imag), n1, n2)
    np.testing.assert_array_equal(gr.numpy(), fr.numpy())
    np.testing.assert_array_equal(gi.numpy(), fi.numpy())


def test_welch_numerator_matches_jax_across_layouts():
    n1, n2, ct, B = 256, 256, 128, 2
    rng = np.random.default_rng(9)
    re = rng.normal(size=(B, n1 * n2)).astype(np.float32)
    im = rng.normal(size=(B, n1 * n2)).astype(np.float32)
    w = jspec.hann(n1 * n2).astype(np.float32)
    want = np.asarray(JFB.welch_numerator(re, im, w, interpret=True))
    got2 = TFB.welch_numerator(_t(re), _t(im), w).numpy()
    assert _relmax(got2, want) < 2e-5
    shaped = [(re.reshape(B, n1, n2), im.reshape(B, n1, n2))]
    shaped.append(tuple(np.transpose(p.reshape(B, n1, n2 // ct, ct),
                                     (0, 2, 1, 3)) for p in shaped[0]))
    for r, i in shaped:
        got = TFB.welch_numerator(_t(r), _t(i), w).numpy()
        assert np.max(np.abs(got - got2)) < 1e-5 * got2.max()
    with pytest.raises(ValueError, match="two-factor"):
        TFB.welch_numerator(torch.zeros((1, 3 << 16)),
                            torch.zeros((1, 3 << 16)), None)


def test_stage_a_plain_composes_to_the_fft():
    # Stage A's plain version followed by the row FFTs in natural order is
    # the N-point FFT (the reference the stage is held to on the card).
    n1, n2 = 256, 256
    x = _cx(np.random.default_rng(12), (1, n1 * n2))
    d = TFB.d_rows(TFB.stage_a_plain(_t(x.real), _t(x.imag), n1, n2), n1,
                   n2)
    X = torch.fft.fft(d, dim=2).transpose(1, 2).reshape(1, -1).numpy()
    assert _relmax(X, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-5


@pytest.mark.parametrize("n1, n2", [(256, 512), (1024, 256), (2048, 256)])
def test_stage_a_layout_and_sums_contract(n1, n2):
    # D is tile-blocked [b, n2/ct, n1, ct] with ct = _col_tile(n1); the
    # sparse-demean sums are [b, n2/ct, 2] and add up to each segment's
    # sum (psd_big_planar's sums.sum(dim=1)).
    b = 2
    x = _cx(np.random.default_rng(n1 + n2), (b, n1 * n2), offset=0.3)
    ct = TFB._col_tile(n1)
    dr, di, sums = TFB.stage_a(_t(x.real), _t(x.imag), n1, n2,
                               emit_sums=True)
    assert ct * n1 in (8192, 16384) and n2 % ct == 0
    assert dr.shape == di.shape == (b, n2 // ct, n1, ct)
    assert sums.shape == (b, n2 // ct, 2)
    tot = sums.sum(dim=1).numpy()
    want = np.stack([x.real.sum(1), x.imag.sum(1)], -1)
    assert np.max(np.abs(tot - want)) < 1e-6 * n1 * n2
    d = torch.complex(dr, di)
    rows = TFB.d_rows(d, n1, n2)
    assert torch.equal(rows[:, :, :ct], d[:, 0])
    col = np.fft.fft(x.astype(np.complex128).reshape(b, n1, n2), axis=1)
    k1, i2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    col = col * np.exp(-2j * np.pi * ((k1 * i2) % (n1 * n2)) / (n1 * n2))
    assert _relmax(rows.numpy(), col) < 1e-5


# ---- a host copy of the register FFT's plan (csrc/fft_reg.cuh) and of
# the lane maps of its callers, fft_big.cu (K10), fft.cu (K6) and psd.cu
# (K7), kept by hand beside the C++: what the CPU can check of the
# kernels' index arithmetic and summation order.

_POINTS = 16       # fft_reg.cuh kPoints
_PAD_SHIFT = 4     # fft_reg.cuh kPadShift
_REG_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)


def reg_fft_plan(n: int):
    """``[(radix, Ns), ...]``: the passes of fft_reg.cuh's ``fft_reg``
    (the plan in its header) for an n-point transform: radix 16 while 16
    or more points remain per sub-transform, then the rest (none at 256
    and 4096); Ns the product of the earlier radices."""
    assert n in _REG_SIZES
    plan, ns = [], 1
    while ns < n:
        r = min(16, n // ns)
        plan.append((r, ns))
        ns *= r
    return plan


def _pad(a):
    """fft_reg.cuh ``pad``."""
    return a + (a >> _PAD_SHIFT)


def k6_threads(n: int) -> int:
    """fft.cu ``block_threads``: max(128, n / 16) threads a block."""
    return max(128, n // _POINTS)


def k7_threads(n: int) -> int:
    """psd.cu ``block_threads``: max(kMinThreads, n / 16) threads a
    block, kMinThreads = kernels/fft._PSD_MIN_THREADS."""
    return max(TFK._PSD_MIN_THREADS, n // _POINTS)


def exchange_ld(n: int, stage: str, threads: int) -> int:
    """Stride in float2 between two transforms' exchange regions in a
    block of ``threads``: stage ``"a"`` (lanes over columns, fft_big.cu
    ``a_ld``), ``"b"`` (16 lanes over one row's points, ``b_ld``), ``"k6"``
    (fft.cu: consecutive lanes over one row's points) or ``"k7"`` (psd.cu:
    consecutive lanes over one segment's points)."""
    if stage == "a":
        ct = threads * _POINTS // n
        return _pad(n) + 16 // min(ct, 16)
    return _pad(n)


def _lane_map(n: int, stage: str, threads: int):
    """Each thread's (region, t) as the kernels assign them
    (``stage_a_kernel``'s c, t; ``RowLanes``' r, t; ``fft_rows_kernel``'s
    and ``psd_partial_kernel``'s r or g, t)."""
    tid = np.arange(threads)
    T = n // _POINTS
    if stage == "a":
        ct = threads // T
        return tid % ct, tid // ct
    if stage in ("k6", "k7"):
        return tid // T, tid % T
    rows = threads // T
    return (tid >> 4) % rows, (tid & 15) + 16 * (tid // (16 * rows))


def _exchange_addresses(n: int, t):
    """Per exchange of fft_reg.cuh (``exchange``): the padded in-region
    addresses of each store instruction and of each load, as two arrays
    [instr, threads]."""
    T = n // _POINTS
    out = []
    for R, ns in reg_fft_plan(n)[:-1]:
        M = _POINTS // R
        stores = []
        for m in range(M):
            j = t + m * T
            o = (j // ns) * ns * R + j % ns
            stores += [_pad(o + r * ns) for r in range(R)]
        loads = [_pad(t + T * q) for q in range(_POINTS)]
        out.append((np.stack(stores), np.stack(loads)))
    return out


def exchange_bank_ways(n: int, stage: str, threads: int) -> int:
    """The most distinct 8-byte float2 that one half-warp's store or load
    of an exchange puts into one pair of the 32 shared-memory banks (16
    pairs), over every warp of a block of ``threads`` (1 means
    conflict-free: a warp's 8-byte access is served as two half-warps)."""
    region, t = _lane_map(n, stage, threads)
    base = region * exchange_ld(n, stage, threads)
    worst = 1
    for stores, loads in _exchange_addresses(n, t):
        for instr in np.concatenate([stores, loads]):
            for half in (base + instr).reshape(-1, 16):
                words = np.unique(half)
                worst = max(worst, int(np.bincount(words % 16).max()))
    return worst


def _pass_twiddles(n, R, ns, t, table, powers):
    """The twiddles [T, M, R] that thread t applies to input r of its
    butterfly m in a pass of fft_reg.cuh's ``pass``: the table entry
    (j mod Ns) r N / (Ns R) each, or with ``powers`` (K6's kPowers) the
    running products of one entry (one butterfly a thread) and, in the
    last pass, the entry t r times the constant W_16^{m r}."""
    T, M = n // _POINTS, _POINTS // R
    m, r = torch.arange(M), torch.arange(R)
    j = t[:, None] + m[None, :] * T                              # [T, M]
    unit = n // (ns * R)
    if not powers or ns == 1:
        return table[((j % ns) * unit)[:, :, None] * r]
    if M == 1:
        w = table[(t % ns) * unit]
        out = torch.ones((len(t), 1, R), dtype=table.dtype)
        p = w.clone()
        for k in range(1, R):
            out[:, 0, k] = p
            p = p * w
        return out
    assert ns * R == n and int((t[-1] * (R - 1))) < n
    w16 = torch.from_numpy(np.exp((-2j * np.pi / 16) * (np.outer(
        np.arange(M), np.arange(R)) % 16)).astype(np.complex64))
    return table[t[:, None] * r[None, :]][:, None, :] * w16[None]


def reg_fft_replay(x: torch.Tensor, powers: bool = False) -> torch.Tensor:
    """Run fft_reg.cuh's plan on complex [b, n] with torch: each thread t's
    points t + T q, each pass's twiddles from the float32 W_n^k table at
    the kernel's integer indices (``pass``; with ``powers``, K6's
    kPowers), its radix-R DFTs, and the exchanges through a padded buffer
    at the Stockham positions (``exchange``; the last pass in natural
    order, ``natural``).  Returns the natural-order outputs."""
    b, n = x.shape
    T = n // _POINTS
    t = torch.arange(T)
    slots = t[:, None] + T * torch.arange(_POINTS)[None, :]      # [T, 16]
    table = torch.from_numpy(np.exp((-2j * np.pi / n) * np.arange(n))
                             .astype(np.complex64))
    v = x[:, slots]                                              # [b, T, 16]
    plan = reg_fft_plan(n)
    for p, (R, ns) in enumerate(plan):
        M = _POINTS // R
        m = torch.arange(M)
        r = torch.arange(R)
        pos = m[:, None] + r[None, :] * M                        # [M, R]
        j = t[:, None] + m[None, :] * T                          # [T, M]
        u = v[:, :, pos] * _pass_twiddles(n, R, ns, t, table, powers)
        F = torch.from_numpy(np.exp((-2j * np.pi / R) * np.outer(
            np.arange(R), np.arange(R))).astype(np.complex64))
        y = u @ F.T                                              # output r
        if p == len(plan) - 1:
            v = torch.empty_like(v)
            v[:, :, pos] = y
            break
        addr = ((j // ns) * ns * R + j % ns)[:, :, None] + r * ns
        buf = torch.zeros((b, _pad(n)), dtype=x.dtype)
        a = _pad(addr).reshape(-1)
        assert len(torch.unique(a)) == n, "exchange positions collide"
        buf[:, a] = y.reshape(b, -1)
        v = buf[:, _pad(slots)]
    X = torch.empty_like(x)
    X[:, slots] = v
    return X


@pytest.mark.parametrize("n", _REG_SIZES)
def test_register_fft_plan_replays_to_the_fft(n):
    # fft_reg.cuh's pass plan, twiddle indices and padded exchanges, run
    # with torch on the CPU, give the n-point FFT.
    plan = reg_fft_plan(n)
    want = {256: [16, 16], 4096: [16, 16, 16]}.get(
        n, [16, 16, n // 256] if n < 4096 else [16, 16, 16, n // 4096])
    assert [r for r, _ in plan] == want
    assert int(np.prod([r for r, _ in plan])) == n
    # every twiddle index is an integer below n
    assert all((ns - 1) * (R - 1) * (n // (ns * R)) < n for R, ns in plan)
    x = _cx(np.random.default_rng(n), (3, n))
    got = reg_fft_replay(torch.from_numpy(x)).numpy()
    assert _relmax(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-5


@pytest.mark.parametrize("n", _REG_SIZES)
def test_k6_twiddle_powers_replay_to_the_fft(n):
    # K6's twiddles (fft_reg.cuh kPowers: powers of one table entry per
    # butterfly, the last pass's entries t r times W_16^{m r}) in complex64
    # give the n-point FFT, and agree with the table twiddles' replay.
    x = _cx(np.random.default_rng(n + 1), (3, n))
    got = reg_fft_replay(torch.from_numpy(x), powers=True).numpy()
    assert _relmax(got, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-5
    table = reg_fft_replay(torch.from_numpy(x)).numpy()
    assert _relmax(got, table) < 1e-5


@pytest.mark.parametrize("stage", ["a", "b"])
@pytest.mark.parametrize("threads", [512, 1024])
@pytest.mark.parametrize("n", [256, 512, 1024, 2048])
def test_register_fft_exchange_is_bank_conflict_free(n, threads, stage):
    # Every warp's store and load of every exchange, with fft_big.cu's
    # lane maps and region strides, hits each shared-memory bank once.
    assert exchange_bank_ways(n, stage, threads) == 1


@pytest.mark.parametrize("n", _REG_SIZES)
def test_k6_exchange_is_bank_conflict_free(n):
    # K6 (fft.cu): consecutive lanes on consecutive points of one row
    # (two rows a warp at 256 points), regions pad(n) apart, in blocks of
    # max(128, n / 16) threads; every exchange of the 256..16384 plans.
    threads = k6_threads(n)
    assert threads * _POINTS % n == 0 and threads <= 1024
    assert exchange_bank_ways(n, "k6", threads) == 1
    # the exchange regions of a block fit the 227 KB an SM's block may take
    rows = threads * _POINTS // n
    assert rows * exchange_ld(n, "k6", threads) * 8 <= 227 * 1024


@pytest.mark.parametrize("n1, n2", [(512, 256), (256, 1024)])
def test_stage_b_entries_on_stage_a_compose_to_the_entries(n1, n2):
    # fft_stage_b / psd_stage_b on a D made beforehand (the stage B timed
    # alone on the card) give the FFT and PSD entries' results.
    b, N = 2, n1 * n2
    x = _cx(np.random.default_rng(n1 + 3 * n2), (b, N), offset=0.2)
    re, im = _t(x.real), _t(x.imag)
    d, _ = TFB._stage_a_d(re, im, n1, n2)
    dr, di, _ = TFB.stage_a(re, im, n1, n2)
    assert torch.equal(torch.complex(dr, di), torch.view_as_complex(d))
    yr, yi = TFB.fft_stage_b(d, n1, n2)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert _relmax(yr.numpy() + 1j * yi.numpy(), ref) < 1e-5
    assert _relmax(TFB.psd_stage_b(d, n1, n2).numpy(),
                   (np.abs(ref) ** 2).sum(0)) < 1e-5
    w = jspec.hann(N).astype(np.float32)
    d, sums = TFB._stage_a_d(re, im, n1, n2, window=w, emit_sums=True)
    got = TFB.psd_stage_b(d, n1, n2, TFB.sparse_window_bins(w, n1, n2), sums)
    want = TFB.psd_big_plain(re, im, n1, n2, w, sparse_demean=True)
    assert _relmax(got.numpy(), want.numpy()) < 2e-5


@pytest.mark.parametrize("entry", ["fft", "psd"])
def test_stage_b_entries_reject_d_in_another_layout(entry):
    # The stage B entries take only stage A's tile-blocked float32 (re, im)
    # pairs: D as rows [b, n1, n2], complex, or split planes raise.
    n1, n2 = 1024, 256
    x = _cx(np.random.default_rng(5), (1, n1 * n2))
    d, sums = TFB._stage_a_d(_t(x.real), _t(x.imag), n1, n2, emit_sums=True)
    call = {"fft": lambda dd: TFB.fft_stage_b(dd, n1, n2),
            "psd": lambda dd: TFB.psd_stage_b(dd, n1, n2)}[entry]
    rows = torch.view_as_real(TFB.d_rows(torch.view_as_complex(d), n1, n2))
    for bad in (rows, torch.view_as_complex(d), d[..., 0], d.double(),
                d.transpose(1, 2)):
        with pytest.raises(ValueError, match="stage A's D"):
            call(bad)
    with pytest.raises(ValueError, match="supported"):
        TFB.fft_stage_b(d, n1, 4096)
    if entry == "psd":
        w = jspec.hann(n1 * n2)
        with pytest.raises(ValueError, match="sums"):
            TFB.psd_stage_b(d, n1, n2, TFB.sparse_window_bins(w, n1, n2),
                            sums[:, :1])


# ---- K7 (csrc/psd.cu): its lane map, its carry and a torch replay of
# its summation order

_REDUCE_GROUPS = 32      # psd.cu kReduceGroups


def k7_smem_bytes(n: int) -> int:
    """psd.cu ``smem_bytes`` at its defaults (kRegs = 128): the groups'
    exchange regions, the demean's warp sums and, where one block leaves
    64 registers a thread (1024 threads at 16384 points), the sums' 16
    slots a thread."""
    threads = k7_threads(n)
    groups = threads * _POINTS // n
    sums = _POINTS * threads if 65536 // threads <= 64 else 0
    return 8 * groups * _pad(n) + 4 * (2 * (threads // 32) + sums)


def k7_replay(re, im, win, n, stride, rows, row_weights=None, demean=True):
    """psd.cu's arithmetic in its order, with torch on float32 planes:
    segment s at s * stride of the flat planes, thread t holding its
    points t + T q; the row weight, then the mean as the kernel sums it
    (each thread's 16 points in order, the xor tree over min(T, 32) lanes,
    a segment's warps in order), subtracted before the window; the
    register FFT's plan with K6's twiddles (``reg_fft_replay``); |X|^2
    summed over each run in segment order, a block's runs in group order,
    the partial rows in _REDUCE_GROUPS contiguous ranges, each in order,
    then the ranges in order (runs and blocks from ``psd_partition``).
    Returns acc[n] float32."""
    T = n // _POINTS
    per_run, blocks = TFK.psd_partition(rows, n)
    G = k7_threads(n) // T
    idx = torch.arange(rows)[:, None] * stride + torch.arange(n)[None, :]
    xr, xi = re.reshape(-1)[idx], im.reshape(-1)[idx]
    if row_weights is not None:
        xr = xr * row_weights[:, None]
        xi = xi * row_weights[:, None]
    if demean:
        def mean(v):
            v = v.reshape(rows, _POINTS, T)           # [s, q, t]
            s = torch.zeros(rows, T)
            for q in range(_POINTS):
                s = s + v[:, q]
            o = min(T, 32) // 2
            while o:
                s = s + s[:, torch.arange(T) ^ o]
                o //= 2
            tot = torch.zeros(rows)
            for k in range(max(1, T // 32)):
                tot = tot + s[:, 32 * k]
            return tot * (1.0 / n)
        xr = xr - mean(xr)[:, None]
        xi = xi - mean(xi)[:, None]
    X = reg_fft_replay(torch.complex(xr * win, xi * win), powers=True)
    e = X.real * X.real + X.imag * X.imag
    runs = blocks * G
    acc = torch.zeros(runs, n)
    for i in range(per_run):
        seg = torch.arange(runs) * per_run + i
        ok = (seg < rows)[:, None]
        acc = acc + torch.where(ok, e[seg.clamp(max=rows - 1)], 0.0)
    part = torch.zeros(blocks, n)
    for k in range(G):
        part = part + acc.reshape(blocks, G, n)[:, k]
    per = -(-blocks // _REDUCE_GROUPS)
    out = torch.zeros(n)
    for y in range(_REDUCE_GROUPS):
        s = torch.zeros(n)
        for g in range(y * per, min(y * per + per, blocks)):
            s = s + part[g]
        out = out + s
    return out


def _welch64(x, n, w, stride, weights=None, demean=True):
    """float64 sum over the segments at ``stride`` of |FFT(w (x - m))|^2."""
    idx = (np.arange(0, len(x) - n + 1, stride)[:, None]
           + np.arange(n)[None, :])
    seg = x.astype(np.complex128)[idx]
    if weights is not None:
        seg = seg * weights[:, None]
    if demean:
        seg = seg - seg.mean(axis=1, keepdims=True)
    return (np.abs(np.fft.fft(seg * w, axis=1)) ** 2).sum(0)


@pytest.mark.parametrize("n", _REG_SIZES)
def test_k7_carry_identity(n):
    # At stride n/2 thread t's points q + 8 of segment s are its points q
    # of segment s + 1 (psd.cu's carry), and a run's loads (16 a plane for
    # its first segment, the 8 new ones for each later segment) read each
    # sample of the run once.
    T = n // _POINTS
    t, q = np.arange(T)[:, None], np.arange(_POINTS)[None, :]

    def points(s):
        return s * (n // 2) + t + T * q

    for s in (0, 1, 7):
        np.testing.assert_array_equal(points(s)[:, 8:], points(s + 1)[:, :8])
    s0, run = 3, 8
    loads = np.concatenate([points(s0).ravel()] + [
        points(s)[:, 8:].ravel() for s in range(s0 + 1, s0 + run)])
    np.testing.assert_array_equal(
        np.sort(loads), np.arange(s0 * n // 2, (s0 + run + 1) * n // 2))


@pytest.mark.parametrize("n", _REG_SIZES)
def test_k7_exchange_is_bank_conflict_free(n):
    # K7 (psd.cu): consecutive lanes on consecutive points of one segment
    # (two segments a warp at 256 points), regions pad(n) apart, blocks of
    # max(128, n / 16) threads; every exchange of the 256..16384 plans is
    # conflict-free, and the block's shared memory fits.
    threads = k7_threads(n)
    assert threads * _POINTS % n == 0 and threads <= 1024
    assert exchange_bank_ways(n, "k7", threads) == 1
    assert k7_smem_bytes(n) <= 227 * 1024


@pytest.mark.parametrize("n", _REG_SIZES)
def test_k7_partition_covers_every_segment_once(n):
    # psd_partition: runs of per_run consecutive segments, G runs a block,
    # no empty block; at the main path's 16,777,216 samples every size
    # has runs of 8 segments or more, and the runs hold more than half
    # of _PSD_RUN_THREADS threads.
    G = k7_threads(n) * _POINTS // n
    for rows in (1, 2, 255, 2 * (1 << 24) // n - 1):
        per_run, blocks = TFK.psd_partition(rows, n)
        runs = -(-rows // per_run)
        assert runs * per_run >= rows > (runs - 1) * per_run
        assert blocks == -(-runs // G)
        assert (blocks - 1) * G * per_run < rows
    assert per_run >= 8
    assert 2 * runs * (n // _POINTS) > TFK._PSD_RUN_THREADS


@pytest.mark.parametrize("n, run_threads", [(256, None), (1024, None),
                                            (1024, 1 << 10)])
def test_k7_replay_matches_jax_stream_kernel(n, run_threads, monkeypatch):
    # The kernel's summation order at stride n/2 (with the package's
    # partition, and with runs of 16 segments) against the JAX stream
    # kernel in interpret mode and a float64 oracle.
    if run_threads:
        monkeypatch.setattr(TFK, "_PSD_RUN_THREADS", run_threads)
        monkeypatch.setattr(TFK, "_PSD_MIN_BLOCKS", 1)
    N = TFK.rows_per_step(n) * n
    rng = np.random.default_rng(n + 3)
    x = _cx(rng, (N,), offset=0.3 - 0.2j)
    w = jspec.hann(n).astype(np.float32)
    want = np.asarray(JFP.psd_stream_pallas_planar(
        x.real.copy(), x.imag.copy(), w, n=n, interpret=True))
    got = k7_replay(_t(x.real), _t(x.imag), torch.from_numpy(w), n, n // 2,
                    2 * N // n - 1).numpy()
    assert _relmax(got, _welch64(x, n, w, n // 2)) < 2e-5
    assert _relmax(got, want) < 2e-5
    port = TFK.psd_stream_planar(_t(x.real), _t(x.imag), w, n).numpy()
    assert _relmax(got, port) < 2e-5


@pytest.mark.parametrize("n, weighted, demean", [(256, True, True),
                                                 (1024, True, False),
                                                 (1024, False, True)])
def test_k7_replay_matches_jax_rows_kernel(n, weighted, demean):
    # Segment rows at stride n (no carry), with and without row weights
    # and demean, against the JAX row kernel in interpret mode.
    rows = 37 if n == 256 else 9
    rng = np.random.default_rng(n + rows)
    x = _cx(rng, (rows, n), offset=0.3 - 0.2j)
    w = jspec.hann(n).astype(np.float32)
    wts = (np.resize(np.array([1, 0, 1, 1], np.float32), rows)
           if weighted else None)
    want = np.asarray(JFP.psd_pallas_planar(
        x.real.copy(), x.imag.copy(), w, n=n, row_weights=wts,
        demean=demean, interpret=True))
    got = k7_replay(_t(x.real), _t(x.imag), torch.from_numpy(w), n, n, rows,
                    None if wts is None else torch.from_numpy(wts),
                    demean).numpy()
    ref = _welch64(x.reshape(-1), n, w, n, wts, demean)
    assert _relmax(got, ref) < 2e-5
    assert _relmax(got, want) < 2e-5
