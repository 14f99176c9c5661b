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
from comms_tpu.ops import spectrum as jspec
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
    d = TFB.stage_a_plain(_t(x.real), _t(x.imag), n1, n2)
    X = torch.fft.fft(d, dim=2).transpose(1, 2).reshape(1, -1).numpy()
    assert _relmax(X, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-5
