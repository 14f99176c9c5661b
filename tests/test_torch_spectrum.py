"""comms_tpu_torch.ops.spectrum against comms_tpu.ops.spectrum on the same
numpy inputs: Welch PSD on the tensor route and on the kernel routes (K7's
segment rows, K10's Welch numerator at a big nperseg), onesided real
input, a non-dividing overlap, a tensor window, the plane-native serving
entry and the spectrogram.  Bounds are the JAX tests' (tests/
test_fft_pallas.py, tests/test_fft_big_pallas.py: 1e-4 between Welch
routes, 2e-5 on the big route, 1e-4 for the spectrogram).  On CPU tensors
the kernel routes run the kernels' plain versions; JAX runs its Pallas
kernels in interpret mode."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import spectrum as jspec
from comms_tpu_torch.kernels import fft as TFK
from comms_tpu_torch.kernels import fft_big as TFB
from comms_tpu_torch.ops import spectrum as tspec


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cx(rng, n):
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_welch_psd_matches_jax_on_both_routes(use_kernel):
    x = _cx(np.random.default_rng(4), 1 << 14)
    f_j, p_j = jspec.welch_psd(jnp.asarray(x), nperseg=1024,
                               use_pallas=use_kernel, interpret=True)
    f_t, p_t = tspec.welch_psd(torch.from_numpy(x), nperseg=1024,
                               use_kernel=use_kernel)
    np.testing.assert_array_equal(f_t, f_j)
    assert p_t.dtype == torch.float32 and p_t.shape == (1024,)
    assert _rel(p_t.numpy(), p_j) < 1e-4


def test_welch_psd_kernel_route_equals_tensor_route():
    x = _cx(np.random.default_rng(4), 1 << 14)
    _, p_x = tspec.welch_psd(torch.from_numpy(x), nperseg=1024,
                             use_kernel=False)
    _, p_k = tspec.welch_psd(torch.from_numpy(x), nperseg=1024,
                             use_kernel=True)
    assert _rel(p_k.numpy(), p_x.numpy()) < 1e-4


def test_welch_psd_cpu_tensors_take_the_tensor_route(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("kernel route taken for a CPU tensor")

    monkeypatch.setattr(TFK, "psd_planar", no_kernel)
    monkeypatch.setattr(TFB, "welch_numerator", no_kernel)
    x = _cx(np.random.default_rng(1), 1 << 12)
    _, p = tspec.welch_psd(torch.from_numpy(x), nperseg=512)
    _, p_j = jspec.welch_psd(jnp.asarray(x), nperseg=512)
    assert _rel(p.numpy(), p_j) < 1e-5


@pytest.mark.parametrize("use_kernel", [False, True])
def test_welch_psd_real_input_onesided(use_kernel):
    x = np.random.default_rng(5).standard_normal(1 << 13).astype(np.float32)
    f_j, p_j = jspec.welch_psd(jnp.asarray(x), nperseg=512, onesided=True,
                               use_pallas=use_kernel, interpret=True)
    f_t, p_t = tspec.welch_psd(torch.from_numpy(x), nperseg=512,
                               onesided=True, use_kernel=use_kernel)
    np.testing.assert_array_equal(f_t, f_j)
    assert p_t.shape == (257,)
    assert _rel(p_t.numpy(), p_j) < 1e-4


def test_welch_psd_nondividing_overlap_takes_the_tensor_route():
    x = _cx(np.random.default_rng(6), 1 << 13)
    _, p_j = jspec.welch_psd(jnp.asarray(x), nperseg=1024, noverlap=300,
                             use_pallas=False)
    _, p_t = tspec.welch_psd(torch.from_numpy(x), nperseg=1024,
                             noverlap=300, use_kernel=True)
    _, p_x = tspec.welch_psd(torch.from_numpy(x), nperseg=1024,
                             noverlap=300, use_kernel=False)
    assert _rel(p_t.numpy(), p_j) < 1e-5
    np.testing.assert_array_equal(p_t.numpy(), p_x.numpy())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_welch_psd_tensor_window(use_kernel):
    x = _cx(np.random.default_rng(7), 1 << 13)
    w = np.hamming(512).astype(np.float32)
    _, p_j = jspec.welch_psd(jnp.asarray(x), nperseg=512,
                             window=jnp.asarray(w), use_pallas=use_kernel,
                             interpret=True)
    _, p_t = tspec.welch_psd(torch.from_numpy(x), nperseg=512,
                             window=torch.from_numpy(w),
                             use_kernel=use_kernel)
    assert _rel(p_t.numpy(), p_j) < 1e-4


def test_welch_psd_big_nperseg_route():
    F = 1 << 16
    x = _cx(np.random.default_rng(4), 2 * F)
    _, p_j = jspec.welch_psd(jnp.asarray(x), nperseg=F, use_pallas=True,
                             interpret=True)
    _, p_x = tspec.welch_psd(torch.from_numpy(x), nperseg=F,
                             use_kernel=False)
    _, p_k = tspec.welch_psd(torch.from_numpy(x), nperseg=F,
                             use_kernel=True)
    assert _rel(p_k.numpy(), p_x.numpy()) < 2e-5
    assert _rel(p_k.numpy(), p_j) < 2e-5


def test_welch_psd_errors():
    x = torch.zeros(4096, dtype=torch.complex64)
    with pytest.raises(ValueError, match="window length"):
        tspec.welch_psd(x, nperseg=512, window=np.ones(256))
    with pytest.raises(ValueError, match="noverlap"):
        tspec.welch_psd(x, nperseg=512, noverlap=512)
    with pytest.raises(ValueError, match="shorter"):
        tspec.welch_psd(x[:100], nperseg=512)


def test_welch_psd_tone_and_floor():
    n = 1 << 15
    w0 = 0.2
    rng = np.random.default_rng(0)
    x = (np.exp(2j * np.pi * w0 * np.arange(n))
         + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
         ).astype(np.complex64)
    for uk in (False, True):
        freqs, psd = tspec.welch_psd(torch.from_numpy(x), nperseg=1024,
                                     use_kernel=uk)
        psd = psd.numpy()
        assert abs(freqs[np.argmax(psd)] - w0) < 2.0 / 1024
        assert psd.max() / np.median(psd) > 1e3


def test_welch_psd_planar_matches_jax_and_complex_entry():
    n = 1024
    N = TFK.rows_per_step(n) * n
    x = _cx(np.random.default_rng(11), N)
    re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
    f_j, p_j = jspec.welch_psd_planar(jnp.asarray(re), jnp.asarray(im),
                                      nperseg=n, interpret=True)
    f_t, p_t = tspec.welch_psd_planar(torch.from_numpy(re),
                                      torch.from_numpy(im), nperseg=n)
    _, p_ref = tspec.welch_psd(torch.from_numpy(x), nperseg=n,
                               use_kernel=False)
    np.testing.assert_array_equal(f_t, f_j)
    assert _rel(p_t.numpy(), p_j) < 1e-4
    assert _rel(p_t.numpy(), p_ref.numpy()) < 1e-4
    _, p_o = tspec.welch_psd_planar(torch.from_numpy(re),
                                    torch.from_numpy(im), nperseg=n,
                                    fs=2.0, onesided=True,
                                    window=torch.ones(n))
    assert p_o.shape == (n // 2 + 1,)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_spectrogram_matches_jax(use_kernel):
    x = _cx(np.random.default_rng(7), 1 << 13)
    s_j = np.asarray(jspec.spectrogram(jnp.asarray(x), nperseg=256,
                                       use_pallas=use_kernel,
                                       interpret=True))
    s_t = tspec.spectrogram(torch.from_numpy(x), nperseg=256,
                            use_kernel=use_kernel).numpy()
    assert s_t.shape == s_j.shape
    assert _rel(s_t, s_j) < 1e-4


def test_spectrogram_real_input_and_chirp():
    n = 1 << 14
    t = np.arange(n)
    x = np.exp(2j * np.pi * np.cumsum(0.05 + 0.3 * t / n)).astype(
        np.complex64)
    S = tspec.spectrogram(torch.from_numpy(x), nperseg=256,
                          use_kernel=True).numpy()
    assert np.argmax(S[-1]) > np.argmax(S[0])
    r = np.random.default_rng(2).normal(size=4096).astype(np.float32)
    s_j = np.asarray(jspec.spectrogram(jnp.asarray(r), nperseg=256,
                                       noverlap=64))
    s_t = tspec.spectrogram(torch.from_numpy(r), nperseg=256, noverlap=64,
                            use_kernel=True).numpy()
    assert _rel(s_t, s_j) < 1e-4


def test_segments_match_naive_slicing():
    x = np.random.default_rng(3).normal(size=4097).astype(np.float32)
    for nperseg, noverlap in [(256, 128), (256, 192), (100, 37), (64, 0)]:
        step = nperseg - noverlap
        nseg = (len(x) - noverlap) // step
        want = np.stack([x[i * step: i * step + nperseg]
                         for i in range(nseg)])
        got = tspec._segments(torch.from_numpy(x), nperseg, noverlap)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jspec._segments(jnp.asarray(x), nperseg, noverlap)),
            want)
        parts = tspec._segment_parts(torch.from_numpy(x), nperseg, noverlap)
        assert (parts is None) == (nperseg % step != 0)
