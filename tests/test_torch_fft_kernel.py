"""The FFT and PSD kernels' entries (K6, K7: the contract of the JAX
package's fft_pallas) against that Pallas kernel in interpret mode, at the
JAX tests' sizes and bounds (tests/test_fft_pallas.py: 1e-5 relative to
the largest bin for FFTs and the row PSD, 1e-4 for the stream and the
involution).  Here the wrappers run the plain PyTorch versions, because
the tensors lie on the CPU; the kernels themselves are compared with them
on the card by tests/test_torch_fft_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import fft_pallas as JFP
from comms_tpu.ops import spectrum as jspec
from comms_tpu_torch.kernels import fft as TFK
from comms_tpu_torch.ops import spectrum as tspec


def _rel(y, ref):
    y, ref = np.asarray(y, np.complex128), np.asarray(ref, np.complex128)
    return np.max(np.abs(y - ref)) / np.max(np.abs(ref))


def _rows(rng, rows, n):
    return (rng.standard_normal((rows, n)) +
            1j * rng.standard_normal((rows, n))).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def test_sizes_and_tiles_match_jax():
    for n in (100, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        assert TFK.supported(n) == JFP.supported(n)
    for n in (256, 1024, 16384):
        assert TFK.rows_per_step(n) == JFP.rows_per_step(n)
    np.testing.assert_array_equal(tspec.hann(1000), jspec.hann(1000))


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
def test_fft_matches_jax_kernel(n):
    x = _rows(np.random.default_rng(0), 5, n)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    want = np.asarray(JFP.fft_pallas(x, n=n, interpret=True))
    yr, yi = TFK.fft_planar(_t(x.real), _t(x.imag), n=n)
    got = yr.numpy() + 1j * yi.numpy()
    assert yr.dtype == torch.float32 and yr.shape == (5, n)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, want) < 1e-5
    cx = TFK.fft_complex(torch.from_numpy(x), n=n, precision="highest")
    np.testing.assert_array_equal(cx.numpy(), got.astype(np.complex64))


def test_fft_folded_scale():
    z = _rows(np.random.default_rng(8), 8, 1024)
    s = 1.0 / 32.0
    jr, ji = JFP.fft_pallas_planar(jnp.asarray(z.real.astype(np.float32)),
                                   jnp.asarray(z.imag.astype(np.float32)),
                                   1024, scale=s, interpret=True)
    yr, yi = TFK.fft_planar(_t(z.real), _t(z.imag), 1024, scale=s)
    got = yr.numpy() + 1j * yi.numpy()
    assert _rel(got, np.fft.fft(z, axis=1) * s) < 1e-5
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < 1e-5


def test_fft_plane_swap_involution():
    # step(z) = swap(s * fft(swap(z))) with s = 1/sqrt(n), twice, is an
    # exact bin reversal (the bench's in-place chaining identity).
    n = 1024
    z = _rows(np.random.default_rng(9), 4, n)
    s = 1.0 / np.sqrt(n)
    ur, ui = TFK.fft_planar(_t(z.imag), _t(z.real), n, scale=s)
    ur2, ui2 = TFK.fft_planar(ur, ui, n, scale=s)
    got = ui2.numpy() + 1j * ur2.numpy()
    rev = z[:, np.mod(-np.arange(n), n)]
    assert _rel(got, rev) < 1e-4
    assert abs(np.linalg.norm(got) / np.linalg.norm(z) - 1.0) < 1e-5
    jr, ji = JFP.fft_pallas_planar(jnp.asarray(z.imag.astype(np.float32)),
                                   jnp.asarray(z.real.astype(np.float32)),
                                   n, scale=s, interpret=True)
    jr2, ji2 = JFP.fft_pallas_planar(jr, ji, n, scale=s, interpret=True)
    assert _rel(got, np.asarray(ji2) + 1j * np.asarray(jr2)) < 1e-4


def test_fft_rejects_unsupported():
    z = torch.zeros((4, 100))
    with pytest.raises(ValueError, match="supports n"):
        TFK.fft_planar(z, z, n=100)
    with pytest.raises(ValueError, match="planar"):
        TFK.fft_planar(torch.zeros((4, 512)), torch.zeros((4, 1024)),
                       n=1024)
    with pytest.raises(ValueError, match="precision"):
        TFK.fft_planar(torch.zeros((4, 256)), torch.zeros((4, 256)), 256,
                       precision="bf16")
    with pytest.raises(ValueError, match="supports n"):
        JFP.fft_pallas_planar(np.zeros((4, 100), np.float32),
                              np.zeros((4, 100), np.float32), n=100)


def test_kernel_entries_raise_on_other_devices(monkeypatch):
    # Only CPU tensors take the plain versions; any other device gets the
    # kernel or an exception.
    def no_plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    for name in ("fft_plain", "psd_plain", "psd_stream_plain"):
        monkeypatch.setattr(TFK, name, no_plain)
    z = torch.empty((4, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TFK.fft_planar(z, z, 256)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TFK.psd_planar(z, z, tspec.hann(256), 256)
    flat = torch.empty(TFK.rows_per_step(256) * 256, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TFK.psd_stream_planar(flat, flat, tspec.hann(256), 256)


@pytest.mark.parametrize("n, weights, demean",
                         [(1024, None, True), (512, [1, 0, 1, 0, 1], True),
                          (4096, None, True), (512, [1, 0, 1, 1, 0],
                                               False)])
def test_psd_rows_match_jax_kernel(n, weights, demean):
    rng = np.random.default_rng(n + len(weights or ()))
    rows = 5 if weights else 4
    x = _rows(rng, rows, n) + np.complex64(0.3 - 0.2j)
    win = tspec.hann(n)
    wts = None if weights is None else np.asarray(weights, np.float32)
    want = np.asarray(JFP.psd_pallas_planar(
        x.real.astype(np.float32), x.imag.astype(np.float32), win, n=n,
        row_weights=wts, demean=demean, interpret=True))
    got = TFK.psd_planar(_t(x.real), _t(x.imag), win, n=n,
                         row_weights=None if wts is None else _t(wts),
                         demean=demean).numpy()
    xm = x.astype(np.complex128)
    if wts is not None:
        xm = xm * wts[:, None]
    if demean:
        xm = xm - xm.mean(axis=1, keepdims=True)
    ref = (np.abs(np.fft.fft(xm * win[None, :], axis=1)) ** 2).sum(axis=0)
    assert got.shape == (n,) and got.dtype == np.float32
    assert _rel(got, ref) < 1e-5
    assert _rel(got, want) < 1e-5


def test_psd_rows_errors():
    z = torch.zeros((3, 256))
    with pytest.raises(ValueError, match="row_weights"):
        TFK.psd_planar(z, z, tspec.hann(256), 256,
                       row_weights=torch.ones(2))
    with pytest.raises(ValueError, match="supports n"):
        TFK.psd_planar(torch.zeros((3, 300)), torch.zeros((3, 300)),
                       np.ones(300), 300)
    with pytest.raises(ValueError, match="window"):
        TFK.psd_planar(z, z, np.ones(128), 256)


def _welch_oracle(x, n, w):
    ref = np.zeros(n)
    for s0 in np.arange(0, len(x) - n + 1, n // 2):
        seg = x[s0:s0 + n].astype(np.complex128)
        seg = seg - seg.mean()
        ref += np.abs(np.fft.fft(seg * w)) ** 2
    return ref


def test_psd_stream_matches_jax_kernel():
    rng = np.random.default_rng(10)
    n = 1024
    N = TFK.rows_per_step(n) * n
    w = tspec.hann(n).astype(np.float32)
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
        np.complex64)
    want = np.asarray(JFP.psd_stream_pallas_planar(
        jnp.asarray(x.real.astype(np.float32)),
        jnp.asarray(x.imag.astype(np.float32)), w, n=n, interpret=True),
        np.float64)
    got = TFK.psd_stream_planar(_t(x.real), _t(x.imag), w, n=n).numpy()
    ref = _welch_oracle(x, n, w)
    assert _rel(got, ref) < 1e-4
    assert _rel(got, want) < 1e-4


def test_psd_stream_rejects_blocks_jax_rejects():
    n = 1024
    bad = torch.zeros(TFK.rows_per_step(n) * n + n)
    with pytest.raises(ValueError, match="multiple of"):
        TFK.psd_stream_planar(bad, bad, np.ones(n), n=n)
    with pytest.raises(ValueError, match="multiple of"):
        JFP.psd_stream_pallas_planar(jnp.asarray(bad.numpy()),
                                     jnp.asarray(bad.numpy()), np.ones(n),
                                     n=n, interpret=True)
    with pytest.raises(ValueError, match="flat"):
        TFK.psd_stream_planar(torch.zeros((2, 4096)), torch.zeros((2, 4096)),
                              np.ones(n), n=n)
