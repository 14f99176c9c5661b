"""comms_tpu_torch.ops.fft against comms_tpu.ops.fft on the same numpy
inputs: the block FFTs (rustfft's unnormalized inverse and the scaled
one), the SampleFFT reblock, the four-step matmul form with its radix
checks and large-N guard, and fft_large's routing.  The reference node's
per-bin bound is 1e-5 (fft_node.rs:242-244); the JAX tests hold the same
functions to it.  fft_large's kernel route runs the K10 wrapper, which on
CPU tensors runs its plain version; JAX runs its Pallas kernel in
interpret mode."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import fft as jfft
from comms_tpu_torch.kernels import fft_big as TFB
from comms_tpu_torch.ops import fft as tfft


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _cx(rng, shape, dtype=np.complex64):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        dtype)


@pytest.mark.parametrize("n, size, dtype", [(10, 10, np.complex64),
                                            (16, 64, np.complex128),
                                            (8, 64, np.complex64)])
def test_fft_block_matches_jax(n, size, dtype):
    x = _cx(np.random.default_rng(n), size, dtype)
    want = np.asarray(jfft.fft_block(jnp.asarray(x), n))
    got = tfft.fft_block(torch.from_numpy(x), n)
    assert got.dtype == (torch.complex128 if dtype == np.complex128
                         else torch.complex64)
    assert got.shape == (size,)
    tol = 1e-12 if dtype == np.complex128 else 1e-6
    assert _rel(got.numpy(), want) < tol
    k = np.arange(n)
    dft = np.exp(-2j * np.pi * np.outer(k, k) / n)
    ref = (x.astype(np.complex128).reshape(-1, n) @ dft.T).reshape(-1)
    assert np.max(np.abs(got.numpy() - ref)) < 1e-5


def test_fft_block_real_input_promotes():
    x = np.random.default_rng(3).normal(size=32).astype(np.float32)
    want = np.asarray(jfft.fft_block(jnp.asarray(x), 8))
    got = tfft.fft_block(torch.from_numpy(x), 8)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("normalize", [False, True])
def test_ifft_block_conventions(normalize):
    x = _cx(np.random.default_rng(2), 16, np.complex128)
    want = np.asarray(jfft.ifft_block(jnp.asarray(x), 16,
                                      normalize=normalize))
    got = tfft.ifft_block(torch.from_numpy(x), 16, normalize=normalize)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    ref = np.fft.ifft(x) * (1 if normalize else 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-9)


def test_fft_reblock_sample_semantics():
    x = np.arange(37).astype(np.complex128)
    jf, jt = jfft.fft_reblock(jnp.asarray(x), 8)
    frames, tail = tfft.fft_reblock(torch.from_numpy(x), 8)
    assert tuple(frames.shape) == (4, 8) == jf.shape
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jt))


@pytest.mark.parametrize("N, radix", [(1024, None), (1024, (32, 32)),
                                      (256, None), (96, None),
                                      (97, None)])
def test_fft_four_step_matches_jax(N, radix):
    x = _cx(np.random.default_rng(40), (5, N))
    want = np.asarray(jfft.fft_four_step(jnp.asarray(x), radix=radix))
    got = tfft.fft_four_step(torch.from_numpy(x), radix=radix)
    assert got.dtype == torch.complex64
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(got.numpy(), ref) < 1e-5
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("inverse, scale", [(True, None), (False, 0.25),
                                            (True, 1.0)])
def test_fft_four_step_inverse_and_scale(inverse, scale):
    x = _cx(np.random.default_rng(41), (3, 512))
    want = np.asarray(jfft.fft_four_step(jnp.asarray(x), inverse=inverse,
                                         scale=scale))
    got = tfft.fft_four_step(torch.from_numpy(x), inverse=inverse,
                             scale=scale)
    assert _rel(got.numpy(), want) < 1e-5


def test_fft_four_step_bad_radix():
    with pytest.raises(ValueError, match="factor"):
        jfft.fft_four_step(jnp.zeros((2, 64), jnp.complex64), radix=(16, 8))
    with pytest.raises(ValueError, match="factor"):
        tfft.fft_four_step(torch.zeros((2, 64), dtype=torch.complex64),
                           radix=(16, 8))
    with pytest.raises(ValueError, match="precision"):
        tfft.fft_four_step(torch.zeros((2, 64), dtype=torch.complex64),
                           precision="default")


def test_fft_four_step_large_n_guard():
    x = np.random.default_rng(1).normal(size=(1, 1 << 20)).astype(
        np.complex64)
    got = tfft.fft_four_step(torch.from_numpy(x))
    ref = np.fft.fft(x, axis=-1)
    assert _rel(got.numpy(), ref) < 1e-4
    with pytest.raises(ValueError, match="dense"):
        tfft.fft_four_step(torch.zeros((1, 1 << 20), dtype=torch.complex64),
                           radix=(64, 1 << 14))


def test_fft_large_routes_cpu_tensors_to_torch_fft(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel route was taken for a CPU tensor")

    monkeypatch.setattr(TFB, "fft_big_planar", no_kernel)
    x = _cx(np.random.default_rng(5), (2, 1 << 16))
    want = np.asarray(jfft.fft_large(jnp.asarray(x), use_pallas=False))
    got = tfft.fft_large(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 1e-5


def test_fft_large_kernel_route_matches_jax_kernel():
    x = _cx(np.random.default_rng(6), (2, 1 << 16))
    want = np.asarray(jfft.fft_large(jnp.asarray(x), use_pallas=True,
                                     interpret=True))
    got = tfft.fft_large(torch.from_numpy(x), use_kernel=True)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    assert got.shape == (2, 1 << 16)
    assert _rel(got.numpy(), ref) < 1e-5
    assert _rel(got.numpy(), want) < 1e-5


def test_fft_large_bad_n_raises_valueerror():
    bad = 3 * (1 << 16)
    with pytest.raises(ValueError, match="two-factor"):
        jfft.fft_large(jnp.zeros((1, bad), jnp.complex64), use_pallas=True)
    with pytest.raises(ValueError, match="two-factor"):
        tfft.fft_large(torch.zeros((1, bad), dtype=torch.complex64),
                       use_kernel=True)
    y = tfft.fft_large(torch.zeros((1, bad), dtype=torch.complex64))
    assert y.shape == (1, bad)
