"""parallel.dfft: the port's distributed FFT against the JAX package's
``make_dfft`` on the 8-device CPU mesh and against numpy, with the same
numpy inputs, in natural and interleaved order.  Both sides build their
phase factors from exact integer residues; the port forms the angles in
float64, so it is held to JAX and to numpy at the JAX tests' 1e-5 of the
largest bin (complex64 products in other orders)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.parallel import dfft as jdfft
from comms_tpu.parallel import sharding as jsh
from comms_tpu_torch.parallel import dfft as tdfft
from comms_tpu_torch.parallel import sharding as tsh

TOL = 1e-5


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("N,shape,radix", [
    (1024, (1024,), None),         # natural order from the 2nd all-to-all
    (320, (320,), None),           # non-power-of-two: r=1, R=8, C=40
    (1 << 12, (4, 1 << 12), None),  # batched
    (1 << 14, (3, 1 << 14), 4),    # explicit local radix, batched
    (1 << 16, (1 << 16,), "cap"),  # the local FFT capped at 2^10
])
def test_natural_order_matches_jax_and_numpy(N, shape, radix):
    x = _x(shape, N % 97)
    if radix == "cap":
        radix = tdfft.pick_local_radix(N, 8, max_local_fft=1 << 10)
    jd = jdfft.make_dfft(N, jsh.time_mesh(8), local_radix=radix)
    td = tdfft.make_dfft(N, tsh.time_mesh(8, device="cpu"),
                         local_radix=radix)
    assert (td.R, td.C, td.r) == (jd.R, jd.C, jd.r)
    want = np.asarray(jd(jnp.asarray(x)))
    got = td(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    assert _rel(got, want) < TOL
    assert _rel(got, np.fft.fft(x, axis=-1)) < TOL


def test_interleaved_layout_matches_jax():
    # natural_order=False: shard s's chunk [pl*C + m] holds
    # X[(s*r+pl) + R*m].
    N = 1 << 12
    x = _x(N, 9)
    jd = jdfft.make_dfft(N, jsh.time_mesh(8), natural_order=False,
                         local_radix=2)
    td = tdfft.make_dfft(N, tsh.time_mesh(8, device="cpu"),
                         natural_order=False, local_radix=2)
    got = td(torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(jd(jnp.asarray(x)))) < TOL
    R, C, r = td.R, td.C, td.r
    recon = np.empty(N, np.complex64)
    for s in range(8):
        for pl in range(r):
            recon[s * r + pl + R * np.arange(C)] = got[
                s * r * C + pl * C + np.arange(C)]
    assert _rel(recon, np.fft.fft(x)) < TOL


def test_local_fn_is_the_staged_form():
    N = 1 << 12
    x = torch.from_numpy(_x((2, N), 10))
    mesh = tsh.time_mesh(8, device="cpu")
    d = tdfft.make_dfft(N, mesh)
    parts = d.local_fn(tsh.shard(x, mesh, (None, "time")))
    assert len(parts) == 8 and parts[0].shape == (2, N // 8)
    assert torch.equal(torch.cat(parts, dim=1), d(x))


def test_pick_local_radix_matches_jax():
    for N, n, cap in ((1 << 20, 8, 1 << 14), (1 << 16, 8, 1 << 10),
                      (1 << 12, 4, None), (320, 8, None)):
        assert (tdfft.pick_local_radix(N, n, max_local_fft=cap)
                == jdfft.pick_local_radix(N, n, max_local_fft=cap))
    assert tdfft.pick_local_radix(1 << 20, 8, max_local_fft=1 << 14) == 8


def test_pick_local_radix_and_make_errors():
    # n | N but n^2 does not divide N: no natural-order factorization.
    with pytest.raises(ValueError, match="natural_order=False"):
        tdfft.pick_local_radix(8 * 3, 8)
    mesh = tsh.time_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="must divide by R"):
        tdfft.make_dfft(1000, mesh, local_radix=3)
    with pytest.raises(ValueError, match="natural order needs"):
        tdfft.make_dfft(8 * 12, mesh, local_radix=1)
    np.testing.assert_array_equal(tdfft.dfft_reference(np.arange(4.0)),
                                  np.fft.fft(np.arange(4.0)))
