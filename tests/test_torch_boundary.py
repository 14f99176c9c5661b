"""runtime.boundary's device-side codecs against the JAX package's, bit
for bit: ``pairs_to_complex`` ([..., 2] float -> complex) and
``complex_to_pairs`` (complex -> [..., 2] float), for complex64 and
complex128 (float32 and float64 pairs; the conftest turns on JAX's
x64), with and without leading batch axes, on the same seeded numpy
inputs; and the round trip."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.runtime import boundary as jb
from comms_tpu_torch.runtime import boundary as tb

SHAPES = [(7,), (3, 5), (2, 3, 4)]
DTYPES = [(np.float32, np.complex64), (np.float64, np.complex128)]


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(1, np_dtype)).dtype


def _pairs(shape, real, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (2,)).astype(real)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("real,cplx", DTYPES)
def test_pairs_to_complex_matches_jax(shape, real, cplx):
    p = _pairs(shape, real, 1)
    want = np.asarray(jb.pairs_to_complex(jnp.asarray(p)))
    got = tb.pairs_to_complex(torch.from_numpy(p))
    assert want.dtype == cplx and got.dtype == _torch_dtype(cplx)
    assert got.shape == shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("real,cplx", DTYPES)
def test_complex_to_pairs_matches_jax(shape, real, cplx):
    p = _pairs(shape, real, 2)
    z = (p[..., 0] + 1j * p[..., 1]).astype(cplx)
    want = np.asarray(jb.complex_to_pairs(jnp.asarray(z)))
    got = tb.complex_to_pairs(torch.from_numpy(z))
    assert want.dtype == real and got.dtype == _torch_dtype(real)
    assert got.shape == shape + (2,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("real,cplx", DTYPES)
def test_codecs_round_trip(real, cplx):
    p = torch.from_numpy(_pairs((4, 6), real, 3))
    z = tb.pairs_to_complex(p)
    assert torch.equal(tb.complex_to_pairs(z), p)
    assert torch.equal(tb.pairs_to_complex(tb.complex_to_pairs(z)), z)
