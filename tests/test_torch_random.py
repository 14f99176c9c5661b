"""The port's threefry PRNG (comms_tpu_torch.ops.random) against JAX's.

The JAX package draws its transmit bits from jax.random (threefry2x32,
partitionable key derivation); the port carries the algorithm itself.
Exact: the hash (and the Random123 known answer), PRNGKey, split chains,
randint, the bits of both block sources and uniform.  normal: within 4
float32 ulp (XLA's erf_inv polynomial through torch's log1p and sqrt);
in float64 within 3 ulp (XLA's float64 polynomial and its log1p; the
rest is XLA's fused multiply-adds against torch's separate roundings).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax._src import prng as jprng

from comms_tpu.ops import random as jrand
from comms_tpu_torch.ops import random as trand

SEEDS = [0, 7, (1 << 32) + 5, -1, (1 << 31) - 1]
CPU = "cpu"


def _key(seed):
    return jrand.source_init(seed), trand.source_init(seed, CPU)


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


def test_threefry_known_answer():
    # Random123's threefry2x32_20 vector (the pi digits key/count).
    y = trand.threefry2x32(torch.tensor(0x13198A2E), torch.tensor(0x03707344),
                           torch.tensor(0x243F6A88), torch.tensor(0x85A308D3))
    assert [int(v) for v in y] == [0xC4923A9C, 0x483DF7A0]
    z = trand.threefry2x32(0, 0, torch.tensor(0), torch.tensor(0))
    assert [int(v) for v in z] == [0x6B200159, 0x99BA4EFE]
    m = trand.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, torch.tensor(0xFFFFFFFF),
                           torch.tensor(0xFFFFFFFF))
    assert [int(v) for v in m] == [0x1CB996FC, 0xBB002BE7]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_threefry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, size=2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, size=(2, 1000),
                     dtype=np.uint64).astype(np.uint32)
    j1, j2 = jprng.threefry2x32_p.bind(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(x[0]),
        jnp.asarray(x[1]))
    t1, t2 = trand.threefry2x32(int(k[0]), int(k[1]),
                                torch.from_numpy(x[0].astype(np.int64)),
                                torch.from_numpy(x[1].astype(np.int64)))
    assert _eq(j1, t1) and _eq(j2, t2)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_words(seed):
    jk, tk = _key(seed)
    assert tk.dtype == torch.int64 and tuple(tk.shape) == (2,)
    assert _eq(jk, tk)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chains(seed):
    jk, tk = _key(seed)
    for _ in range(10):
        jk, jsub = jax.random.split(jk)
        tk, tsub = trand.split(tk)
        assert _eq(jk, tk) and _eq(jsub, tsub)
    for num in (1, 3, 5):
        assert _eq(jax.random.split(jk, num), trand.split(tk, num))


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_block_chained(seed, n):
    jk, tk = _key(seed)
    for _ in range(10):
        jb, jk = jrand.random_bits_block(jk, n)
        tb, tk = trand.random_bits_block(tk, n)
        assert tb.dtype == torch.int8 and _eq(jb, tb)
    assert _eq(jk, tk)


@pytest.mark.parametrize("n", [32, 96, 4096])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_packed_block_chained(seed, n):
    jk, tk = _key(seed)
    for _ in range(10):
        jb, jk = jrand.random_bits_packed_block(jk, n)
        tb, tk = trand.random_bits_packed_block(tk, n)
        assert tb.dtype == torch.float32 and _eq(jb, tb)
    assert _eq(jk, tk)
    with pytest.raises(ValueError):
        trand.random_bits_packed_block(tk, 33)


def test_random_bits_words_match_jax():
    jk, tk = _key(11)
    assert _eq(jax.random.bits(jk, (777,), jnp.uint32),
               trand.random_bits(tk, 777))


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 1000), (-5, 17), (3, 3),
                                   (9, 4), (-(1 << 31), (1 << 31) - 1),
                                   (0, 1 << 31), (-7, 1 << 33)])
def test_randint_span_arithmetic(lo, hi):
    jk, tk = _key(5)
    j = jax.random.randint(jk, (1000,), lo, hi, dtype=jnp.int32)
    t = trand.randint(tk, 1000, lo, hi)
    assert t.dtype == torch.int32 and _eq(j, t)


def test_randint_01_is_the_low_stream_mod_2():
    # For [0, 2): the multiplier 2^16 % 2 is 0, so the value is the
    # second sub-key's word mod 2 (the general formula, not a shortcut).
    tk = trand.source_init(9, CPU)
    _, k2 = trand.split(tk)
    want = trand.random_bits(k2, 500) % 2
    assert torch.equal(trand.randint(tk, 500, 0, 2).to(torch.int64), want)


@pytest.mark.parametrize("start,end", [(0.0, 1.0), (-3.5, 2.25),
                                       (10.0, 10.5), (-1.0, 1.0)])
@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 5])
def test_uniform_block_chained(seed, start, end):
    jk, tk = _key(seed)
    for _ in range(10):
        ju, jk = jrand.uniform_block(jk, 777, start, end, dtype=jnp.float32)
        tu, tk = trand.uniform_block(tk, 777, start, end)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert _eq(jk, tk)


def test_uniform_float64_exact():
    jk, tk = _key(3)
    ju, _ = jrand.uniform_block(jk, 999, dtype=jnp.float64)
    tu, _ = trand.uniform_block(tk, 999, dtype=torch.float64)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0


# XLA's erf_inv polynomial through torch's log1p/sqrt vs through XLA's.
ULP_ERFINV = 2
ULP_NORMAL = 4


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(np.asarray(b, np.float32))))
    return np.abs(a.astype(np.float64) - np.asarray(b, np.float64)) / sp


def test_erfinv_f32_matches_xla():
    rng = np.random.default_rng(0)
    u = np.concatenate([
        rng.uniform(-1, 1, 200000),
        1.0 - rng.uniform(0, 1e-4, 20000),
        -1.0 + rng.uniform(0, 1e-4, 20000)]).astype(np.float32)
    u = u[np.abs(u) < 1]
    j = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    t = trand.erfinv_f32(torch.from_numpy(u)).numpy()
    assert _ulps(j, t).max() <= ULP_ERFINV
    ends = torch.tensor([-1.0, 1.0])
    assert torch.equal(trand.erfinv_f32(ends),
                       torch.tensor([-float("inf"), float("inf")]))


@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 5])
def test_normal_block_chained(seed):
    jk, tk = _key(seed)
    for _ in range(10):
        jn, jk = jrand.normal_block(jk, 20000, dtype=jnp.float32)
        tn, tk = trand.normal_block(tk, 20000)
        assert tn.dtype == torch.float32
        assert _ulps(jn, tn).max() <= ULP_NORMAL
    assert _eq(jk, tk)
    # mu + std * x: the bound is ULP_NORMAL ulp of std * x plus the
    # final rounding (near x = -mu/std the sum cancels)
    jn, _ = jrand.normal_block(jk, 20000, 0.5, 2.0, dtype=jnp.float32)
    tn, _ = trand.normal_block(tk, 20000, 0.5, 2.0)
    jn = np.asarray(jn)
    sx = np.abs(jn - np.float32(0.5)).astype(np.float32)
    bound = ULP_NORMAL * np.spacing(sx) + np.spacing(np.abs(jn))
    assert (np.abs(jn - tn.numpy()) <= bound).all()
    assert abs(float(tn.mean()) - 0.5) < 0.1
    assert abs(float(tn.std()) - 2.0) < 0.1
    with pytest.raises(TypeError, match="float16"):
        trand.normal_block(tk, 8, dtype=torch.float16)


def test_key_from_jax_words_continues_the_stream():
    jk, _ = _key(21)
    for _ in range(3):
        _, jk = jrand.random_bits_packed_block(jk, 64)
    tk = trand.key_from_words(np.asarray(jk), CPU)
    jb, _ = jrand.random_bits_packed_block(jk, 256)
    tb, _ = trand.random_bits_packed_block(tk, 256)
    assert _eq(jb, tb)
    with pytest.raises(ValueError):
        trand.key_from_words([1, 2, 3], CPU)


# float64: XLA's polynomial and log1p, without XLA's fused multiply-adds
# (measured: erf_inv 2 ulp, normal 3 ulp at most; ~7% of the samples
# differ at all).
ULP_ERFINV64 = 2
ULP_NORMAL64 = 3


def _ulps64(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def test_erfinv_f64_matches_xla():
    rng = np.random.default_rng(1)
    u = np.concatenate([
        rng.uniform(-1, 1, 200000),
        1.0 - rng.uniform(0, 1e-10, 2000),
        -1.0 + rng.uniform(0, 1e-12, 2000),
        1.0 - rng.uniform(0, 1e-4, 2000)])
    u = u[np.abs(u) < 1]
    j = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u, jnp.float64)))
    t = trand.erfinv_f64(torch.from_numpy(u)).numpy()
    assert _ulps64(j, t).max() <= ULP_ERFINV64
    ends = torch.tensor([-1.0, 1.0], dtype=torch.float64)
    assert torch.equal(trand.erfinv_f64(ends),
                       torch.tensor([-float("inf"), float("inf")],
                                    dtype=torch.float64))


@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 5, -1])
def test_normal_float64_matches_jax(seed):
    n = 131072
    j = np.asarray(jax.random.normal(jrand.source_init(seed), (n,),
                                     jnp.float64))
    t = trand.normal(trand.source_init(seed, CPU), n, torch.float64)
    assert t.dtype == torch.float64
    assert _ulps64(j, t.numpy()).max() <= ULP_NORMAL64
    jk, tk = _key(seed)
    jn, jk = jrand.normal_block(jk, 4096, 0.5, 2.0, dtype=jnp.float64)
    tn, tk = trand.normal_block(tk, 4096, 0.5, 2.0, dtype=torch.float64)
    assert _eq(jk, tk)
    jn = np.asarray(jn)
    sx = np.abs(jn - 0.5)
    bound = ULP_NORMAL64 * np.spacing(sx) + np.spacing(np.abs(jn))
    assert (np.abs(jn - tn.numpy()) <= bound).all()
