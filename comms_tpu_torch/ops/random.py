"""Random sources (uniform / normal / bits) as counter-based blocks.

Counterpart of :mod:`comms_tpu.ops.random`, bit for bit.  The JAX
package draws from JAX's threefry2x32 PRNG with its partitionable key
derivation (``jax_threefry_partitionable``, the default of JAX 0.9); the
tests recover the bits a block drew by re-running the PRNG from the
seed.  Torch's generators give other streams, so this module carries
the algorithm itself:

* :func:`threefry2x32`, the Threefry-2x32 hash (20 rounds, Random123);
* :func:`PRNGKey`, :func:`split` (the "foldlike" split: the hash of the
  64-bit counts 0..num-1 under the key), :func:`random_bits` (32-bit
  words, ``bits1 ^ bits2`` of the hash of the counts 0..n-1);
* :func:`randint`, :func:`uniform` and :func:`normal` as JAX samples
  them (two sub-keys and the span arithmetic; the mantissa trick;
  ``sqrt(2) * erfinv`` of a uniform on (-1, 1)).

Words are carried as int64 tensors holding values in [0, 2**32) and
masked after every add and shift, so each operation is exact and the
same on the CPU and on a CUDA card (torch's uint32 arithmetic is partial
and ``>>`` on a signed type is arithmetic).  A key is an int64 tensor
[2] (hi, lo) on the device the blocks are drawn on; the carried state of
a source is its key, split once per block.

``normal`` takes XLA's ``erf_inv`` polynomial of its dtype: in float32
through torch's ``log1p`` and ``sqrt``, within 4 ulp of the JAX package;
in float64 through XLA's own ``log1p`` (carried here too), within 3 ulp
(XLA fuses the polynomial's multiply-adds, torch rounds each).  Neither
is bit for bit.  Everything else here is exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "threefry2x32",
    "PRNGKey",
    "split",
    "random_bits",
    "randint",
    "uniform",
    "normal",
    "erfinv_f32",
    "erfinv_f64",
    "key_from_words",
    "source_init",
    "uniform_block",
    "normal_block",
    "random_bits_block",
    "random_bits_packed_block",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the count words ``(x1, x2)`` under the
    key words ``(k1, k2)``: int64 tensors (or ints) of 32-bit values,
    broadcast together.  Returns the two hashed words ``(y1, y2)``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """The raw threefry key of an integer seed: its 64 bits (two's
    complement) as the words (hi, lo), as JAX builds it with 64-bit
    integers enabled (for seeds in [0, 2**31) also without)."""
    s = int(seed) % (1 << 64)
    return key_from_words((s >> 32, s & _M32), device)


def key_from_words(words, device="cuda") -> torch.Tensor:
    """A key from its two 32-bit words, e.g. a JAX key's uint32[2] data
    as a numpy array."""
    w = [int(v) & _M32 for v in np.asarray(words).reshape(-1)]
    if len(w) != 2:
        raise ValueError(f"a threefry key has 2 words, got {len(w)}")
    return torch.tensor(w, dtype=torch.int64, device=device)


def _counts(n: int, device):
    """The 64-bit counts 0..n-1 as (hi, lo) words."""
    c = torch.arange(int(n), dtype=torch.int64, device=device)
    return c >> 32, c & _M32


def _hash_counts(key, n: int):
    hi, lo = _counts(n, key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key, num: int = 2) -> torch.Tensor:
    """``num`` new keys [num, 2] (JAX's partitionable split)."""
    y1, y2 = _hash_counts(key, num)
    return torch.stack([y1, y2], dim=1)


def random_bits(key, n: int) -> torch.Tensor:
    """``n`` uniform 32-bit words (int64 tensor of values in [0, 2**32))."""
    y1, y2 = _hash_counts(key, n)
    return y1 ^ y2


def _mul32(a, b: int):
    """``a * b mod 2**32`` for words ``a`` and an int ``b`` < 2**32,
    without leaving int64: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rem(x, span: int):
    """uint32 remainder as XLA defines it: ``x % 0`` is ``x``."""
    return x if span == 0 else x % span


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``n`` int32 values in [minval, maxval), as ``jax.random.randint``
    with dtype int32 draws them: 64 random bits per value from two
    sub-keys, reduced modulo the span."""
    lo_v = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi_v = min(max(int(maxval), _I32_MIN), _I32_MAX)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, n), random_bits(k2, n)
    span = (hi_v - lo_v) & _M32
    if hi_v <= lo_v:
        span = 1
    if int(maxval) > _I32_MAX and hi_v > lo_v:
        span = (span + 1) & _M32
    mult = _rem(1 << 16, span)
    mult = _rem((mult * mult) & _M32, span)
    off = (_mul32(_rem(higher, span), mult) + _rem(lower, span)) & _M32
    off = _rem(off, span)
    # minval + int32(off), with int32 wraparound
    v = (off + lo_v) & _M32
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def uniform(key, n: int, minval=0.0, maxval=1.0,
            dtype=torch.float32) -> torch.Tensor:
    """``n`` uniform samples in [minval, maxval): random mantissa bits
    under the exponent of 1.0, minus 1, then ``f * (maxval - minval) +
    minval`` (float32 or float64).

    XLA fuses that multiply-add (one rounding); in float32 it runs here
    in float64, where the product is exact and the sum is too while
    |minval| < 32 * (maxval - minval): one rounding to float32, the same
    number.  In float64 it is a multiply, then an add."""
    if dtype == torch.float32:
        one = int(np.array(1.0, np.float32).view(np.int32))
        bits = (random_bits(key, n) >> 9) | one
        floats = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        y1, y2 = _hash_counts(key, n)
        one = int(np.array(1.0, np.float64).view(np.int64))
        # (y1 << 32 | y2) >> 12, built without leaving int64
        bits = ((y1 << 20) | (y2 >> 12)) | one
        floats = bits.view(torch.float64)
    else:
        raise TypeError(f"uniform takes float32 or float64, got {dtype}")
    lo = _as(minval, dtype)
    span = _as(_as(maxval, dtype) - lo, dtype)
    floats = floats - 1.0
    if dtype == torch.float32:
        out = (floats.to(torch.float64) * span + lo).to(dtype)
    else:
        out = floats * span + lo
    return torch.clamp(out, min=lo)


def _as(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``."""
    return torch.tensor(v, dtype=dtype).item()


# XLA's float32 erf_inv (Giles' single-precision approximation): a
# degree-8 polynomial in w = -log1p(-x^2), shifted, one set of
# coefficients for w < 5 and one for the tails.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x) -> torch.Tensor:
    """``erfinv`` of float32 ``x`` as XLA computes it (within 2 float32
    ulp of the JAX package's ``lax.erf_inv``; ``torch.erfinv`` differs
    from it by up to ~90 ulp in the tails)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        c = torch.where(lt, np.float32(a), np.float32(b))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


# XLA's float64 erf_inv (Giles' double-precision approximation): a
# polynomial in w = -log1p(-x^2), shifted, in three ranges -- degree 22
# for w < 6.25, 18 for w < 16, 16 above.  The three coefficient lists
# are evaluated as one Horner chain: the shorter ones are the tails of
# the chain, entered where their range's list begins.
_ERFINV64_W_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_W_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


# XLA's float64 log1p on the CPU: for |x| < sqrt(2) - 1 Cephes'
# rational approximation x - x^2/2 + x^3 * P(x) / Q(x), else log(1 + x).
# It is up to ~1e-14 relative from the true value, which torch.log1p
# is not, and erf_inv's w goes through it.
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_xla(x):
    def poly(cs):
        p = torch.zeros_like(x)
        for c in cs:
            p = p * x + c
        return p

    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (poly(_LOG1P_P) / poly(_LOG1P_Q)))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def erfinv_f64(x) -> torch.Tensor:
    """``erfinv`` of float64 ``x`` as XLA computes it (the JAX package's
    ``lax.erf_inv`` in float64, through XLA's ``log1p``;
    ``torch.erfinv`` differs from it by up to ~1e-10 relative in the
    tails)."""
    w = -_log1p_xla(x * -x)
    lt625 = w < 6.25
    lt16 = w < 16.0
    w = torch.where(lt625, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coef(i):
        c = torch.full_like(x, _ERFINV64_W_LT_6_25[i])
        if i < 19:
            c = torch.where(lt625, c, _ERFINV64_W_LT_16[i])
        if i < 17:
            c = torch.where(lt16, c, _ERFINV64_W_GE_16[i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * w
    for i in range(17, 19):
        p = torch.where(lt16, coef(i) + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt625, coef(i) + p * w, p)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, n: int, dtype=torch.float32) -> torch.Tensor:
    """``n`` standard normal samples: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform on the open interval (-1, 1), through XLA's polynomial of
    the dtype (:func:`erfinv_f32`, :func:`erfinv_f64`); ``sqrt(2)`` is
    rounded to the dtype, as JAX rounds it.  float32 or float64."""
    if dtype == torch.float32:
        np_dt, erfinv = np.float32, erfinv_f32
    elif dtype == torch.float64:
        np_dt, erfinv = np.float64, erfinv_f64
    else:
        raise TypeError(f"normal takes float32 or float64, got {dtype}")
    lo = np.nextafter(np_dt(-1.0), np_dt(0.0))
    u = uniform(key, n, float(lo), 1.0, dtype)
    return float(np_dt(np.sqrt(2))) * erfinv(u)


def source_init(seed: int, device="cuda") -> torch.Tensor:
    """Carried PRNG key on ``device``."""
    return PRNGKey(seed, device)


def uniform_block(key, n: int, start=0.0, end=1.0, dtype=torch.float32):
    """Uniform [start, end) block.  Returns ``(samples, new_key)``."""
    new_key, sub = split(key)
    return uniform(sub, n, start, end, dtype), new_key


def normal_block(key, n: int, mu=0.0, std_dev=1.0, dtype=torch.float32):
    """Normal(mu, std_dev) block.  Returns ``(samples, new_key)``."""
    new_key, sub = split(key)
    return mu + std_dev * normal(sub, n, dtype), new_key


def random_bits_block(key, n: int, dtype=torch.int8):
    """Uniform bits in {0, 1} (the reference's ``random_bit()``), one
    :func:`randint` draw per bit.  Returns ``(bits, new_key)``."""
    new_key, sub = split(key)
    return randint(sub, n, 0, 2).to(dtype), new_key


def random_bits_packed_block(key, n: int, dtype=torch.float32):
    """Uniform bits in {0, 1}, 32 per threefry word (LSB first): 32x less
    PRNG work than :func:`random_bits_block`, another stream.  ``n``
    must be a multiple of 32.  Returns ``(bits, new_key)``."""
    n = int(n)
    if n % 32:
        raise ValueError(f"bit count {n} must be a multiple of 32")
    new_key, sub = split(key)
    words = random_bits(sub, n // 32)
    shifts = torch.arange(32, dtype=torch.int64, device=key.device)
    bits = (words[:, None] >> shifts) & 1
    return bits.reshape(-1).to(dtype), new_key
