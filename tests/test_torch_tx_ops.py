"""The port's transmit ops against the JAX package's: taps, modulation,
pulse shaping, the mixer (float and fixed-point phase), PRNs and the
fused shaping of ops/txshape.  The same numpy inputs, made from seeds,
go to both sides.

Bounds: taps, modulation, PRNs, the fixed-point words, the shaping
matrices and the quantize/pack words are exact; pulse shaping, the
mixer and the shaping planes are float32 on both sides in other orders
(2e-6 absolute at unit-scale signals, the JAX tests' own bound for the
fused planes, tests/test_txshape.py:39)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import mixer as jmix
from comms_tpu.ops import modulation as jmod
from comms_tpu.ops import prns as jprns
from comms_tpu.ops import pulse as jpulse
from comms_tpu.ops import taps as jtaps
from comms_tpu.ops import txshape as jtx
from comms_tpu_torch.ops import mixer as tmix
from comms_tpu_torch.ops import modulation as tmod
from comms_tpu_torch.ops import prns as tprns
from comms_tpu_torch.ops import pulse as tpulse
from comms_tpu_torch.ops import taps as ttaps
from comms_tpu_torch.ops import txshape as ttx

CPU = "cpu"
TOL_F32 = 2e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ taps

@pytest.mark.parametrize("name,args", [
    ("rect_taps", (7,)),
    ("gaussian_taps", (33, 4.0, 0.5)),
    ("rc_taps", (33, 4.0, 0.3)),
    ("rc_taps", (32, 4.0, 0.25)),     # lands on the |t| = 1/(2b) limit
    ("rc_taps", (17, 2.0, 0.0)),
    ("rrc_taps", (32, 4.0, 0.25)),
    ("qfilt_taps", (32, 0.5, 4)),
])
def test_taps_equal_jax(name, args):
    np.testing.assert_array_equal(getattr(ttaps, name)(*args),
                                  getattr(jtaps, name)(*args))


def test_sinc_and_rolloff_validation():
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(ttaps.sinc(x), jtaps.sinc(x))
    for fn in (ttaps.rc_taps, ttaps.rrc_taps):
        with pytest.raises(ttaps.InvalidRolloffError):
            fn(8, 4.0, 1.5)


# ------------------------------------------------------------ modulation

def _bits(seed, n):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)


@pytest.mark.parametrize("name", ["bpsk_bit_mod", "bpsk_bit_mod_example",
                                  "qpsk_bits_mod_example"])
def test_bit_maps_equal_jax(name):
    b = _bits(1, 64)
    np.testing.assert_array_equal(getattr(tmod, name)(_t(b)).numpy(),
                                  np.asarray(getattr(jmod, name)(b)))


@pytest.mark.parametrize("name", ["bpsk_byte_mod", "qpsk_byte_mod",
                                  "unpack_bits_lsb_first"])
def test_byte_maps_equal_jax(name):
    by = np.random.default_rng(2).integers(0, 256, (3, 5)).astype(np.uint8)
    np.testing.assert_array_equal(getattr(tmod, name)(_t(by)).numpy(),
                                  np.asarray(getattr(jmod, name)(by)))


def test_qpsk_value_and_pair_maps_equal_jax():
    v = np.arange(4, dtype=np.int32).repeat(3)
    np.testing.assert_array_equal(tmod.qpsk_bit_mod(_t(v)).numpy(),
                                  np.asarray(jmod.qpsk_bit_mod(v)))
    b0, b1 = _bits(3, 16), _bits(4, 16)
    np.testing.assert_array_equal(tmod.qpsk_pair_mod(_t(b0), _t(b1)).numpy(),
                                  np.asarray(jmod.qpsk_pair_mod(b0, b1)))


# ----------------------------------------------------------------- pulse

def test_polyphase_taps_equal_jax():
    t = jtaps.rc_taps(33, 4.0, 0.3).astype(np.complex64)
    np.testing.assert_array_equal(tpulse.polyphase_taps(t, 4),
                                  jpulse.polyphase_taps(t, 4))


@pytest.mark.parametrize("T,sps", [(32, 4), (33, 4), (4, 4), (31, 8)])
def test_pulse_shape_block_streaming_matches_jax(T, sps):
    rng = np.random.default_rng(T)
    t = jtaps.rrc_taps(T, float(sps), 0.25).astype(np.complex64)
    H = jpulse.polyphase_taps(t, sps)
    sym = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(
        np.complex64)
    jctx = jpulse.pulse_init_ctx(T, sps)
    tctx = tpulse.pulse_init_ctx(T, sps, device=CPU)
    for i in range(4):
        blk = sym[i * 64:(i + 1) * 64]
        jy, jctx = jpulse.pulse_shape_block(jnp.asarray(blk), H, jctx)
        ty, tctx = tpulse.pulse_shape_block(_t(blk), H, tctx)
        assert ty.dtype == torch.complex64 and ty.shape == (64 * sps,)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
        np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=0)


def test_pulse_shape_apply_matches_jax():
    rng = np.random.default_rng(5)
    t = jtaps.rrc_taps(32, 4.0, 0.25)
    sym = (rng.normal(size=100) + 1j * rng.normal(size=100))
    want = np.asarray(jpulse.pulse_shape_apply(jnp.asarray(sym), t, 4))
    got = tpulse.pulse_shape_apply(_t(sym), t, 4)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


# ----------------------------------------------------------------- mixer

@pytest.mark.parametrize("dph", [0.0, 0.01, 1.2345678, -0.5, 7.0])
def test_mixer_ramp_and_advance_equal_jax(dph):
    jr, ja = jmix.mixer_ramp(1000, dph)
    tr, ta = tmix.mixer_ramp(1000, dph)
    np.testing.assert_array_equal(tr, jr)
    assert ta == ja and tmix.normalize_dphase(dph) == jmix.normalize_dphase(
        dph)


def test_mixer_block_chain_matches_jax():
    rng = np.random.default_rng(6)
    n, dph = 1000, 0.777
    ramp, adv = jmix.mixer_ramp(n, dph)
    jp = jnp.float32(0.4)
    tp = torch.tensor(0.4, dtype=torch.float32)
    for _ in range(3):
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64)
        jy, jp = jmix.mixer_block(jnp.asarray(x), jp, ramp, adv)
        ty, tp = tmix.mixer_block(_t(x), tp, ramp, adv)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
        assert abs(float(tp) - float(jp)) < 1e-6


def test_nco_block_chain_matches_jax():
    rng = np.random.default_rng(7)
    jp = jnp.float32(1.0)
    tp = torch.tensor(1.0, dtype=torch.float32)
    for _ in range(3):
        perr = (0.01 * rng.normal(size=500)).astype(np.float32)
        jiq, jp = jmix.nco_block(jnp.asarray(perr), jp, 0.3)
        tiq, tp = tmix.nco_block(_t(perr), tp, 0.3)
        np.testing.assert_allclose(tiq.numpy(), np.asarray(jiq), atol=1e-4)
        assert abs(float(tp) - float(jp)) < 1e-5


@pytest.mark.parametrize("ph", [0.0, 0.6, 3.0, 6.28, -1.0, 100.0])
def test_fixed_point_words_equal_jax(ph):
    assert tmix.phase_fix_init(ph) == tuple(
        int(w) for w in jmix.phase_fix_init(ph))
    for n in (1, 8192, 16_777_216):
        assert tmix.advance_fix(n, ph) == tuple(
            int(w) for w in jmix.advance_fix(n, ph))


def test_fixed_point_add_and_angle_equal_jax():
    rng = np.random.default_rng(8)
    p = (0, 0xFFFFFFFF)
    assert tmix.add_fix(p, (0, 1)) == (1, 0)
    assert tmix.add_fix((0xFFFFFFFF, 0xFFFFFFFF), (0, 1)) == (0, 0)
    for _ in range(50):
        p = tuple(int(v) for v in rng.integers(0, 1 << 32, 2,
                                                dtype=np.uint64))
        a = tuple(int(v) for v in rng.integers(0, 1 << 32, 2,
                                                dtype=np.uint64))
        jp = (jnp.uint32(p[0]), jnp.uint32(p[1]))
        ja = (np.uint32(a[0]), np.uint32(a[1]))
        assert tmix.add_fix(p, a) == tuple(int(w)
                                           for w in jmix.add_fix(jp, ja))
        ang = tmix.phase_fix_to_angle(p)
        assert isinstance(ang, np.float32)
        assert ang == np.float32(jmix.phase_fix_to_angle(jp))


def test_mixer_block_fix_chain_matches_jax():
    rng = np.random.default_rng(9)
    n, dph = 4096, 1.2345678
    ramp, _ = jmix.mixer_ramp(n, dph)
    adv = jmix.advance_fix(n, dph)
    jp, tp = jmix.phase_fix_init(0.3), tmix.phase_fix_init(0.3)
    for _ in range(4):
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64)
        jy, jp = jmix.mixer_block_fix(jnp.asarray(x), jp, ramp, adv)
        ty, tp = tmix.mixer_block_fix(_t(x), tp, ramp,
                                      tmix.advance_fix(n, dph))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
        assert tp == tuple(int(w) for w in jp)


# ------------------------------------------------------------------ prns

@pytest.mark.parametrize("poly,width,block,seed", [
    (0xC0, 8, 256, 0xFF), (0xC0, 8, 128, 0x01), (0xC000, 16, 200, 0x0001),
    (0xB8, 8, 1000, 0x5A)])
def test_prn_block_chain_matches_jax_and_oracle(poly, width, block, seed):
    js = jprns.PrnSpec.make(poly, width, block)
    ts = tprns.PrnSpec.make(poly, width, block)
    np.testing.assert_array_equal(ts.out_matrix, js.out_matrix)
    np.testing.assert_array_equal(ts.adv_matrix, js.adv_matrix)
    jst, tst = js.init_state(seed), ts.init_state(seed, device=CPU)
    got = []
    for _ in range(3):
        jb, jst = jprns.prn_block(js, jst)
        tb, tst = tprns.prn_block(ts, tst)
        assert tb.dtype == torch.int8
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        got.append(tb.numpy())
    np.testing.assert_array_equal(
        np.concatenate(got), tprns.prn_bits_host(poly, seed, width,
                                                 3 * block))


def test_prn_host_oracle_and_shard_shifts_equal_jax():
    np.testing.assert_array_equal(tprns.prn_bits_host(0xC0, 0x01, 8, 300),
                                  jprns.prn_bits_host(0xC0, 0x01, 8, 300))
    js = jprns.PrnSpec.make(0xC0, 8, 256)
    ts = tprns.PrnSpec.make(0xC0, 8, 256)
    np.testing.assert_array_equal(tprns.shard_shift_matrices(ts, 8),
                                  jprns.shard_shift_matrices(js, 8))
    with pytest.raises(ValueError):
        tprns.shard_shift_matrices(ts, 3)


# --------------------------------------------------------------- txshape

@pytest.mark.parametrize("T,sps,B", [(32, 4, 2), (31, 4, 2), (32, 8, 2),
                                     (5, 2, 2), (32, 4, 1)])
def test_tx_shape_matrices_equal_jax(T, sps, B):
    t = jtaps.rrc_taps(T, float(sps), 0.25)
    jm = jtx.tx_shape_matrices(t, sps, bits_per_sym=B)
    tm = ttx.tx_shape_matrices(t, sps, bits_per_sym=B)
    for f in jm._fields:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert a == b
    # the exact split: G_hi + G_lo is G to far below float32's rounding
    C = tm.G.shape[1]
    G64 = tm.G_split[:, :C].astype(np.float64) + tm.G_split[:, C:]
    np.testing.assert_allclose(G64, tm.G, rtol=0, atol=1e-7)


@pytest.mark.parametrize("nbits,T,sps", [(1024, 32, 4), (2000, 31, 4),
                                         (512, 32, 8), (96, 5, 2)])
def test_tx_shape_block_matches_jax(nbits, T, sps):
    rng = np.random.default_rng(nbits)
    t = jtaps.rrc_taps(T, float(sps), 0.25)
    bits = rng.integers(0, 2, nbits).astype(np.float32)
    jm = jtx.tx_shape_matrices(t, sps, bits_per_sym=2)
    tm = ttx.tx_shape_matrices(t, sps, bits_per_sym=2)
    jre, jim, jctx, jn = jtx.tx_shape_block(
        jnp.asarray(bits), jnp.full((jm.ctx_bits,), 0.5, jnp.float32), jm)
    tre, tim, tctx, tn = ttx.tx_shape_block(
        _t(bits), torch.full((tm.ctx_bits,), 0.5), tm)
    assert tn == jn and tre.shape == jre.shape
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=TOL_F32)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=TOL_F32)
    np.testing.assert_array_equal(tctx.numpy(), np.asarray(jctx))


def test_tx_shape_block_is_the_exact_product():
    # the planes equal the float64 product of the split operand, rounded
    # once (so any summation order gives the same floats)
    rng = np.random.default_rng(12)
    tm = ttx.tx_shape_matrices(jtaps.rrc_taps(32, 4.0, 0.25), 4, 2)
    bits = rng.integers(0, 2, 4096).astype(np.float32)
    ctx = np.full(tm.ctx_bits, 0.5, np.float32)
    re, im, _, _ = ttx.tx_shape_block(_t(bits), _t(ctx), tm)
    ext = np.concatenate([ctx, bits]).astype(np.float64)
    R = re.shape[0]
    ext = np.pad(ext, (0, (R - 1) * tm.stride + tm.width - ext.size))
    W = np.stack([ext[r * tm.stride:r * tm.stride + tm.width]
                  for r in range(R)])
    C = tm.G.shape[1]
    hi = (W @ tm.G_split[:, :C].astype(np.float64)).astype(np.float32)
    lo = (W @ tm.G_split[:, C:].astype(np.float64)).astype(np.float32)
    Y = (hi + lo) - tm.off
    np.testing.assert_array_equal(re.numpy(), Y[:, :128])
    np.testing.assert_array_equal(im.numpy(), Y[:, 128:])


def test_bpsk_shape_block_has_no_im_plane():
    rng = np.random.default_rng(13)
    t = jtaps.rrc_taps(32, 4.0, 0.25)
    bits = rng.integers(0, 2, 300).astype(np.float32)
    jm = jtx.tx_shape_matrices(t, 4, bits_per_sym=1)
    tm = ttx.tx_shape_matrices(t, 4, bits_per_sym=1)
    jre, _, _, _ = jtx.tx_shape_block(
        jnp.asarray(bits), jnp.full((jm.ctx_bits,), 0.5, jnp.float32), jm)
    tre, tim, _, nv = ttx.tx_shape_block(
        _t(bits), torch.full((tm.ctx_bits,), 0.5), tm)
    assert tim is None and nv == 1200
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=TOL_F32)


@pytest.mark.parametrize("cut", [32, 256, 300])
def test_tx_shape_streaming_block_invariance(cut):
    # output does not depend on where the stream is cut
    rng = np.random.default_rng(14)
    tm = ttx.tx_shape_matrices(jtaps.rrc_taps(32, 4.0, 0.25), 4, 2)
    bits = _t(rng.integers(0, 2, 512).astype(np.float32))
    ctx0 = torch.full((tm.ctx_bits,), 0.5)
    a, _, c1, n1 = ttx.tx_shape_block(bits[:cut], ctx0, tm)
    b, _, _, n2 = ttx.tx_shape_block(bits[cut:], c1, tm)
    whole, _, _, nv = ttx.tx_shape_block(bits, ctx0, tm)
    chopped = torch.cat([a.reshape(-1)[:n1], b.reshape(-1)[:n2]])
    assert torch.equal(chopped, whole.reshape(-1)[:nv])


@pytest.mark.parametrize("dph,ph0,n", [(1.0, 0.5, 4 * 128 * 3),
                                       (0.0, 1.2, 512), (2.7, 0.0, 4000),
                                       (0.01, 0.6, 8192)])
def test_mixer_tables_and_mix_planar_match_jax(dph, ph0, n):
    rng = np.random.default_rng(15)
    jt = jtx.mixer_tables(n, dph, 128)
    tt = ttx.mixer_tables(n, dph, 128)
    for f in ("cos_row", "sin_row", "cos_col", "sin_col"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    assert tt.adv == tuple(int(w) for w in jt.adv)
    R = -(-n // 128)
    yre = rng.standard_normal((R, 128)).astype(np.float32)
    yim = rng.standard_normal((R, 128)).astype(np.float32)
    jp, tp = jmix.phase_fix_init(ph0), tmix.phase_fix_init(ph0)
    for _ in range(3):
        jre, jim, jp = jtx.mix_planar(jnp.asarray(yre), jnp.asarray(yim),
                                      jp, jt)
        tre, tim, tp = ttx.mix_planar(_t(yre), _t(yim), tp, tt)
        np.testing.assert_allclose(tre.numpy(), np.asarray(jre),
                                   atol=4 * TOL_F32)
        np.testing.assert_allclose(tim.numpy(), np.asarray(jim),
                                   atol=4 * TOL_F32)
        assert tp == tuple(int(w) for w in jp)
    # BPSK's planes: no im plane in
    got = ttx.mix_planar(_t(yre), None, tp, tt)[:2]
    want = jtx.mix_planar(jnp.asarray(yre), None, jp, jt)[:2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=4 * TOL_F32)


@pytest.mark.parametrize("im", [True, False])
def test_quantize_pack_equals_jax(im):
    rng = np.random.default_rng(16)
    yre = (rng.standard_normal((4, 128)) * 5).astype(np.float32)
    yim = (rng.standard_normal((4, 128)) * 5).astype(np.float32)
    jp = jtx.quantize_pack_iq(jnp.asarray(yre),
                              jnp.asarray(yim) if im else None, 8192.0, 500)
    tp = ttx.quantize_pack_iq(_t(yre), _t(yim) if im else None, 8192.0, 500)
    assert tp.dtype == torch.int32 and tp.shape == (500,)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    pairs = ttx.unpack_iq(tp)
    np.testing.assert_array_equal(pairs, jtx.unpack_iq(np.asarray(jp)))
    # saturation and sign survive the pack
    assert (pairs[:, 0] == 32767).any() and (pairs[:, 0] == -32768).any()
    if im:
        assert (pairs[:, 1] < 0).any()


def test_tx_shape_validation():
    t = jtaps.rrc_taps(32, 4.0, 0.25)
    with pytest.raises(ValueError):
        ttx.tx_shape_matrices(t, 4, bits_per_sym=3)
    with pytest.raises(ValueError):
        ttx.tx_shape_matrices(t, 3, bits_per_sym=2, samples_per_row=128)
    with pytest.raises(ValueError):
        ttx.tx_shape_matrices(t.astype(np.complex128) + 1j, 4,
                              bits_per_sym=2)
    tm = ttx.tx_shape_matrices(t, 4, bits_per_sym=2)
    with pytest.raises(ValueError):
        ttx.tx_shape_block(torch.zeros(33), torch.zeros(tm.ctx_bits), tm)
