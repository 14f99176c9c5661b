"""parallel.qpsk_rx_sharded: the time-sharded QPSK receiver against the
JAX package's on the 8-device CPU mesh, at the JAX test's size and
impairments (tests/test_sharding.py), with the same numpy inputs.

Bounds: zero bit errors; the estimates as JAX's (carrier 1e-6 rad/sample,
timing 1e-5 samples, fine carrier 1e-6 rad/symbol, phase 1e-4 rad, the
symbol phase equal) and the symbols within 1e-4 of the largest symbol:
both sides run the same float32 operations in other summation orders
(measured 2e-9, 0, 7e-9, 4e-6 and 5e-6 on the CPU).  Against the
port's one-device receiver, the JAX test's 5% away from the block edges
(the estimates differ by the panels' edge terms at shard boundaries)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import qpsk_rx as jrx
from comms_tpu.models import qpsk_tx
from comms_tpu.ops import random as crandom
from comms_tpu.parallel import qpsk_rx_sharded as jqs
from comms_tpu.parallel import sharding as jsh
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.parallel import qpsk_rx_sharded as tqs
from comms_tpu_torch.parallel import sharding as tsh


def _capture():
    nbits = 16384
    tcfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = qpsk_tx.make_block_fn(tcfg)(qpsk_tx.init_state(tcfg, 2))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    bits, _ = crandom.random_bits_block(crandom.source_init(2), nbits)
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.007 * n + 0.5))).astype(np.complex64)
    return (xc.real.astype(np.float32), xc.imag.astype(np.float32),
            np.asarray(bits))


def test_sharded_rx_matches_jax_with_zero_ber():
    re, im, bits = _capture()
    js, jd = jqs.make_sharded_rx_step(jrx.QpskRxConfig(), jsh.time_mesh(8))(
        jnp.asarray(re), jnp.asarray(im))
    cfg = trx.QpskRxConfig()
    step = tqs.make_sharded_rx_step(cfg, tsh.time_mesh(8, device="cpu"))
    launches = HR.launches
    ts, td = step(torch.from_numpy(re), torch.from_numpy(im))
    assert HR.launches == launches           # CPU shards: the plain ring
    assert ts.shape == (2, re.shape[0] // cfg.sps)

    best = trx.resolve_ambiguity(ts, bits, search=1500)
    assert best[1] == 0, best

    tol = {"freq": 1e-6, "timing": 1e-5, "freq_fine": 1e-6, "phase": 1e-4}
    for k, t in tol.items():
        assert abs(float(td[k]) - float(jd[k])) < t, (k, td[k], jd[k])
    assert int(td["sym_phase"]) == int(jd["sym_phase"])
    js = np.asarray(js)
    assert np.max(np.abs(ts.numpy() - js)) < 1e-4 * np.abs(js).max()

    one, _ = trx.make_rx_fn_planar(cfg)(torch.from_numpy(re),
                                        torch.from_numpy(im))
    a = ts[0] + 1j * ts[1]
    b = one[0] + 1j * one[1]
    assert float((a - b)[16:-16].abs().max()) < 0.05 * float(b.abs().max())


@pytest.mark.parametrize("shard_len", [65536, 50000])
def test_sharded_slope_fit_is_the_global_fit(shard_len):
    # The residual-slope fit over shards (global segment sums, segments
    # straddling shard boundaries when the shards are not whole segments)
    # against the one-device fit of the concatenated block; float32 sums
    # in other orders, 1e-9 rad/symbol.
    shards = 3
    g = torch.Generator().manual_seed(4)
    n = shards * shard_len
    k = torch.arange(n, dtype=torch.float64)
    ph = 4 * (3e-6 * k + 0.2) + 0.05 * torch.randn(n, generator=g,
                                                   dtype=torch.float64)
    q4r, q4i = torch.cos(ph).float(), torch.sin(ph).float()
    want = trx._phase_slope(q4r, q4i)
    parts = [(q4r[s * shard_len:(s + 1) * shard_len],
              q4i[s * shard_len:(s + 1) * shard_len]) for s in range(shards)]
    mesh = tsh.time_mesh(shards, device="cpu")
    got = trx._phase_slope_sharded(
        parts, [s * shard_len for s in range(shards)],
        lambda p: tsh.psum(p, mesh)[0])
    assert abs(float(got) - float(want)) < 1e-9
    assert abs(float(got) - 3e-6) < 1e-7
    assert trx._phase_slope_sharded(parts[:1], [0], lambda p: p[0]) is None


def test_sharded_rx_validations():
    mesh = tsh.time_mesh(8, device="cpu")
    step = tqs.make_sharded_rx_step(trx.QpskRxConfig(), mesh)
    with pytest.raises(ValueError, match="multiple of sps"):
        step(torch.zeros(8 * 2050), torch.zeros(8 * 2050))
    with pytest.raises(ValueError, match="4 <= sps"):
        tqs.make_sharded_rx_step(trx.QpskRxConfig(sps=2), mesh)
