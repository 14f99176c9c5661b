"""The batched recurrences (``kernels.recurrence``): the batched plain
versions, one PyTorch operation a step over ``[B]`` tensors, against B
single-stream plain calls bit for bit and against ``jax.vmap`` of the JAX
package's loops; the batched vmap rule (``batched_vmap_rule``) on a CPU
stand-in op: one call per vmapped call, equal to the plain version a
stream.

Bit for bit: the batched plain version runs the single-stream version's
operations in the same order, on [B] tensors instead of 0-d ones, and at
B <= 5 PyTorch's CPU kernels take the same per-element path for both.
Against JAX: TOL_LOOP = 2e-5 on outputs and states, as in
test_torch_costas.py (XLA's float32 sin/cos/atan2/log/exp differ from
the C library's by an ulp here and there; a locked loop damps the
difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comms_tpu.ops import agc as jagc
from comms_tpu.ops import demodulation as jdem
from comms_tpu_torch.kernels import recurrence as R

TOL_LOOP = 2e-5
ALPHA, BETA = 0.1, 0.005


def _locked(B, n, seed, order=4):
    """[B, n] complex64: M-PSK symbols (QPSK at +-1+-1j) turned by a
    carrier offset of its own a stream, with noise of sigma 0.05."""
    rng = np.random.default_rng(seed)
    if order == 4:
        b = rng.integers(0, 2, size=(2, B, n))
        s = (2 * b[0] - 1) + 1j * (2 * b[1] - 1)
    else:
        s = np.exp(2j * np.pi * rng.integers(0, order, size=(B, n)) / order)
    cfo = rng.uniform(-3e-3, 3e-3, size=(B, 1))
    s = s * np.exp(1j * (0.3 + cfo * np.arange(n)))
    s = s + 0.05 * (rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n)))
    return s.astype(np.complex64)


def _agc_input(B, n, seed):
    rng = np.random.default_rng(seed)
    amp = np.where(np.arange(n) < n // 2, 0.1, 2.0)
    x = (amp * np.exp(1j * (0.3 * np.arange(n)
                            + rng.uniform(0, 6, size=(B, 1))))
         + 0.01 * rng.normal(size=(B, n)))
    return x.astype(np.complex64)


def _planes(x, layout):
    """The re/im planes of complex [B, n] ``x`` as torch tensors:
    contiguous, the stride-2 views of a complex tensor, or rows of a wider
    buffer (a row stride larger than n)."""
    t = torch.from_numpy(x)
    if layout == "views":
        v = torch.view_as_real(t)
        return v[..., 0], v[..., 1]
    if layout == "row_stride":
        B, n = x.shape
        buf = torch.zeros(2, B, n + 7)
        buf[0, :, 3:3 + n] = t.real
        buf[1, :, 3:3 + n] = t.imag
        return buf[0, :, 3:3 + n], buf[1, :, 3:3 + n]
    return t.real.contiguous(), t.imag.contiguous()


def _states(B, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-0.2, 0.2, B).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1e-3, 1e-3, B).astype(np.float32)))


@pytest.mark.parametrize("layout", ["contiguous", "views", "row_stride"])
@pytest.mark.parametrize("n", [0, 1, 17, 300])
@pytest.mark.parametrize("B", [1, 3, 5])
def test_costas_batched_plain_equals_single_calls(B, n, layout):
    xr, xi = _planes(_locked(B, n, 10 * B + n), layout)
    ph, fr = _states(B, n)
    for order in (4, 2):
        yr, yi, ph1, fr1 = R.costas_loop_batched_plain(xr, xi, ph, fr, ALPHA,
                                                       BETA, order)
        assert yr.shape == (B, n) and ph1.shape == (B,)
        for b in range(B):
            w = R.costas_loop_plain(xr[b], xi[b], ph[b], fr[b], ALPHA, BETA,
                                    order)
            assert torch.equal(yr[b], w[0]) and torch.equal(yi[b], w[1])
            assert torch.equal(ph1[b], w[2]) and torch.equal(fr1[b], w[3])
        # the CPU wrapper takes the batched plain version
        got = R.costas_loop_batched(xr, xi, ph, fr, ALPHA, BETA, order)
        assert all(torch.equal(g, w) for g, w in
                   zip(got, (yr, yi, ph1, fr1)))


@pytest.mark.parametrize("layout", ["contiguous", "views", "row_stride"])
@pytest.mark.parametrize("n", [0, 1, 17, 300])
@pytest.mark.parametrize("B", [1, 3, 5])
def test_agc_batched_plain_equals_single_calls(B, n, layout):
    xr, xi = _planes(_agc_input(B, n, 20 * B + n), layout)
    g0 = torch.linspace(0.5, 2.0, B)
    yr, yi, g = R.agc_scan_batched_plain(xr, xi, g0, 1.0, 5e-2)
    assert yr.shape == (B, n) and g.shape == (B,)
    for b in range(B):
        w = R.agc_scan_plain(xr[b], xi[b], g0[b], 1.0, 5e-2)
        assert torch.equal(yr[b], w[0]) and torch.equal(yi[b], w[1])
        assert torch.equal(g[b], w[2])
    got = R.agc_scan_batched(xr, xi, g0, 1.0, 5e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, (yr, yi, g)))


@pytest.mark.parametrize("order", [4, 2])
def test_costas_batched_plain_matches_jax_vmap(order):
    B, n = 4, 700
    x = _locked(B, n, 31 + order, order)
    ph, fr = _states(B, 5)
    yj, (phj, frj) = jax.vmap(
        lambda s, p, f: jdem.costas_loop_block(s, (p, f), ALPHA, BETA,
                                               order=order))(
        jnp.asarray(x), jnp.asarray(ph.numpy()), jnp.asarray(fr.numpy()))
    xr, xi = _planes(x, "views")
    yr, yi, ph1, fr1 = R.costas_loop_batched_plain(xr, xi, ph, fr, ALPHA,
                                                   BETA, order)
    yj = np.asarray(yj)
    assert np.abs(yr.numpy() - yj.real).max() <= TOL_LOOP
    assert np.abs(yi.numpy() - yj.imag).max() <= TOL_LOOP
    assert np.abs(ph1.numpy() - np.asarray(phj)).max() <= TOL_LOOP
    assert np.abs(fr1.numpy() - np.asarray(frj)).max() <= TOL_LOOP


@pytest.mark.parametrize("rate", [1e-2, 5e-2])
def test_agc_batched_plain_matches_jax_vmap(rate):
    B, n = 3, 1500
    x = _agc_input(B, n, int(rate * 1e3))
    g0 = np.array([0.5, 1.0, 2.0], np.float32)
    yj, gj = jax.vmap(lambda s, g: jagc.agc_scan(s, g, rate=rate))(
        jnp.asarray(x), jnp.asarray(g0))
    xr, xi = _planes(x, "contiguous")
    yr, yi, g = R.agc_scan_batched_plain(xr, xi, torch.from_numpy(g0), 1.0,
                                         rate)
    yj = np.asarray(yj)
    assert np.abs(yr.numpy() - yj.real).max() <= TOL_LOOP
    assert np.abs(yi.numpy() - yj.imag).max() <= TOL_LOOP
    assert np.abs(g.numpy() - np.asarray(gj)).max() <= TOL_LOOP


_calls = []


@torch.library.custom_op(
    "test_recurrence_batched::costas", mutates_args=(), device_types="cpu",
    schema="(Tensor xr, Tensor xi, Tensor phase, Tensor freq, int order, "
           "float alpha, float beta) -> (Tensor, Tensor, Tensor, Tensor)")
def _costas_stand_in(xr, xi, phase, freq, order, alpha, beta):
    """The Costas op's contract on the CPU (planes [B, n], states [B]):
    the batched plain version, one call recorded."""
    _calls.append(tuple(xr.shape))
    return tuple(t.clone() for t in R.costas_loop_batched_plain(
        xr, xi, phase, freq, alpha, beta, order))


_costas_stand_in.register_vmap(R.batched_vmap_rule(_costas_stand_in))


def _single(xr, xi, ph, fr, order=4):
    """A single-stream call through the stand-in, as ``costas_loop`` makes
    it on the card: [1, n] planes, [1] states."""
    out = _costas_stand_in(xr[None], xi[None], ph.reshape(1), fr.reshape(1),
                           order, ALPHA, BETA)
    return tuple(t[0] for t in out)


def test_batched_vmap_rule_calls_the_op_once():
    B, n = 3, 40
    xr, xi = _planes(_locked(B, n, 3), "views")
    ph, fr = _states(B, 4)
    _calls.clear()
    got = torch.func.vmap(_single)(xr, xi, ph, fr)
    assert _calls == [(B, n)]
    for b in range(B):
        w = R.costas_loop_plain(xr[b], xi[b], ph[b], fr[b], ALPHA, BETA)
        assert all(torch.equal(g[b], v) for g, v in zip(got, w))
    # an argument that is not batched is expanded: one call again
    _calls.clear()
    got = torch.func.vmap(lambda a, p: _single(a, xi[0], p, fr[0], 2))(xr,
                                                                      ph)
    assert _calls == [(B, n)]
    for b in range(B):
        w = R.costas_loop_plain(xr[b], xi[0], ph[b], fr[0], ALPHA, BETA, 2)
        assert all(torch.equal(g[b], v) for g, v in zip(got, w))
    # nested vmap flattens both axes into one call
    _calls.clear()
    got = torch.func.vmap(torch.func.vmap(_single))(
        xr.expand(2, B, n), xi.expand(2, B, n), ph.expand(2, B),
        fr.expand(2, B))
    assert _calls == [(2 * B, n)]
    assert all(torch.equal(g[1], g[0]) for g in got)


def test_batched_entries_refuse_bad_input():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="scalars"):
        R.costas_loop_batched(x, x, torch.zeros(2), torch.zeros(3), 0.1,
                              0.005)
    with pytest.raises(ValueError, match="2-D"):
        R.agc_scan_batched(x[0], x[0], torch.zeros(1))
    with pytest.raises(ValueError, match="shape"):
        R.agc_scan_batched(x, torch.zeros(3, 9), torch.zeros(3))
