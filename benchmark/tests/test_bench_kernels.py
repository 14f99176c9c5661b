"""The bytes and operations of K2's and K8's launches, counted by hand
at the cells' shapes, and the bound against the published peaks."""

import math

import pytest

from benchlib import device, kernels


def test_k2_band_monitor_audio_launch():
    # 32 rows of channel pairs, 262,144 frames a row, both planes read
    # and 65,536 outputs a plane written; the 31-sample context in and
    # out; 32 real taps.
    nbytes, flops = kernels.decim_fir(rows=32, n=262144, dec=4, taps=32,
                                      planes=2, ctx=31)
    assert nbytes == 4 * (32 * 2 * (262144 + 65536 + 62) + 32)
    assert flops == 2 * (2 * 32) * 32 * 65536
    t, by = device.bound_s(nbytes, flops)
    assert by == "bytes"
    assert t == pytest.approx(83_894_656 / 3.35e12, rel=1e-3)


def test_k2_fm_stages():
    n = 26_214_400
    b1, f1 = kernels.decim_fir(rows=1, n=n, dec=5, taps=63, planes=2, ctx=64)
    assert b1 == 4 * (2 * (n + n // 5 + 128) + 63)
    assert f1 == 2 * 2 * 63 * (n // 5)
    # the second stage is a real stream: one plane
    b2, f2 = kernels.decim_fir(rows=1, n=n // 5, dec=5, taps=63, planes=1,
                               ctx=64)
    assert b2 == 4 * ((n // 5) + (n // 25) + 128 + 63)
    assert f2 == 2 * 63 * (n // 25)
    assert device.bound_s(b1, f1)[0] * 1e3 == pytest.approx(0.0751, rel=2e-3)
    assert device.bound_s(b2, f2)[0] * 1e3 == pytest.approx(0.0075, rel=2e-2)


def test_k2_complex_taps_count_complex_products():
    _, f = kernels.decim_fir(rows=1, n=1000, dec=5, taps=7, planes=2,
                             complex_taps=True)
    assert f == 2 * 4 * 7 * 200


def test_k8_band_monitor_launch():
    n, k, m = 16_777_216, 64, 8
    nbytes, flops = kernels.channelizer(n=n, k=k, taps_per_branch=m,
                                        ctx=511)
    # planes in, [n/k, k] re and im out, the context read, the prototype
    assert nbytes == 4 * (2 * n + 2 * n + 2 * 511 + 512)
    assert flops == 2 * 2 * m * n + 5 * k * math.log2(k) * (n // k)
    t, by = device.bound_s(nbytes, flops)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.0801, rel=2e-3)


def test_bound_by_operations():
    t, by = device.bound_s(0, 67e12)
    assert (t, by) == (pytest.approx(1.0), "operations")
    t, by = device.bound_s(3.35e12, 67e12 / 2)
    assert (t, by) == (pytest.approx(1.0), "bytes")


def test_cost_dispatches_by_key():
    s = dict(rows=1, n=5120, dec=5, taps=63, planes=2, ctx=64)
    assert kernels.cost("k2", s) == kernels.decim_fir(**s)
