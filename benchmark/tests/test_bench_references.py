"""The plain references at tiny sizes: against their definitions
written another way (numpy), and against the port's CPU path over
several chained blocks, the state carried by the program and worked
out again by the reference."""

import numpy as np
import pytest
import torch

from benchlib import serve

M = serve.Manifest()


def _ring(config, blocks, block, seed):
    cfg = M.config(config)
    return cfg, M.capture(cfg["input"]["capture"]).make(
        cfg["input"], blocks, block, seed, torch.device("cpu"))


def test_channelizer_is_mix_filter_decimate():
    ref = M.reference("band_monitor_k64")
    K, Mb = 8, 4
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64 * K))
    xr, xi = (torch.from_numpy(v) for v in x)
    yr, yi = ref.channelize(xr, xi, K, Mb, serve_prec("float64"))
    h = ref.hamming_sinc(K, Mb)
    z = x[0] + 1j * x[1]
    n = np.arange(z.shape[0])
    for k in range(K):
        w = np.convolve(z * np.exp(-2j * np.pi * k * n / K), h)[:z.shape[0]]
        got = yr[:, k].numpy() + 1j * yi[:, k].numpy()
        np.testing.assert_allclose(got, w[::K], atol=1e-12)


def test_decimate_and_demod_definitions():
    from benchlib.dsp import decimate, demod

    rng = np.random.default_rng(4)
    x = rng.normal(size=40)
    taps = rng.normal(size=7)
    got = decimate(torch.from_numpy(x), taps, 4, serve_prec("float64"))
    want = np.convolve(x, taps)[:40][::4]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    z = np.exp(1j * np.cumsum(rng.uniform(-1, 1, size=30)))
    d = demod(torch.from_numpy(z.real), torch.from_numpy(z.imag)).numpy()
    prev = np.concatenate([[0], z[:-1]])
    np.testing.assert_allclose(d, np.angle(z * np.conj(prev)), atol=1e-12)


def serve_prec(name):
    from benchlib import precision
    return precision.get(name)


@pytest.mark.parametrize("config,path,block", [
    ("band_monitor_k64", "band_monitor_staged", 20480),
    ("fm_radio_rtlsdr", "fm_make_pipeline", 51200),
])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_reference_holds_the_port_across_chained_blocks(config, path, block,
                                                        seed):
    cfg, ring = _ring(config, 3, block, seed)
    cfg["block_samples"] = block
    served = M.path(path).Served(cfg, torch.device("cpu"))
    ref = M.reference(config)
    state = served.init_state()
    for g in range(5):            # the ring wraps: 0 1 2 0 1
        y, state = served.step(state, served.item(ring, g % 3))
        want = ref.block_output(ring, g, cfg, "float64")
        assert y.shape == want.shape
        assert serve.rel_err(y, want) < cfg["check"]["max_rel_err"] / 10


def test_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "from benchlib import serve\n"
        "m = serve.Manifest()\n"
        "for c in ('band_monitor_k64', 'fm_radio_rtlsdr'):\n"
        "    m.reference(c)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('comms_tpu_torch', 'comms_tpu', 'jax', 'jaxlib', 'flax')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n") % str(serve.BENCH)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
