"""The cell ``costas_gateway_b4096``: its controls (the plain reference
with TF32 products, with bfloat16 stages) come out not correct while the
program comes out correct, on the CPU at a small size and on the card
(``cuda``) at the cell's own; its capture is one period of a continuous
periodic signal; the Costas kernel's cost against hand arithmetic; its
entries in the manifest; and, on the card, a round of 4,096 carriers
as one Costas launch with no host synchronisation."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from benchlib import calib, recurrence_cost, serve

CELL = "costas_gateway_b4096"
M = serve.Manifest()
CFG = M.config("qpsk_costas_gateway")
LIMIT = CFG["check"]["max_rel_err"]
SMALL = {"streams": 3, "block_samples": 1024,
         "input": dict(CFG["input"], carrier_samples=1024)}
SEEDS = (101, 2 ** 31 + 202, 3_000_000_303)


class _Settled(serve.Manifest):
    """The cell's traffic with a warm-up as long as the reference's
    settling run, so that the checked blocks are on the settled orbit."""

    def traffic(self, name):
        tr = super().traffic(name)
        return dict(tr, warmup_blocks=CFG["check"]["settle_blocks"]
                    + tr["ring_blocks"])


def _program(seed, device, sizes=None, seconds=0.2):
    return serve.run_cell(CELL, seed, seconds, False, t0=time.perf_counter(),
                          manifest=_Settled(), device=device, sizes=sizes)


@pytest.mark.parametrize("seed", SEEDS[:1])
def test_controls_fail_and_program_passes(seed):
    got = calib.control_readings(CELL, seed, ("tf32", "bfloat16"),
                                 device="cpu", sizes=SMALL)
    assert got["tf32"] > LIMIT and got["bfloat16"] > LIMIT, got
    result, compared = _program(seed, "cpu", SMALL)
    assert result["correct"], compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_controls_fail_and_program_passes_at_the_cells_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = calib.control_readings(CELL, seed, ("tf32", "bfloat16"))
    assert got["tf32"] > LIMIT and got["bfloat16"] > LIMIT, got
    result, compared = _program(seed, None, seconds=2.0)
    assert result["correct"], compared


def _out_of_band(iq, omega, params):
    """Share of the energy of each carrier's ring blocks laid end to end
    (one period) in the DFT bins more than 0.02 cycles a sample outside
    the shaped band around its carrier."""
    R, B, N, _ = iq.shape
    x = torch.complex(iq[..., 0], iq[..., 1]).permute(1, 0, 2).reshape(B, -1)
    X = torch.fft.fft(x).abs().square()
    f = torch.fft.fftfreq(R * N, dtype=torch.float64)
    edge = (1 + params["beta"]) / (2 * params["sps"]) + 0.02
    away = ((f[None] - omega[:, None] / (2 * math.pi) + 0.5) % 1 - 0.5).abs()
    return float(X[away > edge].sum() / X.sum())


def test_capture_is_one_period_of_a_continuous_signal():
    """Noise-free, the ring's blocks laid end to end are one period of a
    band-limited signal: outside the band lies what the 32-tap pulse
    itself leaks (its |H|^2 there), and a seam anywhere, the wrap
    included, would add to it (two blocks swapped: 4.6 times as much)."""
    cap = M.capture("qpsk_carriers_planes")
    params = dict(SMALL["input"], esn0_db=300.0)
    R, N, B = 4, 1024, 5
    ring = cap.make(params, R, B * N, 77, torch.device("cpu"))
    iq = ring["iq"].double()
    assert iq.shape == (R, B, N, 2)
    L = R * N
    k = ring["omega"] * L / (2 * math.pi)
    assert torch.allclose(k, k.round(), atol=1e-9)
    assert ring["omega"].abs().max() <= params["max_omega"]
    H = torch.fft.fft(cap.rrc(params["num_taps"], params["sps"],
                              params["beta"], "cpu"), L).abs().square()
    f = torch.fft.fftfreq(L, dtype=torch.float64)
    edge = (1 + params["beta"]) / (2 * params["sps"]) + 0.02
    leak = float(H[f.abs() > edge].sum() / H.sum())
    assert _out_of_band(iq, ring["omega"], params) < 1.2 * leak
    for broken in (iq[[0, 2, 1, 3]], torch.roll(iq, 100, dims=2)):
        assert _out_of_band(broken, ring["omega"], params) > 2 * leak
    # the same seed, the same ring; another seed, another
    again = cap.make(params, R, B * N, 77, torch.device("cpu"))["iq"]
    other = cap.make(params, R, B * N, 78, torch.device("cpu"))["iq"]
    assert torch.equal(again, ring["iq"]) and not torch.equal(other,
                                                              ring["iq"])


def test_costas_cost_against_hand_arithmetic():
    nbytes, flops = recurrence_cost.costas(streams=4096, steps=2048)
    # 4 float32 planes a step and the 4 state words a stream
    assert nbytes == 4 * 4096 * (4 * 2048 + 4) == 134_283_264
    # 29 float32 operations a step a stream
    assert flops == 29 * 4096 * 2048 == 243_269_632
    assert recurrence_cost.costas(1, 1) == (32, 29)
    # the bound is the bytes' (40.1 us at 3.35 TB/s)
    from benchlib import device
    t, by = device.bound_s(nbytes, flops)
    assert by == "bytes" and abs(t - 134_283_264 / 3.35e12) < 1e-12


def _run(blocks, ms, names=("costas_loop_kernel",), launches=None):
    ops = [SimpleNamespace(short=n, seconds=ms / 1e3)
           for _ in range(blocks) for n in names]
    return SimpleNamespace(
        trace=SimpleNamespace(device_ops=ops, blocks=blocks),
        launches=launches or [("costas", dict(streams=4096, steps=2048))])


def test_costas_roofline_reads_one_launch_a_round():
    bound = 134_283_264 / 3.35e12
    got = recurrence_cost.roofline_pct(_run(48, 0.44))
    assert abs(got - 100 * bound / 0.44e-3) < 1e-9
    # not one launch a round, or no trace: nothing
    assert recurrence_cost.roofline_pct(_run(48, 0.44, names=(
        "costas_loop_kernel", "costas_loop_kernel"))) is None
    assert recurrence_cost.roofline_pct(_run(48, 0.44, names=())) is None
    assert recurrence_cost.roofline_pct(
        SimpleNamespace(trace=None, launches=[])) is None


def test_manifest_has_the_gateway_entries():
    data = json.loads((serve.ROOT / "BENCHMARK.json").read_text())

    def named(kind, name):
        return next(e for e in data[kind] if e["name"] == name)

    assert named("configs", "qpsk_costas_gateway")["reduced"] == \
        CFG["reduced"] == []
    w = named("workloads", CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "qpsk_costas_gateway", "gateway_device_ring", 1)
    added = {n: named("per_layer", n)
             for n in ("costas_roofline", "rx_stages_host_ms")}
    assert all(m["workloads"] == [CELL] for m in added.values())
    assert {m["name"] for m in M.per_layer(CELL)} >= set(added) | {
        m["name"] for m in data["per_layer"] if "workloads" not in m}
    assert M.traffic("gateway_device_ring")["path"] == "costas_gateway_vmap"
    assert CFG["streams"] * CFG["block_samples"] == 33_554_432


@pytest.mark.cuda
def test_a_round_of_4096_carriers_is_one_costas_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from comms_tpu_torch.kernels import recurrence as R

    dev = torch.device("cuda", 0)
    served = M.path("costas_gateway_vmap").Served(CFG, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = 0.3 * torch.randn((4096, 8192, 2), generator=g, device=dev)
    state = served.init_state()
    y, state = served.step(state, x)          # constants onto the card
    torch.cuda.synchronize()
    n0, l0 = R.launches["costas_loop"], R.lanes["costas_loop"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, state = served.step(state, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (R.launches["costas_loop"] - n0, R.lanes["costas_loop"] - l0) \
        == (1, 4096)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y, state = served.step(state, x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "costas_loop_kernel" in e.name]
    assert len(kernels) == 1
    assert y.shape == (4096, 2048, 2) and bool(torch.isfinite(y).all())
