"""Multi-shard dry run: every sharded configuration of the port, one or
two steps each on small shapes, on an n-shard mesh in one process.

Counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py`` (the JAX package's), with its sizes and
assertions:

1. the sharded wideband chain (ring halos + estimator psum), streamed,
   and the ``rdma_halo`` build equal to the default bit for bit;
2. the fused FM chain per shard (K1), raw-tail context from the ring;
3. the sharded source-headed ``Pipeline`` (PRN -> BPSK -> pulse shape),
   the sharded ``Nco`` (a cross-shard prefix of the phase errors) and a
   ``Graph`` feedback loop (its value 3.0 after three steps);
4. the corner-turn channelizer (all-to-all), the distributed FFT against
   numpy, and the segment-parallel Welch PSD (K10 per shard);
5. the planar FIR (K4) and decimating FIR (K2) kernels per shard, their
   context from the ring;
6. the fused band monitor per shard (K9), neighbour state from the raw
   tail;
7. the time-sharded QPSK receiver (summed panel estimates + the symbol
   product with ring context);
8. the multi-process wiring: ``multihost.pod_mesh`` and ``host_feed``
   feeding the sharded wideband chain, equal bit for bit to the
   time-mesh path (in one process here; :func:`dryrun_multihost` runs
   it in every process of a process group, the mesh spanning them);
9. the 2-D (time x chan) band monitor against the one-device band
   monitor.

    python -m comms_tpu_torch.parallel.dryrun [--shards 8] [--device cuda]
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.parallel import sharding as sh

__all__ = ["dryrun_multichip", "dryrun_multihost"]


def _normal(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device)


def _dryrun_wideband(n, mesh, device):
    """Config 1: the sharded wideband chain with carried stream state."""
    from comms_tpu_torch.models.fm_receiver import FM_LPF_TAPS
    from comms_tpu_torch.parallel import wideband

    # per-shard 400: divisible by dec1*dec2, and the post-decimation
    # shard (80) still covers the 62-sample audio-FIR halo.
    block = n * 400
    cfg = wideband.WidebandConfig(FM_LPF_TAPS, block=block, dec1=5, dec2=5)
    step = wideband.make_sharded_step(cfg, mesh)
    state = wideband.init_state(cfg, device)
    pairs = _normal(np.random.default_rng(0), (block, 2), device)
    (audio, freq), new_state = step(state, pairs)
    assert torch.isfinite(audio).all()
    assert audio.shape[0] == block // 25
    (audio2, _), _ = step(new_state, pairs)      # the state round-trips
    assert torch.isfinite(audio2).all()
    step_rdma = wideband.make_sharded_step(cfg, mesh, rdma_halo=True)
    (audio_r, freq_r), _ = step_rdma(state, pairs)
    assert torch.equal(audio_r, audio) and torch.equal(freq_r, freq)


def _dryrun_fused(n, mesh, device):
    """Config 2: the fused FM chain per shard."""
    from comms_tpu_torch.parallel import fused_wideband

    N = n * 102400                               # one kernel step a shard
    step = fused_wideband.make_sharded_fused_step(mesh, block=N)
    state = fused_wideband.fused_init_state(device)
    rng = np.random.default_rng(1)
    re = torch.from_numpy(rng.integers(0, 256, size=N, dtype=np.uint8)).to(
        device)
    im = torch.from_numpy(rng.integers(0, 256, size=N, dtype=np.uint8)).to(
        device)
    audio, state = step(state, re, im)
    audio2, _ = step(state, re, im)              # carried state round-trip
    assert torch.isfinite(audio).all() and torch.isfinite(audio2).all()
    assert audio.shape[0] == N // 25


def _dryrun_pipeline(n, mesh, device):
    """Config 3: source-headed Pipeline (PRN -> BPSK -> pulse shape), an
    NCO with the cross-shard prefix sum, and a Graph feedback loop."""
    from comms_tpu_torch.ops import taps
    from comms_tpu_torch.runtime import (BpskMod, Graph, Lambda, Nco,
                                         Pipeline, PrnSource, PulseShape)

    t = taps.rrc_taps(32, 4.0, 0.25).astype(np.complex64)
    pipe = Pipeline([
        PrnSource.make(0xC0, 0x5A, 8, 64 * n),
        BpskMod(),
        PulseShape.make(t, 4),
    ])
    step = pipe.make_sharded_step(mesh)
    s = pipe.init_state(device)
    y, s = step(s, None)
    y2, _ = step(s, None)
    assert y.shape == (256 * n,)
    assert torch.isfinite(torch.view_as_real(y2)).all()

    nco = Pipeline([Nco(dphase=0.37, phase0=1.1)])
    nstep = nco.make_sharded_step(mesh)
    perr = torch.full((128 * n,), 0.01, dtype=torch.float32, device=device)
    z, _ = nstep(nco.init_state(device), perr)
    assert z.shape == (128 * n,)

    g = Graph()
    g.add_input("x")
    g.add_node("sum", lambda a, b: a + b, ["x", "acc"],
               feedback_from={"acc": torch.zeros(8 * n, device=device)},
               elementwise=True)
    g.add_node("acc", Lambda(lambda v: v), ["sum"])
    g.set_outputs(["acc"])
    gstep = g.make_sharded_step(mesh)
    gs = g.init_state(device=device)
    x = torch.ones(8 * n, dtype=torch.float32, device=device)
    for _ in range(3):
        (out,), gs = gstep(gs, {"x": x})
    assert float(out[0]) == 3.0


def _dryrun_channel_parallel(n, mesh, device):
    """Config 4: corner-turn channelizer + distributed FFT + the
    segment-parallel Welch PSD."""
    from comms_tpu_torch.ops import channelizer as chan
    from comms_tpu_torch.parallel import dfft as dfft_mod
    from comms_tpu_torch.parallel import wideband

    K, M = 16, 4
    h = chan.design_prototype(K, M).astype(np.float64)
    Hb = chan.branch_taps(h, K)
    N = n * 8 * K
    rng = np.random.default_rng(2)
    pairs = _normal(rng, (N, 2), device)
    ctx0 = chan.channelizer_init_ctx(len(h), device=device)
    xs = [torch.complex(p[:, 0], p[:, 1])
          for p in sh.shard(pairs, mesh, ("time", None))]
    halos = sh.halo_exchange(xs, ctx0, len(h) - 1, mesh)
    ys = [chan.channelize_block(x, Hb, c)[0] for x, c in zip(xs, halos)]
    yc = sh.corner_turn(ys, mesh)                # [frames_global, K_local]
    y = sh.unshard([torch.stack([v.real, v.imag], -1) for v in yc], mesh,
                   (None, "time", None))
    assert y.shape == (N // K, K, 2)

    fftn = 4096
    x = rng.normal(size=(fftn, 2)).astype(np.float32)
    dfft = dfft_mod.make_dfft(fftn, mesh)
    spec = dfft(torch.complex(*torch.from_numpy(x).to(device).unbind(1)))
    ref = np.fft.fft(x[:, 0] + 1j * x[:, 1])
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(spec.cpu().numpy() - ref)) < 1e-4 * scale

    F = 1 << 16
    psd_fn = wideband.make_sharded_psd_segments(F, mesh, use_kernel=True)
    psd = psd_fn(_normal(rng, (n, F, 2), device))
    assert psd.shape == (F,) and torch.isfinite(psd).all()


def _dryrun_planar_kernels(n, mesh, device):
    """Config 5: the planar FIR and the decimating FIR kernels per shard,
    their context from the ring (zeros on the first shard)."""
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.kernels import fir as FP

    taps = np.hamming(63).astype(np.float32)
    N = n * 8 * 5 * 128
    rng = np.random.default_rng(5)
    xr = sh.shard(_normal(rng, N, device), mesh, ("time",))
    xi = sh.shard(_normal(rng, N, device), mesh, ("time",))
    z = xr[0].new_zeros(1024)
    cr, ci = sh.halo_exchange((xr, xi), (z, z), 1024, mesh)
    ys = [FP.fir_planar(a, b, taps, c.reshape(8, 128), d.reshape(8, 128),
                        tile_rows=8)[:2]
          for a, b, c, d in zip(xr, xi, cr, ci)]
    yr, yi = [y[0] for y in ys], [y[1] for y in ys]
    z = yr[0].new_zeros(640)
    dr, di = sh.halo_exchange((yr, yi), (z, z), 640, mesh)
    out = [DF.fir_decimate_planar(a, b, taps, 5, c.reshape(1, 640),
                                  d.reshape(1, 640), tile_rows=8)[0]
           for a, b, c, d in zip(yr, yi, dr, di)]
    ar = sh.unshard(out, mesh, ("time",))
    assert torch.isfinite(ar).all() and ar.shape == (N // 5,)


def _dryrun_band_monitor(n, mesh, device):
    """Config 6: the fused band monitor per shard, its state from the
    left neighbour's raw tail."""
    from comms_tpu_torch.kernels import band_monitor as BM
    from comms_tpu_torch.models import fm_band_monitor as model
    from comms_tpu_torch.parallel import fused_wideband

    per = BM.step_samples()
    N = n * per
    cfg = model.BandMonitorConfig(block=per)
    step = fused_wideband.make_sharded_band_monitor_step(cfg, mesh, block=N)
    rng = np.random.default_rng(6)
    re, im = _normal(rng, N, device), _normal(rng, N, device)
    st = model.init_state_fused(cfg, device)
    audio, st = step(st, re, im)
    audio2, _ = step(st, re, im)
    assert audio.shape == (cfg.num_channels,
                           N // cfg.num_channels // cfg.audio_dec)
    assert torch.isfinite(audio2).all()


def _dryrun_qpsk_rx(n, mesh, device):
    """Config 7: the time-sharded QPSK receiver."""
    from comms_tpu_torch.models import qpsk_rx
    from comms_tpu_torch.parallel import qpsk_rx_sharded

    cfg = qpsk_rx.QpskRxConfig()
    N = n * 2048
    step = qpsk_rx_sharded.make_sharded_rx_step(cfg, mesh)
    rng = np.random.default_rng(7)
    sym, _ = step(_normal(rng, N, device), _normal(rng, N, device))
    assert sym.shape == (2, N // cfg.sps)
    assert torch.isfinite(sym).all()


def dryrun_multihost(local_shards: int, device="cuda") -> None:
    """Config 8: ``multihost.pod_mesh`` + ``host_feed`` feeding the sharded
    wideband chain, equal bit for bit to the plain time-mesh path on the
    same input (audio and frequency estimate).  Before
    ``multihost.init`` the pod mesh is this process's ``local_shards``
    shards and ``host_feed`` takes the whole block; in a process group
    every process runs this, feeds its time slice and holds its own
    audio shards against their slices of the time-mesh path, which it
    runs on the whole block over a mesh of as many shards in this
    process."""
    from comms_tpu_torch.models.fm_receiver import FM_LPF_TAPS
    from comms_tpu_torch.parallel import multihost, wideband

    pmesh = multihost.pod_mesh(local_shards=local_shards, device=device)
    procs = pmesh.size // len(pmesh.local)
    rank = pmesh.rank
    block = pmesh.size * 400
    cfg = wideband.WidebandConfig(FM_LPF_TAPS, block=block, dec1=5, dec2=5)
    pairs = _normal(np.random.default_rng(8), (block, 2), device)
    per = block // procs
    garr = multihost.host_feed(pairs[rank * per:(rank + 1) * per], pmesh)
    state = wideband.init_state(cfg, device)
    (audio_p, freq_p), _ = wideband.make_sharded_step(cfg, pmesh)(state,
                                                                  garr)
    tmesh = sh.time_mesh(pmesh.size, device=device)
    (audio_t, freq_t), _ = wideband.make_sharded_step(cfg, tmesh)(state,
                                                                  pairs)
    if isinstance(audio_p, sh.Sharded):
        assert all(torch.equal(x.data, audio_t[x.index])
                   for x in audio_p.addressable_shards)
    else:
        assert torch.equal(audio_p, audio_t)
    assert torch.equal(freq_p, freq_t)


def _dryrun_mesh2d(n, device):
    """Config 9: the 2-D (time x chan) band monitor, equal to the
    one-device band monitor."""
    from comms_tpu_torch.models import fm_band_monitor as model
    from comms_tpu_torch.parallel import wideband2d

    # the most 2-D factorization with K=16 % nc == 0
    nt = 2 if (n % 2 == 0 and 16 % (n // 2) == 0) else 1
    nc = n // nt
    if 16 % nc:
        return                                  # mesh shape unsupported
    N = n * 2048
    cfg = model.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                  block=N, audio_dec=4)
    step = wideband2d.make_sharded_band_monitor_2d(
        cfg, wideband2d.mesh_2d(nt, nc, device=device))
    pairs = _normal(np.random.default_rng(9), (N, 2), device)
    (audio, power), state2 = step(model.init_state(cfg, device), pairs)
    (audio2, _), _ = step(state2, pairs)
    assert audio.shape == (16, N // 16 // 4)
    assert torch.isfinite(audio2).all() and torch.isfinite(power).all()
    ref_fn = model.make_block_fn(cfg, use_kernel=False)
    audio_ref, _ = ref_fn(model.init_state(cfg, device), pairs)
    assert torch.allclose(audio, audio_ref, rtol=0, atol=1e-5)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run configurations 1-9 on an ``n_devices``-shard mesh in this
    process on ``device`` (module docstring)."""
    n = int(n_devices)
    mesh = sh.time_mesh(n, device=device)
    _dryrun_wideband(n, mesh, device)
    _dryrun_fused(n, mesh, device)
    _dryrun_pipeline(n, mesh, device)
    _dryrun_channel_parallel(n, mesh, device)
    _dryrun_planar_kernels(n, mesh, device)
    _dryrun_band_monitor(n, mesh, device)
    _dryrun_qpsk_rx(n, mesh, device)
    dryrun_multihost(n, device)
    _dryrun_mesh2d(n, device)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.shards, device=args.device)
    print(f"dryrun_multichip({args.shards}) on {args.device}: OK")


if __name__ == "__main__":
    main()
