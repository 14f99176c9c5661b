"""One process of the multi-process tests (tests/test_torch_multihost.py
on the CPU, tests/test_torch_multihost_cuda.py on a card): it joins the
process group through ``parallel.multihost``, runs one sharded program
over the pod mesh, holds its own shards bit for bit against the same
program on a mesh of as many shards in this process (the whole block),
writes its shards to ``DIR`` for the parent test and prints ``WORKER_OK``.
It imports no jax.

    python tests/_multihost_worker.py CASE RANK PROCS LOCAL_SHARDS \\
        HOST:PORT DIR DEVICE
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from comms_tpu_torch.kernels import halo_ring as HR  # noqa: E402
from comms_tpu_torch.models import fm_receiver as tfm  # noqa: E402
from comms_tpu_torch.parallel import multihost  # noqa: E402
from comms_tpu_torch.parallel import sharding as tsh  # noqa: E402

TAIL = tfm.FUSED_TAIL_SAMPLES


def _equal_shards(got, want, what):
    """``got`` (a Sharded value) against its slices of the global
    ``want``, bit for bit; returns this process's part, concatenated."""
    for s in got.addressable_shards:
        assert torch.equal(s.data, want[s.index]), (what, s.index)
    return torch.cat([s.data for s in got.addressable_shards],
                     dim=got.spec.index(next(a for a in got.spec if a)))


def case_psum(mesh, rank, out, dev):
    multihost.init(*ARGS)                         # idempotent
    assert multihost.is_coordinator() == (rank == 0)
    local = (torch.arange(8) + 8 * rank).float()
    garr = multihost.host_feed(local, mesh)
    assert garr.shape == (8 * mesh.size // len(mesh.local),)
    xs = tsh.shard(garr, mesh, ("time",))
    total = tsh.psum_estimate([x.sum() for x in xs], mesh)
    assert all(float(t) == 120.0 for t in total), total
    # the all-to-all and the last shard's tail cross processes as well
    full = torch.arange(4 * mesh.size ** 2, dtype=torch.float32).reshape(
        mesh.size ** 2, 4)
    one = tsh.time_mesh(mesh.size, device=dev)
    want = tsh.all_to_all(tsh.shard(full, one, ("time",)), one, "time", 0, 0)
    got = tsh.all_to_all(tsh.shard(full, mesh, ("time",)), mesh, "time",
                         0, 0)
    for s, g in zip(mesh.local, got):
        assert torch.equal(g, want[s])
    tail = tsh.collect_ctx(tsh.shard(full, mesh, ("time",)), 1, mesh)
    assert all(torch.equal(t, full[-1:]) for t in tail)
    return 120.0


def case_wideband(mesh, rank, out, dev):
    from comms_tpu_torch.parallel import wideband as twb

    pairs = torch.from_numpy(np.load(out / "pairs.npy")).to(dev)
    blocks = pairs.shape[0]
    n = pairs.shape[1]
    procs = mesh.size // len(mesh.local)
    cfg = twb.WidebandConfig(tfm.FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    pod = twb.make_sharded_step(cfg, mesh)
    one = twb.make_sharded_step(cfg, tsh.time_mesh(mesh.size, device=dev))
    st_p = st_1 = twb.init_state(cfg, dev)
    per = n // procs
    res = {}
    for b in range(blocks):
        local = pairs[b, rank * per:(rank + 1) * per]
        (a_p, f_p), st_p = pod(st_p, multihost.host_feed(local, mesh))
        (a_1, f_1), st_1 = one(st_1, pairs[b])
        res[f"audio{b}"] = _equal_shards(a_p, a_1, "audio").cpu().numpy()
        assert torch.equal(f_p, f_1)
        res[f"freq{b}"] = f_p.cpu().numpy()
    for k, (x, y) in enumerate(zip(st_p, st_1)):
        assert torch.equal(x, y), k
        res[f"state{k}"] = x.cpu().numpy()
    res["lo"] = np.int64(rank * (n // 25 // procs))
    np.savez(out / f"wideband_{rank}.npz", **res)
    return float(res["freq0"])


def case_qpsk(mesh, rank, out, dev):
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.parallel import qpsk_rx_sharded as tqs

    planes = torch.from_numpy(np.load(out / "qpsk.npy")).to(dev)
    procs = mesh.size // len(mesh.local)
    N = planes.shape[1]
    per = N // procs
    cfg = trx.QpskRxConfig()
    pod = tqs.make_sharded_rx_step(cfg, mesh)
    one = tqs.make_sharded_rx_step(cfg, tsh.time_mesh(mesh.size, device=dev))
    sym_p, d_p = pod(*(multihost.host_feed(p[rank * per:(rank + 1) * per],
                                           mesh) for p in planes))
    sym_1, d_1 = one(planes[0], planes[1])
    res = {"sym": _equal_shards(sym_p, sym_1, "symbols").cpu().numpy(),
           "lo": np.int64(rank * (N // cfg.sps // procs))}
    assert d_p.keys() == d_1.keys()
    for k in d_p:
        assert torch.equal(d_p[k], d_1[k]), k
        res[f"diag_{k}"] = d_p[k].cpu().numpy()
    np.savez(out / f"qpsk_{rank}.npz", **res)
    return int(d_p["sym_phase"])


def case_fused(mesh, rank, out, dev):
    from comms_tpu_torch.parallel import fused_wideband as tfw

    u8 = torch.from_numpy(np.load(out / "u8.npy")).to(dev)  # [B, 2, N]
    blocks, _, n = u8.shape
    procs = mesh.size // len(mesh.local)
    per = n // procs
    pod = tfw.make_sharded_fused_step(mesh, block=n)
    one = tfw.make_sharded_fused_step(tsh.time_mesh(mesh.size, device=dev),
                                      block=n)
    st_p = st_1 = tfw.fused_init_state(dev)
    res = {}
    for b in range(blocks):
        re, im = (multihost.host_feed(u8[b, p, rank * per:(rank + 1) * per],
                                      mesh) for p in (0, 1))
        a_p, st_p = pod(st_p, re, im)
        a_1, st_1 = one(st_1, u8[b, 0], u8[b, 1])
        res[f"audio{b}"] = _equal_shards(a_p, a_1, "audio").cpu().numpy()
    for k in st_1:
        assert torch.equal(st_p[k], st_1[k]), k
        res[f"state_{k}"] = st_p[k].cpu().numpy()
    res["lo"] = np.int64(rank * (n // 25 // procs))
    np.savez(out / f"fused_{rank}.npz", **res)
    return len(st_p)


def case_k12(mesh, rank, out, dev):
    """K12 across processes at the fused chain's raw tails (two u8 planes
    of ``TAIL`` bytes a shard, the ring wrapped) against the exchange of
    the same shards in this process, three calls (both windows and a
    reuse); the cross-process launches counted apart."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    size = TAIL + 1000
    for call in range(3):
        planes = [[torch.randint(0, 256, (size,), generator=g, device=dev,
                                 dtype=torch.uint8)
                   for _ in range(mesh.size)] for _ in range(2)]
        want = HR.exchange(planes, TAIL)
        rings = [[x if s in mesh.slot else None for s, x in enumerate(p)]
                 for p in planes]
        HR.cross_launches = 0
        got = HR.exchange_across(rings, [mesh.owners] * 2, TAIL)
        for p in range(2):
            for s in mesh.local:
                assert torch.equal(got[p][s], want[p][s]), (call, p, s)
        assert HR.cross_launches == (1 if dev.type == "cuda" else 0)
    return HR.cross_launches


def case_spectra(mesh, rank, out, dev):
    """The distributed FFT and the three Welch PSD makers (their
    all-to-alls and psums across processes)."""
    from comms_tpu_torch.parallel import dfft as tdfft
    from comms_tpu_torch.parallel import wideband as twb

    one = tsh.time_mesh(mesh.size, device=dev)
    F = 4096
    g = torch.Generator().manual_seed(7)
    pairs = torch.randn(2 * mesh.size, F, 2, generator=g).to(dev)
    x = torch.complex(pairs[..., 0], pairs[..., 1])
    HR.cross_launches = 0
    got = tdfft.make_dfft(F, mesh)(x)
    # the dfft's two all-to-alls cross on the card's route (K12 into the
    # other process's windows), on gloo from CPU shards
    assert (HR.cross_launches > 0) == (dev.type == "cuda"), HR.cross_launches
    _equal_shards(got, tdfft.make_dfft(F, one)(x), "dfft")
    _equal_shards(twb.make_sharded_psd(F, mesh)(pairs),
                  twb.make_sharded_psd(F, one)(pairs), "psd")
    _equal_shards(twb.make_sharded_psd_planar(F, mesh)(x.real, x.imag),
                  twb.make_sharded_psd_planar(F, one)(x.real, x.imag),
                  "psd_planar")
    procs = mesh.size // len(mesh.local)
    per = pairs.shape[0] // procs
    got = twb.make_sharded_psd_segments(F, mesh)(multihost.host_feed(
        pairs[rank * per:(rank + 1) * per], mesh))
    assert torch.equal(got, twb.make_sharded_psd_segments(F, one)(pairs))
    return F


def case_runtime(mesh, rank, out, dev):
    """Pipelines and a Graph over the pod mesh: every BlockOp hook with a
    collective (halos, the Mixer's and the NCO's cross-shard phases, the
    sources' shard offsets), two blocks streamed."""
    from comms_tpu_torch import runtime as trt

    one = tsh.time_mesh(mesh.size, device=dev)
    procs = mesh.size // len(mesh.local)
    n = mesh.size * 1024
    g = torch.Generator().manual_seed(9)
    xs = torch.complex(torch.randn(2, n, generator=g),
                       torch.randn(2, n, generator=g)).to(dev)
    perr = (0.01 * torch.randn(2, n, generator=g)).to(dev)
    per = n // procs
    fm = trt.Pipeline([trt.Fir.make(np.hamming(33)), trt.Mixer(0.013),
                       trt.FirDecimate.make(np.hamming(32), 4),
                       trt.FmDemod(), trt.Decimate(2)])
    prn = trt.Pipeline([trt.PrnSource.make(0xC0, 0x5A, 8, n), trt.BpskMod(),
                        trt.PulseShape.make(np.hanning(16), 4)])
    nco = trt.Pipeline([trt.Nco(0.37, phase0=1.1)])
    src = trt.Pipeline([trt.UniformSource(n, seed=3)])
    for pipe, x in ((fm, xs), (prn, None), (nco, perr), (src, None)):
        pod, ref = pipe.make_sharded_step(mesh), pipe.make_sharded_step(one)
        st_p = st_1 = pipe.init_state(device=dev)
        for b in range(2):
            xb = None if x is None else x[b]
            y_p, st_p = pod(st_p, None if xb is None else
                            multihost.host_feed(xb[rank * per:
                                                   (rank + 1) * per], mesh))
            y_1, st_1 = ref(st_1, xb)
            _equal_shards(y_p, y_1, f"pipeline {pipe.ops[0]}")
        for a, b in zip(st_p, st_1):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    gr = trt.Graph()
    gr.add_input("x")
    gr.add_node("sum", lambda a, b: a + b, ["x", "acc"],
                feedback_from={"acc": torch.zeros(n, device=dev)},
                elementwise=True)
    gr.add_node("acc", trt.Lambda(lambda v: v), ["sum"])
    gr.set_outputs(["acc"])
    gp, g1 = gr.make_sharded_step(mesh), gr.make_sharded_step(one)
    s_p = s_1 = gr.init_state(device=dev)
    x = torch.ones(n, device=dev)
    for _ in range(3):
        (o_p,), s_p = gp(s_p, {"x": multihost.host_feed(
            x[rank * per:(rank + 1) * per], mesh)})
        (o_1,), s_1 = g1(s_1, {"x": x})
    _equal_shards(o_p, o_1, "graph")
    assert all(float(v.data.min()) == 3.0 for v in o_p.addressable_shards)
    return n


def case_band2d(mesh, rank, out, dev):
    """The 2-D band monitor on ``mesh_2d(2, size / 2)`` laid over the
    processes, fed through ``host_feed`` over ("time", "chan"), two
    blocks chained, against the same mesh in this process bit for bit:
    audio and power shards, and the state whole on every process.  On a
    card K8 and K2 run once a local shard a block, and K12 crosses."""
    from comms_tpu_torch.kernels import channelizer as CK
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.models import fm_band_monitor as tbm
    from comms_tpu_torch.parallel import wideband2d as tw2

    pairs = torch.from_numpy(np.load(out / "band2d.npy")).to(dev)  # [B,N,2]
    blocks, n = pairs.shape[:2]
    procs = mesh.size // len(mesh.local)
    nt, nc = 2, mesh.size // 2
    m2 = tw2.mesh_2d(nt, nc, device=dev.type)
    assert m2.owners == mesh.owners and m2.local == mesh.local
    assert m2.devices[m2.local[0]] == dev
    one = tsh.Mesh([dev] * m2.size, (nt, nc), ("time", "chan"))
    cfg = tbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                block=n, audio_dec=4)
    pod = tw2.make_sharded_band_monitor_2d(cfg, m2)
    ref = tw2.make_sharded_band_monitor_2d(cfg, one)
    st_p = st_1 = tbm.init_state(cfg, dev)
    per = n // procs
    res, counts = {}, [0, 0, 0, 0]
    for b in range(blocks):
        feed = multihost.host_feed(pairs[b, rank * per:(rank + 1) * per],
                                   m2, ("time", "chan"))
        before = (CK.launches, DF.launches, HR.launches, HR.cross_launches)
        (a_p, p_p), st_p = pod(st_p, feed)
        counts = [c + now - was for c, now, was in zip(
            counts, (CK.launches, DF.launches, HR.launches,
                     HR.cross_launches), before)]
        (a_1, p_1), st_1 = ref(st_1, pairs[b])
        for name, got, want in (("audio", a_p, a_1), ("power", p_p, p_1)):
            for k, sh_ in enumerate(got.addressable_shards):
                assert torch.equal(sh_.data, want[sh_.index]), (name, b, k)
                res[f"{name}{b}_{k}"] = sh_.data.cpu().numpy()
                res[f"{name}{b}_{k}_at"] = np.array(
                    [(i.start, i.stop) for i in sh_.index])
    for k, (x, y) in enumerate(zip(st_p, st_1)):
        assert torch.equal(x, y), k
        res[f"state{k}"] = x.cpu().numpy()
    if dev.type == "cuda":
        local = len(m2.local)
        assert counts[:2] == [blocks * local, blocks * local], counts
        assert counts[2] > 0 and counts[3] > 0, counts
    else:
        assert counts == [0, 0, 0, 0], counts
    np.savez(out / f"band2d_{rank}.npz", **res)
    return counts[3]


CASES = {"psum": case_psum, "wideband": case_wideband, "qpsk": case_qpsk,
         "fused": case_fused, "k12": case_k12, "spectra": case_spectra,
         "runtime": case_runtime, "band2d": case_band2d}


def main(argv):
    global ARGS
    case, rank, procs, local, coord, out, device = argv
    rank, procs, local = int(rank), int(procs), int(local)
    torch.set_num_threads(1)
    ARGS = (coord, procs, rank)
    multihost.init(*ARGS)
    mesh = multihost.pod_mesh(local_shards=local, device=device)
    assert mesh.size == procs * local and mesh.spans_processes == (procs > 1)
    dev = mesh.devices[mesh.local[0]]
    value = CASES[case](mesh, rank, Path(out), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    multihost.shutdown()
    print("WORKER_OK", case, rank, value, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
