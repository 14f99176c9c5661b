"""parallel.multihost: the port's mesh across real processes, on the CPU
over gloo.  The counterpart of tests/test_multiprocess.py: worker
interpreters (tests/_multihost_worker.py, no jax, one thread each) join
the process group, feed their time slices through ``host_feed`` and run
the sharded programs over ``pod_mesh``; each worker holds its own shards
bit for bit against the same program on a mesh of as many shards in its
own process (the whole block) and writes them out; this test then holds
them to the JAX package's results, computed while the workers run:

* the psum, 2 x 2 shards: exactly 120 (and the all-to-all and the last
  shard's tail across processes equal to one process's);
* the sharded wideband chain at (2, 2) and (4, 1), two blocks streamed:
  within ``TOL_CHAIN`` (1e-4, tests/test_torch_wideband.py) of the JAX
  chain on the CPU mesh, audio, estimate and state;
* the time-sharded QPSK receiver, 2 x 2: the JAX one-device receiver's
  bounds from tests/test_multiprocess.py (symbols within 0.05 of the
  largest away from 16 symbols at the stream's edges, the frequency
  estimate within 2e-3, the same symbol phase);
* the fused FM step, 2 x 2 at one kernel step a shard (the plain K1 on
  the CPU), two blocks chained: within ``TOL_FM`` (1e-3,
  tests/test_torch_fused_wideband.py) of the JAX sharded chain (its
  kernel in interpret mode) on the first block.

* the 2-D band monitor on ``mesh_2d(2, 2)`` laid over (2, 2) and (4, 1)
  processes, two blocks chained: within ``TOL_2D`` (1e-5,
  tests/test_torch_wideband2d.py) of the JAX 2-D band monitor on the CPU
  mesh, audio and state absolute, power relative; in the (4, 1) layout
  the corner turn crosses processes.

Also: the distributed FFT, the PSD makers, Pipelines and a Graph
across processes, bit-equal to one process's mesh; dry-run config 8 in
one process, ``init``'s idempotence and ``shutdown``, ``host_feed``'s
ValueErrors and its layout over a tuple axis, the layout of a value
across processes and of ``mesh_2d`` over a process group.  Every worker
has a timeout and is killed at it.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.distributed as dist

from comms_tpu.models import fm_band_monitor as jbm
from comms_tpu.models import qpsk_rx as jrx
from comms_tpu.models import qpsk_tx as jtx
from comms_tpu.models.fm_receiver import FM_LPF_TAPS
from comms_tpu.parallel import fused_wideband as jfw
from comms_tpu.parallel import sharding as jsh
from comms_tpu.parallel import wideband as jwb
from comms_tpu.parallel import wideband2d as jw2
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.parallel import dryrun, multihost
from comms_tpu_torch.parallel import sharding as tsh
from comms_tpu_torch.parallel import wideband2d as tw2

WORKER = Path(__file__).resolve().parent / "_multihost_worker.py"
TIMEOUT_S = 120
TOL_CHAIN = 1e-4
TOL_FM = 1e-3
TOL_2D = 1e-5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _spawn(case, procs, local, out):
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(procs), str(local),
         coord, str(out), "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(procs)]


def _finish(workers):
    outs = []
    try:
        for p in workers:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in workers:
            p.kill()
        for p in workers:
            p.communicate()
        pytest.fail("multi-process workers timed out")
    for rc, out in outs:
        assert rc == 0, out
        assert "WORKER_OK" in out, out
    return [out for _, out in outs]


def _gather(out, name, procs, key):
    """The workers' parts of array ``key``, in rank order (each worker's
    shards are its contiguous time slice)."""
    parts = [np.load(out / f"{name}_{r}.npz") for r in range(procs)]
    return np.concatenate([p[key] for p in parts], axis=-1), parts


def test_psum_across_two_processes(tmp_path):
    outs = _finish(_spawn("psum", 2, 2, tmp_path))
    assert all(o.strip().splitlines()[-1].endswith("120.0") for o in outs)


def _fm_pairs(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.2 + 0.05 * np.sin(2 * np.pi * np.arange(n) / 400)
                   + 0.01 * rng.normal(size=n))
    z = (np.exp(1j * ph) * 0.9).astype(np.complex64)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


@pytest.mark.parametrize("procs,local", [(2, 2), (4, 1)])
def test_wideband_chain_across_processes(tmp_path, procs, local):
    n = 4000 * 4
    blocks = np.stack([_fm_pairs(n, 1), _fm_pairs(n, 2)])
    np.save(tmp_path / "pairs.npy", blocks)
    workers = _spawn("wideband", procs, local, tmp_path)
    jcfg = jwb.WidebandConfig(FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    jstep = jwb.make_sharded_step(jcfg, jsh.time_mesh(procs * local))
    jst = jwb.init_state(jcfg)
    want = []
    for b in range(2):
        (ja, jf), jst = jstep(jst, jnp.asarray(blocks[b]))
        want.append((np.asarray(ja), float(jf)))
    _finish(workers)
    for b, (ja, jf) in enumerate(want):
        audio, parts = _gather(tmp_path, "wideband", procs, f"audio{b}")
        assert [int(p["lo"]) for p in parts] == [
            r * n // 25 // procs for r in range(procs)]
        np.testing.assert_allclose(audio, ja, atol=TOL_CHAIN)
        for p in parts:
            assert abs(float(p[f"freq{b}"]) - jf) < TOL_CHAIN
    for p in parts:
        for k, s in enumerate(jst):
            np.testing.assert_allclose(p[f"state{k}"], np.asarray(s),
                                       atol=TOL_CHAIN)


def test_qpsk_receiver_across_two_processes(tmp_path):
    nbits = 16384
    tcfg = jtx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = jtx.make_block_fn(tcfg)(jtx.init_state(tcfg, 2))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    xc = (x * np.exp(1j * (0.007 * np.arange(len(x)) + 0.5))).astype(
        np.complex64)
    np.save(tmp_path / "qpsk.npy",
            np.stack([xc.real, xc.imag]).astype(np.float32))
    workers = _spawn("qpsk", 2, 2, tmp_path)
    sym_1, diag_1 = jrx.make_rx_fn_planar(jrx.QpskRxConfig())(
        jnp.asarray(xc.real), jnp.asarray(xc.imag))
    b = np.asarray(sym_1)
    _finish(workers)
    got, parts = _gather(tmp_path, "qpsk", 2, "sym")
    M = b.shape[1]
    assert got.shape == b.shape
    for p in parts:
        assert abs(float(p["diag_freq"]) - float(diag_1["freq"])) < 2e-3
        assert int(p["diag_sym_phase"]) == int(diag_1["sym_phase"])
    scale = np.abs(b[0] + 1j * b[1]).max()
    keep = slice(16, M - 16)
    err = np.abs((got[0] + 1j * got[1])[keep] - (b[0] + 1j * b[1])[keep])
    assert err.max() < 0.05 * scale, err.max()


def test_fused_fm_across_two_processes(tmp_path):
    per = tfm.FUSED_BLOCK_QUANTUM
    N = 4 * per
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, size=(2, 2, N), dtype=np.uint8)
    np.save(tmp_path / "u8.npy", u8)
    workers = _spawn("fused", 2, 2, tmp_path)
    jstep = jfw.make_sharded_fused_step(jsh.time_mesh(4), block=N,
                                        interpret=True)
    want, _ = jstep(jfw.fused_init_state(), jnp.asarray(u8[0, 0]),
                    jnp.asarray(u8[0, 1]))
    _finish(workers)
    audio, parts = _gather(tmp_path, "fused", 2, "audio0")
    assert audio.shape == (N // 25,)
    assert np.max(np.abs(audio - np.asarray(want))) < TOL_FM
    for k in tfm.fused_init_state("cpu"):
        assert np.array_equal(parts[0][f"state_{k}"], parts[1][f"state_{k}"])


def test_dryrun_config8_in_one_process():
    assert not dist.is_initialized()
    dryrun.dryrun_multihost(4, device="cpu")


def test_init_is_idempotent_and_shutdown_leaves():
    assert not dist.is_initialized()
    mesh = multihost.pod_mesh(local_shards=3, device="cpu")
    assert mesh.size == 3 and not mesh.spans_processes
    assert multihost.is_coordinator()
    addr = f"127.0.0.1:{_free_port()}"
    try:
        multihost.init(addr, num_processes=1, process_id=0)
        multihost.init(addr, num_processes=1, process_id=0)
        multihost.init()
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert multihost.is_coordinator()
        mesh = multihost.pod_mesh(local_shards=2, device="cpu")
        assert mesh.owners == [0, 0] and not mesh.spans_processes
    finally:
        multihost.shutdown()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.init(addr)
    assert not dist.is_initialized()


def test_window_plan_that_does_not_fit_raises_before_allocating(
        monkeypatch):
    # K12's cross-process windows are cudaMalloc'd per plan; a plan larger
    # than the card's free memory raises in every process, before any
    # window exists (the check is collective: a one-process group here)
    from comms_tpu_torch.kernels import halo_ring as HR

    free = [10_000]
    monkeypatch.setattr(HR.torch.cuda, "mem_get_info",
                        lambda *a: (free[0], 1 << 30))
    monkeypatch.setattr(HR.torch.cuda, "empty_cache", lambda: None)
    addr = f"127.0.0.1:{_free_port()}"
    try:
        multihost.init(addr, num_processes=1, process_id=0)
        HR._room_for({(1, 0): 4, (0, 1): 100}, 1024, 0)   # 8 KiB here
        free[0] = 8191
        with pytest.raises(ValueError, match="do not fit on the card"):
            HR._room_for({(1, 0): 4, (0, 1): 100}, 1024, 0)
    finally:
        multihost.shutdown()
    assert not HR._owned


def test_host_feed_rejects_uneven_blocks():
    mesh = multihost.pod_mesh(local_shards=3, device="cpu")
    with pytest.raises(ValueError, match="divide evenly over 3 local"):
        multihost.host_feed(np.zeros(8, np.float32), mesh)
    g = multihost.host_feed(np.arange(9, dtype=np.float32), mesh)
    assert g.shape == (9,)
    assert torch.equal(torch.cat(tsh.shard(g, mesh, ("time",))),
                       torch.arange(9.0))


def _pod(rank=0, shape=(4,), names=("time",), owners=(0, 0, 1, 1)):
    """A mesh across two processes, seen from process ``rank`` (no
    process group is needed to build or to refuse a step on it)."""
    return tsh.Mesh(["cpu"] * len(owners), shape, names, owners=owners,
                    rank=rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_values_across_processes_keep_global_places(rank):
    mesh = _pod(rank)
    assert mesh.local == [2 * rank, 2 * rank + 1]
    assert mesh.local_axis_index("time") == mesh.local
    x = torch.arange(24.0).reshape(2, 12)
    xs = tsh.shard(x, mesh, (None, "time"))
    assert [v.shape for v in xs] == [(2, 3), (2, 3)]
    g = tsh.unshard(xs, mesh, (None, "time"))
    assert isinstance(g, tsh.Sharded) and g.shape == (2, 12)
    for s in g.addressable_shards:
        assert torch.equal(s.data, x[s.index])
    assert [s.index[1].start for s in g.addressable_shards] == [
        6 * rank, 6 * rank + 3]
    assert all(a is b for a, b in zip(tsh.shard(g, mesh, (None, "time")),
                                      g.shards))
    with pytest.raises(ValueError, match="layout"):
        tsh.shard(g, mesh, ("time", None))


def test_spectra_across_two_processes(tmp_path):
    # the distributed FFT and the three PSD makers, bit-equal to one
    # process's mesh (tests/test_torch_dfft.py and _wideband hold that
    # mesh to the JAX package)
    _finish(_spawn("spectra", 2, 2, tmp_path))


@pytest.mark.parametrize("procs,local", [(2, 2), (4, 1)])
def test_runtime_steps_across_processes(tmp_path, procs, local):
    # Pipelines (halo ops, the Mixer, the NCO, the sources) and a Graph
    # with feedback, bit-equal to one process's mesh
    # (tests/test_torch_pipeline_sharded.py holds that mesh to the JAX
    # package)
    _finish(_spawn("runtime", procs, local, tmp_path))


def _band2d_pairs(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.3 + 0.2 * rng.normal(size=n))
    z = (np.exp(1j * ph) + 0.1 * rng.normal(size=n)).astype(np.complex64)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def _placed(parts, key, shape):
    """The global array of the workers' shards of ``key`` (each saved with
    its place), every element covered once."""
    full = np.full(shape, np.nan, np.float32)
    for p in parts:
        k = 0
        while f"{key}_{k}" in p:
            at = tuple(slice(a, b) for a, b in p[f"{key}_{k}_at"])
            full[at] = p[f"{key}_{k}"]
            k += 1
    assert not np.isnan(full).any(), key
    return full


@pytest.mark.parametrize("procs,local", [(2, 2), (4, 1)])
def test_band_monitor_2d_across_processes(tmp_path, procs, local):
    n = 16384
    blocks = np.stack([_band2d_pairs(n, 11), _band2d_pairs(n, 12)])
    np.save(tmp_path / "band2d.npy", blocks)
    workers = _spawn("band2d", procs, local, tmp_path)
    jcfg = jbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                 block=n, audio_dec=4)
    jstep = jw2.make_sharded_band_monitor_2d(jcfg, jw2.mesh_2d(2, 2))
    jst = jbm.init_state(jcfg)
    want = []
    for b in range(2):
        (ja, jp), jst = jstep(jst, jnp.asarray(blocks[b]))
        want.append((np.asarray(ja), np.asarray(jp)))
    _finish(workers)
    parts = [np.load(tmp_path / f"band2d_{r}.npz") for r in range(procs)]
    for b, (ja, jp) in enumerate(want):
        np.testing.assert_allclose(_placed(parts, f"audio{b}", ja.shape), ja,
                                   atol=TOL_2D)
        np.testing.assert_allclose(_placed(parts, f"power{b}", jp.shape), jp,
                                   rtol=TOL_2D)
    for p in parts:
        for k, s in enumerate(jst):
            np.testing.assert_allclose(p[f"state{k}"], np.asarray(s),
                                       atol=TOL_2D)


@pytest.mark.parametrize("procs,rank", [(2, 0), (2, 1), (4, 3)])
def test_mesh_2d_lays_its_grid_over_the_processes(monkeypatch, procs, rank):
    # the group as multihost.init leaves it: mesh_2d reads only its size
    # and this process's rank
    monkeypatch.setattr(multihost, "_world", lambda: (procs, rank))
    mesh = tw2.mesh_2d(2, 4, device="cpu")
    per = 8 // procs
    assert mesh.owners == [s // per for s in range(8)]
    assert mesh.local == list(range(rank * per, (rank + 1) * per))
    assert mesh.spans_processes and mesh.rank == rank
    assert [mesh.coords(s) for s in mesh.local] == [
        {"time": s // 4, "chan": s % 4} for s in mesh.local]
    with pytest.raises(ValueError, match="does not divide over"):
        tw2.mesh_2d(1, 3, device="cpu")


def test_mesh_2d_before_init_is_one_process():
    assert not dist.is_initialized()
    mesh = tw2.mesh_2d(2, 4, device="cpu")
    assert mesh.owners == [0] * 8 and not mesh.spans_processes


@pytest.mark.parametrize("rank", [0, 1])
def test_host_feed_over_both_axes_lays_chunks_at_their_places(rank):
    mesh = _pod(rank, shape=(2, 2), names=("time", "chan"))
    full = torch.arange(16 * 2, dtype=torch.float32).reshape(16, 2)
    g = multihost.host_feed(full[8 * rank:8 * (rank + 1)], mesh,
                            ("time", "chan"))
    assert g.shape == (16, 2)
    assert [s.index[0] for s in g.addressable_shards] == [
        slice(8 * rank, 8 * rank + 4), slice(8 * rank + 4, 8 * rank + 8)]
    for s in g.addressable_shards:
        assert torch.equal(s.data, full[s.index])
    assert all(a is b for a, b in zip(
        tsh.shard(g, mesh, (("time", "chan"), None)), g.shards))
    with pytest.raises(ValueError, match="1-D mesh"):
        multihost.host_feed(full[:8], mesh, "time")
    with pytest.raises(ValueError, match="shard order"):
        multihost.host_feed(full[:8], mesh, ("chan", "time"))


def test_in_process_multi_card_mesh_names_the_multihost_route():
    with pytest.raises(ValueError, match="one process per card"):
        tsh.Mesh(["cuda:0", "cuda:1"], (2,), ("time",))
