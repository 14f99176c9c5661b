"""parallel.multihost on a CUDA card: two processes share the card (two
CUDA contexts), each with four shards of an 8-shard pod mesh, and run
tests/_multihost_worker.py's programs.  The ring kernel's (K12's)
cross-process form, writing into the neighbour's window mapped through
CUDA IPC, equals the exchange of the same shards in one process bit for
bit, three calls running (both windows and a reuse), one cross-process
launch a call on each rank.  The psum, the sharded wideband chain, the
time-sharded QPSK receiver (K5 per shard) and the fused FM step (K1 per
shard, three blocks chained), the distributed FFT (its all-to-alls
across the processes on K12, cross-process launches counted) and the
PSD makers, and Pipelines and a Graph over the runtime's BlockOps equal,
bit for bit on every worker's shards, the same programs on an 8-shard
mesh in one process.  The 2-D band monitor on a 2 x 4 ``mesh_2d`` laid
over 2 processes x 4 shards and over 4 processes x 2 shards (there the
corner turn crosses processes), two blocks chained, equals the same mesh
in one process bit for bit, with K8 and K2 launched once a local shard a
block and K12 crossing.  Where the
machine has two cards, the ranks take one each and K12 crosses between
them (lazy peer access); with one card that case skips.

This file imports no jax (the machine with the card has none):

    python -m pytest --noconftest -m cuda tests/test_torch_multihost_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

WORKER = Path(__file__).resolve().parent / "_multihost_worker.py"
TIMEOUT_S = 240
FUSED_BLOCK = 8 * 102_400
BAND2D_BLOCK = 8 * 16_384


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run(case, out, procs=2, local=4):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    workers = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(procs), str(local),
         coord, str(out), "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(procs)]
    outs = []
    try:
        for p in workers:
            o, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, o))
    except subprocess.TimeoutExpired:
        for p in workers:
            p.kill()
        for p in workers:
            p.communicate()
        pytest.fail("multi-process workers timed out")
    for rc, o in outs:
        assert rc == 0, o
        assert "WORKER_OK" in o, o


@pytest.mark.cuda
def test_k12_across_two_processes_on_one_card(card, tmp_path):
    _run("k12", tmp_path)


@pytest.mark.cuda
def test_k12_across_two_cards(card, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _run("k12", tmp_path)


@pytest.mark.cuda
def test_psum_across_two_processes_on_the_card(card, tmp_path):
    _run("psum", tmp_path)


@pytest.mark.cuda
def test_fused_fm_across_two_processes_on_the_card(card, tmp_path):
    rng = np.random.default_rng(3)
    np.save(tmp_path / "u8.npy", rng.integers(
        0, 256, size=(3, 2, FUSED_BLOCK), dtype=np.uint8))
    _run("fused", tmp_path)


@pytest.mark.cuda
def test_wideband_chain_across_two_processes_on_the_card(card, tmp_path):
    rng = np.random.default_rng(4)
    np.save(tmp_path / "pairs.npy",
            rng.normal(size=(2, 8 * 4000, 2)).astype(np.float32))
    _run("wideband", tmp_path)


@pytest.mark.cuda
def test_qpsk_receiver_across_two_processes_on_the_card(card, tmp_path):
    rng = np.random.default_rng(5)
    np.save(tmp_path / "qpsk.npy",
            rng.normal(size=(2, 8 * 8192)).astype(np.float32))
    _run("qpsk", tmp_path)


@pytest.mark.cuda
def test_spectra_across_two_processes_on_the_card(card, tmp_path):
    _run("spectra", tmp_path)


@pytest.mark.cuda
def test_runtime_steps_across_two_processes_on_the_card(card, tmp_path):
    _run("runtime", tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("procs,local", [(2, 4), (4, 2)])
def test_band_monitor_2d_across_processes_on_the_card(card, tmp_path, procs,
                                                      local):
    # 8 x 16,384 samples: each shard's slice is one K8 step and each time
    # row's 4,096 frames one K2 tile of 8 rows
    rng = np.random.default_rng(6)
    ph = np.cumsum(0.3 + 0.2 * rng.normal(size=(2, BAND2D_BLOCK)), axis=1)
    z = np.exp(1j * ph) + 0.1 * rng.normal(size=ph.shape)
    np.save(tmp_path / "band2d.npy",
            np.stack([z.real, z.imag], -1).astype(np.float32))
    _run("band2d", tmp_path, procs, local)
