"""comms_tpu_torch.native: the C++ block reader and writer (the five cases
of tests/test_native.py on the port's copy), where and how the library
is built, and ``run_file`` through the native reader against the same
call with the reader's construction failing (numpy reads) and against
the JAX package's ``run_file``."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from comms_tpu.models import fm_receiver as jfm
from comms_tpu_torch import native
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.native import loader
from comms_tpu_torch.native import (
    NativeBlockReader,
    NativeBlockWriter,
    native_available,
)

REPO = Path(__file__).resolve().parents[1]

# tests/test_torch_fm_receiver.py's bounds: the tensor chain against the
# JAX package's XLA chain, and the fused chain against it.
TOL_BLOCK = 2e-4
TOL_FUSED = 1e-3


# ---- the five cases of tests/test_native.py

def test_reader_blocks_and_eof(tmp_path):
    p = tmp_path / "data.bin"
    data = np.arange(1000, dtype=np.uint8)
    data.tofile(p)
    with NativeBlockReader(p, block_bytes=256) as r:
        blocks = list(r)
    # 3 full blocks + 1 short tail (232 bytes).
    assert [len(b) for b in blocks] == [256, 256, 256, 232]
    assert np.array_equal(np.concatenate(blocks), data)


def test_reader_loop_wraps(tmp_path):
    p = tmp_path / "data.bin"
    np.arange(100, dtype=np.uint8).tofile(p)
    with NativeBlockReader(p, block_bytes=64, loop=True) as r:
        b1 = r.next_block().copy()
        b2 = r.next_block().copy()
    assert len(b1) == 64 and len(b2) == 64
    assert b2[35] == 99 and b2[36] == 0  # wrap point: 36 remaining + restart


def test_reader_dtype_shape_view(tmp_path):
    p = tmp_path / "iq.bin"
    np.arange(40, dtype=np.uint8).tofile(p)
    with NativeBlockReader(p, block_bytes=40, dtype=np.uint8,
                           shape=(-1, 2)) as r:
        b = r.next_block()
        assert b.shape == (20, 2)
        assert b[1, 0] == 2


def test_writer_roundtrip(tmp_path):
    p = tmp_path / "out.bin"
    with NativeBlockWriter(p) as w:
        for i in range(5):
            w.write(np.full(100, i, dtype=np.int16))
    got = np.fromfile(p, dtype=np.int16)
    assert len(got) == 500
    assert (got.reshape(5, 100) == np.arange(5)[:, None]).all()


def test_reader_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        NativeBlockReader(tmp_path / "nope.bin", block_bytes=64)


# ---- the build

def test_library_lands_in_build_under_its_hash():
    assert native_available()
    path = loader.library_path()
    assert path.parent == REPO / "build" / "comms_tpu_torch" / "native"
    import hashlib
    h = hashlib.sha256(" ".join(loader.CXX_FLAGS).encode())
    h.update((REPO / "comms_tpu_torch" / "native" / "loader.cpp")
             .read_bytes())
    assert path.name == f"libcomms_io-{h.hexdigest()[:16]}.so"
    assert path.exists()
    # the loaded library is that file, never the JAX package's
    assert Path(loader._lib._name) == path
    assert "comms_tpu/native" not in loader._lib._name


def test_import_builds_nothing():
    code = ("import comms_tpu_torch.native as n\n"
            "import comms_tpu_torch.models.fm_receiver\n"
            "assert n.loader._lib is None and n.loader._build_error is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_two_processes_building_at_once_both_load(tmp_path):
    """Each process builds into the same empty directory; each writes a
    temporary file and renames it into place, so both load a whole
    library and nothing half-written is left behind."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from comms_tpu_torch.native import loader\n"
            "loader.BUILD_DIR = Path(sys.argv[1])\n"
            "assert not loader.library_path().exists()\n"
            "assert loader.native_available(), loader._build_error\n"
            "print(loader._lib._name)\n")
    build = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(f.name for f in build.iterdir()) == [Path(*names).name]


# ---- run_file through the native reader

def _fm_capture(n, step=0.3, wobble=0.02, amp=100, seed=0):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(step + wobble * rng.normal(size=n))
    z = np.exp(1j * ph)
    return np.stack([
        np.clip(np.round(z.real * amp + 127.5), 0, 255),
        np.clip(np.round(z.imag * amp + 127.5), 0, 255),
    ], axis=-1).astype(np.uint8)


def _python_io(monkeypatch):
    """Make the reader's construction fail, so ``run_file`` falls back to
    numpy reads."""
    def unavailable(*args, **kwargs):
        raise RuntimeError("native IO unavailable (test)")
    monkeypatch.setattr(native, "NativeBlockReader", unavailable)


def _count_readers(monkeypatch):
    made = []

    class Counted(NativeBlockReader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(native, "NativeBlockReader", Counted)
    return made


# (block, fused, bound against JAX): a polyphase block, the dense
# default (262,144, the rtl-sdr read), and the fused chain's quantum
# through its plain version.
RUN_FILE_CASES = {
    "polyphase": (25 * 400, False, TOL_BLOCK),
    "dense_default": (262144, False, TOL_BLOCK),
    "fused": (tfm.FUSED_BLOCK_QUANTUM, True, TOL_FUSED),
}


@pytest.mark.parametrize("case", sorted(RUN_FILE_CASES))
def test_run_file_native_equals_python_io_and_jax(case, tmp_path,
                                                  monkeypatch):
    block, fused, tol = RUN_FILE_CASES[case]
    L = 2 * block + 4321
    p = tmp_path / "cap.iq"
    _fm_capture(L, seed=block % 97).tofile(p)
    cfg = tfm.FmReceiverConfig(block=block)

    made = _count_readers(monkeypatch)
    got = tfm.run_file(p, cfg, fused=fused, device="cpu")
    assert len(made) == 1 and made[0]._h is None   # read natively, closed
    monkeypatch.undo()
    _python_io(monkeypatch)
    fallback = tfm.run_file(p, cfg, fused=fused, device="cpu")
    assert got.dtype == fallback.dtype == np.float32
    assert np.array_equal(got, fallback)

    want = jfm.run_file(p, jfm.FmReceiverConfig(block=block), fused=False)
    assert got.shape == want.shape == (tfm._tail_valid_out(cfg, L),)
    assert np.max(np.abs(got - want)) < tol


@pytest.mark.parametrize("extra_bytes", [0, 1, 2 * 777, 2 * 777 + 1])
def test_run_file_native_tail_shapes(extra_bytes, tmp_path, monkeypatch):
    """Whole blocks only, an odd last byte, a ragged tail and both: the
    native reader's output equals the numpy reads'.  (The JAX package's
    native path reshapes the last block to pairs and raises on an odd
    byte count; the port drops the odd byte as its numpy path does.)"""
    block = 25 * 160
    raw = _fm_capture(2 * block + 800, seed=3).reshape(-1)
    raw = raw[: 2 * 2 * block + extra_bytes]
    p = tmp_path / "cap.iq"
    raw.tofile(p)
    cfg = tfm.FmReceiverConfig(block=block)
    got = tfm.run_file(p, cfg, device="cpu")
    _python_io(monkeypatch)
    want = tfm.run_file(p, cfg, device="cpu")
    assert np.array_equal(got, want)
    assert got.shape == (tfm._tail_valid_out(cfg, raw.size // 2),)


def test_run_file_stream_errors_propagate(tmp_path, monkeypatch):
    """Only the reader's construction may fall back: an error once the
    stream has started propagates (a retry would repeat blocks)."""
    block = 25 * 160
    p = tmp_path / "cap.iq"
    _fm_capture(3 * block, seed=2).tofile(p)
    calls = []
    real_next = NativeBlockReader.next_block

    def failing_next(self):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("read failed mid-stream (test)")
        return real_next(self)
    monkeypatch.setattr(NativeBlockReader, "next_block", failing_next)
    with pytest.raises(OSError, match="mid-stream"):
        tfm.run_file(p, tfm.FmReceiverConfig(block=block), device="cpu")
    assert len(calls) == 2
