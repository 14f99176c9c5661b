"""The card: its name and power limit, its published peaks, the bound of
a kernel's work against them, and the device time of a call.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, no
sparsity), which assume the full 700 W limit; every result that uses
them carries the card's own limit beside it, read from ``nvidia-smi``.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess
import time

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float):
    """``(seconds, by)``: the least time the card could take to move
    ``nbytes`` (each input byte read once, each output byte written
    once) and do ``flops`` float32 operations on the CUDA cores; ``by``
    is "bytes" or "operations"."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / F32_FLOP_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def card(index: int = 0) -> dict:
    """Name, count and power limit (W, or None where ``nvidia-smi`` is
    missing or says nothing) of the card the run uses."""
    import torch

    limit = None
    smi = shutil.which("nvidia-smi")
    if smi:
        try:
            out = subprocess.run(
                [smi, f"--id={index}", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=20).stdout
            limit = float(out.strip().splitlines()[0])
        except (OSError, ValueError, IndexError, subprocess.SubprocessError):
            limit = None
    return {"kind": torch.cuda.get_device_name(index),
            "power_limit_w": limit}


_SPIN_CYCLES_PER_MS = []


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Device time of ``fn()`` in ms: CUDA events, median of ``reps``.
    Each timed call is queued behind a spin kernel that lasts three
    times the host's enqueue of ``fn`` plus 0.5 ms, so the events see
    the device's work back to back and not the caller's host code."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    host_ms = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    spin = int(_SPIN_CYCLES_PER_MS[0] * (3 * host_ms + 0.5))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
