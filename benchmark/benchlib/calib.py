"""Readings that set a cell's limit: the control (the plain reference
computed below float32, put in the program's place) against the
reference, on the cell's own input ring at the cell's own sizes."""

from __future__ import annotations

import torch

from benchlib import serve


def control_readings(workload: str, seed: int, precs, *, blocks=(5, 6, 7),
                     manifest=None, device="cuda", sizes=None) -> dict:
    """``{prec: worst rel_err over blocks}``: each control's outputs of
    global blocks ``blocks`` against the float64 reference's, on the
    ring the cell makes from ``seed``."""
    m = manifest or serve.Manifest()
    c = serve.cell(m, workload, seed, torch.device(device), sizes)
    ref = m.reference(c.workload["config"])
    out = {}
    for prec in precs:
        kept = {g: ref.block_output(c.ring, g, c.cfg, prec) for g in blocks}
        out[prec] = serve.compare(ref, c.ring, c.cfg, kept)
    return out


def step_cuda_ms(workload: str, seed: int = 1, manifest=None) -> float:
    """Device time of one served step on the cell's input (CUDA events
    around a call queued behind a spin kernel, median of 7), from a
    state carried over a few blocks."""
    from benchlib import device as D

    c = serve.cell(manifest or serve.Manifest(), workload, seed,
                   torch.device("cuda", 0))
    state = c.served.init_state()
    for g in range(3):
        _, state = c.served.step(state, c.item(g))
    return D.cuda_ms(lambda: c.served.step(state, c.item(3)))
