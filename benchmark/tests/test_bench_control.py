"""The control: the plain reference computed below the float32 that the
configurations state (TF32 products, bfloat16 stages), put in the
program's place, has to come out not correct; the program itself has to
come out correct, on the same rings.  On the CPU at a size a test run
holds; on the card (``cuda``) at the cells' own sizes."""

import time

import pytest
import torch

from benchlib import calib, serve

SIZES = {"bm64_staged": {"block_samples": 20480},
         "fm_pipeline": {"block_samples": 51200}}
SEEDS = (101, 2 ** 31 + 202, 3_000_000_303)
M = serve.Manifest()


def _limit(workload):
    return M.config(M.workload(workload)["config"])["check"]["max_rel_err"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_and_program_passes(workload, seed):
    limit = _limit(workload)
    got = calib.control_readings(workload, seed, ("tf32", "bfloat16"),
                                 device="cpu", sizes=SIZES[workload])
    assert got["tf32"] > limit and got["bfloat16"] > limit, got
    result, compared = serve.run_cell(
        workload, seed, 0.2, False, t0=time.perf_counter(), device="cpu",
        sizes=SIZES[workload])
    assert result["correct"], compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_at_the_cells_size_on_the_card(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = calib.control_readings(workload, seed, ("tf32", "bfloat16"))
    limit = _limit(workload)
    assert got["tf32"] > limit and got["bfloat16"] > limit, got
