#!/usr/bin/env python3
"""Readings for a cell's limit, on the card, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 3] [--controls bfloat16,tf32] [--program 1]

For each seed it prints one JSON line: the program's ``max_rel_err`` from
a short run of the cell (the window, the same comparison), and each
control's (the plain reference computed in that precision, put in the
program's place) on the same ring.  A last line gives the served step's
device time by CUDA events behind a spin kernel (``step_cuda_ms``), a
check on the profiler's ``step_device_ms`` without the sink's copy.  The
benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", default="bfloat16,tf32")
    ap.add_argument("--program", type=int, default=1)
    a = ap.parse_args(argv)

    import torch

    from benchlib import calib, serve

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    precs = [p for p in a.controls.split(",") if p]
    for seed in (int(s) for s in a.seeds.split(",")):
        row = {"workload": a.workload, "seed": seed}
        if a.program:
            res, compared = serve.run_cell(a.workload, seed, a.seconds, False,
                                           t0=time.perf_counter())
            row["program"] = compared["max_rel_err"]["value"]
            row["correct"] = res["correct"]
            row["rx_msps"] = res["metrics"]["rx_msps"]["value"]
        row.update(calib.control_readings(a.workload, seed, precs))
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": a.workload,
                      "step_cuda_ms": calib.step_cuda_ms(a.workload)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
