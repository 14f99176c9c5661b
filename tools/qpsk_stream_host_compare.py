#!/usr/bin/env python3
"""Host cost of the fused QPSK stream step
(``models/qpsk_rx_stream.make_stream_fused_fn``) in two checkouts of the
package, on one CUDA card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/qpsk_stream_host_compare.py build/parent .

Each checkout is measured in a process of its own, in the order A, B, B,
A: the package is imported from the checkout's root (its kernels built
there), ``chip_smoke.py``'s helpers from this one.  On ``chip_smoke``'s
QPSK capture at ``chip_smoke.QPSK_N`` = 33,554,432 samples a block,
turned a block as phase 20 turns it, each process measures

- the host enqueue of one step: the card idle before the call, the time
  the call takes to return, median of 8 blocks;
- the device time of one step (``chip_smoke.cuda_ms``, behind a spin
  kernel, median of 7);
- the served Msps through ``StreamRunner`` at depth
  ``chip_smoke.SERVE_DEPTH``, device-resident blocks, with a copying
  sink (each block's symbols to pinned memory, then a copy for the
  sink) and with none: ``SERVE_WARMUP`` blocks first, then three passes
  of ``SERVE_BLOCKS`` blocks.

Each process prints its result as one JSON line; the last line of the
script is the four results and the card's name and power limit as JSON.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import comms_tpu_torch
    if Path(comms_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {comms_tpu_torch.__file__}, not {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.models import qpsk_rx_stream as tstream
    from comms_tpu_torch.runtime import StreamRunner

    dev = torch.device("cuda")
    re, im, _bits = cs.qpsk_capture(dev, seed=13)
    blocks = []
    for b in range(cs.SERVE_WARMUP + cs.SERVE_BLOCKS):
        a = (cs.QPSK_CFO * b * cs.QPSK_N) % (2 * np.pi)
        c, s = float(np.cos(a)), float(np.sin(a))
        blocks.append(((re * c - im * s).contiguous(),
                       (re * s + im * c).contiguous()))
    del re, im
    cfg = trx.QpskRxConfig()
    step = tstream.make_stream_fused_fn(cfg)

    st = tstream.init_state_fast(cfg, dev)
    enqueue = []
    for b in range(2 + 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = step(st, *blocks[b % len(blocks)])
        if b >= 2:
            enqueue.append((time.perf_counter() - t0) * 1e3)
    dev_ms = cs.cuda_ms(lambda: step(st, *blocks[0]))

    def serve(n, sink):
        torch.cuda.synchronize()
        return StreamRunner(lambda s, x: step(s, *x),
                            tstream.init_state_fast(cfg, dev), blocks[:n],
                            sink=sink, samples_of=lambda x: x[0].shape[0],
                            depth=cs.SERVE_DEPTH, device=dev).run().msps

    rates = {}
    for name, sink in (("copying_sink", lambda y: None), ("no_sink", None)):
        serve(cs.SERVE_WARMUP, sink)
        rates[name] = [serve(cs.SERVE_BLOCKS, sink) for _ in range(3)]
    return {"root": str(root), "block": cs.QPSK_N,
            "enqueue_ms": statistics.median(enqueue),
            "enqueue_ms_all": enqueue, "device_ms": dev_ms,
            "msps": rates}


def main() -> None:
    if sys.argv[1] == "--one":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())), flush=True)
        return
    a, b = (Path(p).resolve() for p in sys.argv[1:3])
    results = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, __file__, "--one", str(root)],
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            raise SystemExit(f"the run in {root} failed")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card, "order": ["A", "B", "B", "A"],
                      "results": results}))


if __name__ == "__main__":
    main()
