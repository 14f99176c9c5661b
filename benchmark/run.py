#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names its
configuration and traffic; everything else is found by those names
(``benchlib/serve.py``).  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a traced segment served after the window.  The last lines of
standard error, and the result's last key, give each number compared
with the plain reference beside its limit; the last line of standard
output is the result.

Exits with 2, printing no result, where there is no CUDA card (or fewer
than the cell asks for), and with 3 where a JAX module (``jax``,
``jaxlib``, ``flax``, ``comms_tpu``) is loaded once the window has
closed.

The process serves from one host core, the last it may use: on a host
whose cores other work shares, a host-paced step reads steadier rates
held to one core than free to move between them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def one_core() -> None:
    """Hold this process, and the threads it starts, to one host core."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    one_core()

    from benchlib import serve

    try:
        result, compared = serve.run_cell(a.workload, a.seed, a.seconds,
                                          bool(a.trace), t0=T0)
    except serve.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = serve.forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
