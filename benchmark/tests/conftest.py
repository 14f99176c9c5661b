"""The benchmark's tests import its library (``benchmark/benchlib``) and
the program from the checkout; they run on the CPU at tiny sizes, but
for those marked ``cuda``, which skip where there is no card."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
