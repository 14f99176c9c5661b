"""The examples' shared argument: ``--device``."""

from __future__ import annotations

import argparse


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device`` option
    (default ``cuda``)."""
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p
