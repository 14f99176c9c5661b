"""``tools/recurrence_floor.py``'s host-side arithmetic, on the CPU: the
SASS loop count (static span and the fewest instructions an iteration
can issue) on hand-written SASS, and the three-term bound of the
recurrence kernels.  The probe's kernels themselves run on the card
(``chip_smoke.py`` phase 20, ``tools/recurrence_compare.py``)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import recurrence_floor as RF  # noqa: E402


def _sass(lines):
    """cuobjdump-style SASS text of ``(address, instruction)`` pairs."""
    return "\n".join(f"        /*{a:04x}*/                   {t} ;"
                     f"   /* 0x0000000000000000 */" for a, t in lines)


# A loop at 0x10..0xa0 (10 instructions): a slow region the fast path
# skips (0x30..0x50), a call the fast path skips (0x80, to 0xd0..0xe0).
SKIPPED = [(0x00, "MOV R1, c[0x0][0x28]"), (0x10, "FADD R2, R2, R3"),
           (0x20, "@!P0 BRA 0x60"), (0x30, "FMUL R4, R4, R4"),
           (0x40, "FMUL R4, R4, R4"), (0x50, "FMUL R4, R4, R4"),
           (0x60, "FADD R5, R5, R4"), (0x70, "@P1 BRA 0x90"),
           (0x80, "CALL.REL.NOINC 0xd0"), (0x90, "ISETP.NE.AND P2, PT, R7, RZ, PT"),
           (0xa0, "@!P2 BRA 0x10"), (0xb0, "EXIT"), (0xc0, "BRA 0xc0"),
           (0xd0, "FMUL R6, R6, R6"), (0xe0, "RET.REL.NODEC R20 0x0")]


def test_loop_counts_take_the_shortest_path_through_an_iteration():
    c = RF.loop_counts(_sass(SKIPPED))
    assert c["static"] == 10 / RF.STEPS_AN_ITERATION
    # 0x10, 0x20 (taken), 0x60, 0x70 (taken), 0x90, 0xa0
    assert c["fewest"] == 6 / RF.STEPS_AN_ITERATION


@pytest.mark.parametrize("call_skip, want", [
    # the call always runs: 0x10..0xa0 but the slow region (7), plus the
    # callee's two instructions (0xd0, 0xe0)
    ("NOP", 7 + 2),
    # an unconditional jump over the call: 0x10, 0x20, 0x60, 0x70, 0x90,
    # 0xa0
    ("BRA 0x90", 6),
])
def test_loop_counts_charge_a_call_its_callee(call_skip, want):
    lines = [(a, call_skip if a == 0x70 else t) for a, t in SKIPPED]
    assert RF.loop_counts(_sass(lines))["fewest"] == \
        want / RF.STEPS_AN_ITERATION


def test_loop_counts_raise_without_a_loop():
    with pytest.raises(RuntimeError, match="no loop"):
        RF.loop_counts(_sass([(0x00, "MOV R1, R2"), (0x10, "EXIT")]))


FLOOR = {"ns_a_step": 200.0, "issue_ns_a_stream_step": 0.002}


@pytest.mark.parametrize("B, by", [(1, "chain"), (16_896, "chain"),
                                   (50_000, "bytes"),
                                   (10 ** 6, "bytes")])
def test_bound_is_the_largest_term(B, by):
    n = 2048
    b = RF.bound_ms(FLOOR, B, n)
    assert b["chain_ms"] == pytest.approx(200.0 * n * 1e-6)
    assert b["bytes_ms"] == pytest.approx(16 * B * n / 3.35e12 * 1e3)
    assert b["issue_ms"] == pytest.approx(0.002 * B * n * 1e-6)
    assert b["bound_by"] == by
    assert b["bound_ms"] == max(b["chain_ms"], b["bytes_ms"],
                                b["issue_ms"])


def test_bound_names_where_each_term_passes_the_chain():
    b = RF.bound_ms(FLOOR, 1, 1)
    assert b["bytes_from_B"] == pytest.approx(200e-9 * 3.35e12 / 16)
    assert b["issue_from_B"] == pytest.approx(200.0 / 0.002)
    issue_first = dict(FLOOR, issue_ns_a_stream_step=0.01)
    assert RF.bound_ms(issue_first, 30_000, 64)["bound_by"] == "issue"
