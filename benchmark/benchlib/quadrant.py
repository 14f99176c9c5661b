"""The check's canonical form of a QPSK Costas loop's 4-fold phase
ambiguity, shared by a served path and its reference.

A decision-directed loop locks to any of the four quarter-turns; which
one is set while it pulls in, through cycle slips whose count a float32
and a float64 receiver can take differently on the same input.  Every
quarter-turn is as right as the other three (a receiver resolves it with
a unique word), so both sides take theirs out the same way and are
compared symbol by symbol: each carrier's block is turned so that its
first symbol lies in the first quadrant.  The turn multiplies by 0 and
+-1 only, so it rounds nothing.  Anything else, a slip inside a block
among it, still shows.
"""

from __future__ import annotations

import torch


def first_quadrant(sym):
    """Pairs ``[B, M, 2]``, each row multiplied by (-j)^k, k the quadrant
    of its first symbol counted counter-clockwise from re >= 0, im >= 0
    (k = 0), which takes that symbol into the first quadrant: one
    elementwise pass over the block.  The turns are made where the
    symbols are, so a round on the card copies nothing from the host."""
    z = torch.view_as_complex(sym.contiguous())
    left, down = z[:, :1].real < 0, z[:, :1].imag < 0
    one = torch.ones_like(z[:, :1].real)
    zero = torch.zeros_like(one)
    sign = torch.where(left, -one, one)
    # k = 0: 1, k = 1 (left): -j, k = 2 (left, down): -1, k = 3 (down): j
    turn = torch.complex(torch.where(left == down, sign, zero),
                         torch.where(left != down, sign, zero))
    return torch.view_as_real(z * turn)
