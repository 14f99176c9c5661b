"""Digital modulation maps (BPSK / QPSK) on tensors.

Counterpart of :mod:`comms_tpu.ops.modulation`:

* ``bpsk_bit_mod``:  0 -> 1+0j, 1 -> -1+0j
* ``bpsk_byte_mod``: 8 samples a byte, LSB first
* ``qpsk_bit_mod``: 2-bit value v -> (1-2*(v&1)) + j*(1-2*((v>>1)&1))
* ``qpsk_byte_mod``: 4 symbols a byte, LSB pair first
* ``*_example``: the reference examples' conventions (BPSK ``2b - 1``;
  QPSK from consecutive bit pairs), which the transmitters use.

Elementwise maps on the device of the input; every value is exact.
"""

from __future__ import annotations

import torch

__all__ = [
    "bpsk_bit_mod",
    "bpsk_byte_mod",
    "qpsk_pair_mod",
    "qpsk_bit_mod",
    "qpsk_byte_mod",
    "bpsk_bit_mod_example",
    "qpsk_bits_mod_example",
    "unpack_bits_lsb_first",
]


def unpack_bits_lsb_first(bytes_, dtype=torch.int32):
    """[..., B] bytes -> [..., B*8] bits, LSB of each byte first."""
    b = torch.as_tensor(bytes_).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = (b[..., None] >> shifts) & 1
    return bits.reshape(*b.shape[:-1], -1).to(dtype)


def bpsk_bit_mod(bits, dtype=torch.complex64):
    """bit 0 -> +1, bit 1 -> -1."""
    bits = torch.as_tensor(bits)
    return (1 - 2 * bits.to(torch.float32)).to(dtype)


def bpsk_byte_mod(bytes_, dtype=torch.complex64):
    """Each byte -> 8 BPSK samples, LSB first."""
    return bpsk_bit_mod(unpack_bits_lsb_first(bytes_), dtype=dtype)


def qpsk_pair_mod(b0, b1, dtype=torch.complex64):
    """Map bit pair (b0 = LSB, b1 = MSB) to (1-2*b0) + j*(1-2*b1)."""
    b0 = torch.as_tensor(b0).to(torch.float32)
    b1 = torch.as_tensor(b1).to(torch.float32)
    return torch.complex(1 - 2 * b0, 1 - 2 * b1).to(dtype)


def qpsk_bit_mod(two_bit_vals, dtype=torch.complex64):
    """2-bit values in [0, 4) -> QPSK constellation."""
    v = torch.as_tensor(two_bit_vals).to(torch.int32)
    return qpsk_pair_mod(v & 1, (v >> 1) & 1, dtype=dtype)


def qpsk_byte_mod(bytes_, dtype=torch.complex64):
    """Each byte -> 4 QPSK symbols, LSB pair first."""
    b = torch.as_tensor(bytes_).to(torch.int32)
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=b.device)
    vals = (b[..., None] >> shifts) & 3
    return qpsk_bit_mod(vals.reshape(*b.shape[:-1], -1), dtype=dtype)


def bpsk_bit_mod_example(bits, dtype=torch.complex64):
    """Example-chain convention: bit b -> 2*b - 1 + 0j."""
    bits = torch.as_tensor(bits)
    return (2 * bits.to(torch.float32) - 1).to(dtype)


def qpsk_bits_mod_example(bits, dtype=torch.complex64):
    """Example-chain convention: consecutive bit pairs (x, y) ->
    (2x-1) + j(2y-1).  ``bits``' length must be even; returns len/2
    symbols."""
    bits = torch.as_tensor(bits).to(torch.float32)
    pairs = bits.reshape(*bits.shape[:-1], -1, 2)
    return torch.complex(2 * pairs[..., 0] - 1,
                         2 * pairs[..., 1] - 1).to(dtype)
