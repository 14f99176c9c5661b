"""DSP math on tensors: FIR filtering, demodulation, gain control, and
the transmit chain's sources, maps, pulse shaping, mixer and PRNs."""

from comms_tpu_torch.ops import agc, demodulation, fir  # noqa: F401
from comms_tpu_torch.ops import (  # noqa: F401
    mixer, modulation, prns, pulse, random, taps, txshape,
)
