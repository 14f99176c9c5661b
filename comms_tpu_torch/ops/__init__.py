"""DSP math on tensors: FIR filtering and FM demodulation."""

from comms_tpu_torch.ops import demodulation, fir  # noqa: F401
