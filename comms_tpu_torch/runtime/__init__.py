"""Streaming executor and throughput metrics."""

from comms_tpu_torch.runtime.metrics import ThroughputMeter, device_sync  # noqa: F401
from comms_tpu_torch.runtime.stream import StreamRunner  # noqa: F401
