"""End-to-end pipelines: ``from comms_tpu_torch.models import fm_receiver``
(also ``bpsk_tx``, ``qpsk_tx``, ``qpsk_rx``, ...)."""

from comms_tpu_torch.models import bpsk_tx, qpsk_tx  # noqa: F401
