"""End-to-end pipelines: ``from comms_tpu_torch.models import fm_receiver``."""
