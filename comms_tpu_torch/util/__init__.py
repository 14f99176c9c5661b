"""Signal metrics: ``from comms_tpu_torch.util import snr``."""
