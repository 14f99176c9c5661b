"""File I/O: ``from comms_tpu_torch.io import raw_iq``."""
