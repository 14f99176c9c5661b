"""Hardware layer: radio protocols, the file-replay radio, rtl-sdr.

This package's copy of :mod:`comms_tpu.hardware`: host-side numpy that
feeds the block steps.  ``rtlsdr`` imports ``pyrtlsdr`` only where it is
installed (``HAVE_RTLSDR``).
"""

from comms_tpu_torch.hardware.radio import (  # noqa: F401
    FileReplayRadio,
    FileSinkRadio,
    RadioRx,
    RadioTx,
)
