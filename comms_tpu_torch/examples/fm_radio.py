"""FM broadcast receiver: recorded IQ capture -> demodulated audio.

Counterpart of ``examples/fm_radio.py``, in parity with the reference's
``examples/fm_radio.rs`` with the SDR source replaced by a recorded
rtl-sdr capture (raw interleaved u8 IQ) and the audio device by a WAV
file.  The capture streams through ``fm_receiver.run_file`` at its
default configuration (262,144-sample blocks, read ahead by the native
block reader); the audio, scaled to its peak, goes to a 45,600 Hz WAV.

Usage: python -m comms_tpu_torch.examples.fm_radio capture.u8 [out.wav]
       [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.io import audio as caudio
from comms_tpu_torch.models import fm_receiver


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("capture")
    p.add_argument("out", nargs="?", default="fm_audio.wav")
    return p


def main(argv=None) -> int:
    """Returns the audio samples written."""
    args = parser().parse_args(argv)
    # 1.14 Msps capture, /25 -> 45.6 kHz audio (fm_radio.rs:57,148-151).
    audio = fm_receiver.run_file(args.capture, device=args.device)
    if len(audio) == 0:
        print(f"capture shorter than one block "
              f"({fm_receiver.FmReceiverConfig().block} samples); "
              f"nothing to demodulate")
        sys.exit(1)
    with caudio.WavSink(args.out, channels=1, sample_rate=45600) as sink:
        peak = np.max(np.abs(audio)) or 1.0
        sink.write(audio / peak)
    print(f"wrote {len(audio)} audio samples to {args.out}")
    return len(audio)


if __name__ == "__main__":
    main()
