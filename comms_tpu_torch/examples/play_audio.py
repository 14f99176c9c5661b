"""Play (or transcode) a raw float32 PCM file.

Counterpart of ``examples/play_audio.py``, in parity with the
reference's ``examples/play_audio.rs``: stream file samples into the
audio sink, a WAV file here.  Host work only (``models/play_audio``
moves no sample to a device), so this example alone has no
``--device``.

Usage: python -m comms_tpu_torch.examples.play_audio input.f32 [out.wav]
       [rate]
"""

from __future__ import annotations

import argparse

from comms_tpu_torch.models import play_audio


def parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input")
    p.add_argument("out", nargs="?", default="play_out.wav")
    p.add_argument("rate", nargs="?", type=int, default=44100)
    return p


def main(argv=None) -> int:
    """Returns the samples played."""
    args = parser().parse_args(argv)
    n = play_audio.play_file(args.input, args.out, sample_rate=args.rate)
    print(f"played {n} samples")
    return n


if __name__ == "__main__":
    main()
