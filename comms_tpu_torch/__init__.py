"""comms_tpu_torch — the software-radio framework on PyTorch and CUDA.

The second implementation of :mod:`comms_tpu`, for NVIDIA Hopper cards
(H100).  It mirrors the JAX package's layout and names, so that each
module's counterpart is easy to find, and it never imports ``jax`` or
``comms_tpu``: the JAX package is the reference the tests hold this
one to.

Layout
------
``ops``       DSP on tensors: FIR filtering, demodulation, spectra, and
              the transmit chain (threefry sources, symbol maps, pulse
              shaping, mixer, PRNs).
``kernels``   hand-written CUDA kernels (sources under ``csrc/``,
              built by nvcc at first use) with their plain PyTorch
              versions beside them.
``models``    end-to-end pipelines: the FM receiver, the band monitor,
              the channelizer, the QPSK receiver, the BPSK and QPSK
              transmitters.
``parallel``  the sharded layer on an in-process mesh.
``runtime``   streaming executor and throughput metrics.
``io``, ``util``  raw IQ files and SNR metrics (numpy).

Importing the package builds nothing and loads no kernel library.
"""

__version__ = "0.1.0"

from comms_tpu_torch import ops  # noqa: F401

# kernels, models and runtime import on demand:
# `from comms_tpu_torch.models import fm_receiver`.
