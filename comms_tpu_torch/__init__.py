"""comms_tpu_torch — the software-radio framework on PyTorch and CUDA.

The second implementation of :mod:`comms_tpu`, for NVIDIA Hopper cards
(H100).  It mirrors the JAX package's layout and names, so that each
module's counterpart is easy to find, and it never imports ``jax`` or
``comms_tpu``: the JAX package is the reference the tests hold this
one to.

Layout
------
``ops``       FIR filtering and FM demodulation on tensors.
``kernels``   hand-written CUDA kernels (sources under ``csrc/``,
              built by nvcc at first use) with their plain PyTorch
              versions beside them.
``models``    end-to-end pipelines: the FM broadcast receiver.
``runtime``   streaming executor and throughput metrics.

Importing the package builds nothing and loads no kernel library.
"""

__version__ = "0.1.0"

from comms_tpu_torch import ops  # noqa: F401

# kernels, models and runtime import on demand:
# `from comms_tpu_torch.models import fm_receiver`.
