"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel module holds the wrapper (launches the kernel on a CUDA
tensor, runs the plain version on a CPU tensor, raises otherwise), the
plain version, and a ``launches`` counter.  A wrapper runs inside a
``kernel.<module>`` span (:func:`comms_tpu_torch.runtime.metrics.scoped`)
from its checks to the launch's return, so under ``torch.profiler`` the
launch nests under it.  Nothing is built or loaded at import: :mod:`comms_tpu_torch.kernels._build` compiles the sources
under ``csrc/`` at the first launch.
"""
