"""Hand-written CUDA kernels and their plain PyTorch versions.

Each kernel module holds the wrapper (launches the kernel on a CUDA
tensor, runs the plain version on a CPU tensor, raises otherwise), the
plain version, and a ``launches`` counter.  Nothing is built or loaded
at import: :mod:`comms_tpu_torch.kernels._build` compiles the sources
under ``csrc/`` at the first launch.
"""
