"""Parallel layer on an in-process mesh: the mesh, time-block sharding
with halo exchange (the ring kernel), channel sharding, the distributed
FFT and the sharded models.  Multi-process meshes (the JAX package's
``parallel/multihost.py``) come with a later slice."""

from comms_tpu_torch.parallel import (  # noqa: F401
    dfft,
    dryrun,
    fused_wideband,
    qpsk_rx_sharded,
    scaling,
    sharding,
    wideband,
    wideband2d,
)
