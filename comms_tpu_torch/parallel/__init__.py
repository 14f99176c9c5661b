"""Parallel layer: the mesh, time-block sharding with halo exchange (the
ring kernel), channel sharding, the distributed FFT, the sharded models
and the multi-process runtime (``multihost``: a mesh whose shards span
processes on ``torch.distributed``)."""

from comms_tpu_torch.parallel import (  # noqa: F401
    dfft,
    dryrun,
    fused_wideband,
    multihost,
    qpsk_rx_sharded,
    scaling,
    sharding,
    wideband,
    wideband2d,
)
