"""Block/state runtime: the BlockOps, ``Pipeline`` and ``Graph``
composers, checkpoints, the streaming executors and throughput metrics
(the counterpart of :mod:`comms_tpu.runtime`)."""

from comms_tpu_torch.runtime.block import (  # noqa: F401
    BlockOp,
    BpskMod,
    Decimate,
    Fft,
    Fir,
    FirDecimate,
    FmDemod,
    Ifft,
    Lambda,
    Mixer,
    Nco,
    NormalSource,
    PrnSource,
    PulseShape,
    QpskMod,
    RationalResample,
    RandomBitSource,
    UniformSource,
    Upsample,
)
from comms_tpu_torch.runtime.graph import (  # noqa: F401
    Graph, GraphNotConnectedError)
from comms_tpu_torch.runtime.metrics import (  # noqa: F401
    ThroughputMeter, device_sync)
from comms_tpu_torch.runtime.pipeline import Pipeline  # noqa: F401
from comms_tpu_torch.runtime.stream import (  # noqa: F401
    BatchedStreamRunner, StreamRunner)
