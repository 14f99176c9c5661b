"""torch_ops_ms: device time a block outside the port's own kernels
(the ``__global__`` functions of ``comms_tpu_torch/csrc``): PyTorch's
elementwise passes, transposes, cats and copies, in ms, from the
traced segment."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return 1e3 * sum(o.seconds for o in tr.device_ops
                     if not tr.is_port(o)) / tr.blocks
