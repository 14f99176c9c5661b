"""The panel-side reductions of the QPSK estimate chain: one CUDA kernel,
and its plain version.

``panel_reductions(p13, p24, hw, sps)`` takes the symbol kernel's two
[256, 256] panel accumulators (``p13 = [P1; P3]``, ``p24 = [-P2; -P4]``,
zero past the panel width) and returns a [16, 128] float32 block:

* rows 0/1, lanes v <= 2*hw: ``gr[v], gi[v]``, the r2-rotated lag sums
  of ``TimingEstimator.lag_sums_r2`` (lag v - hw);
* row 2, lane 0: the polynomial atan2 of the v = -1 lag sum, (gi, gr) at
  lane hw - 1.  This is the angle of the r2-ROTATED sum, which the TPU
  kernel's docstring calls the frequency estimate; it is not the
  receiver's ``f_est`` (that one sums the unrotated diagonal);
* rows 8+a (a < sps), lanes v <= 2*hw: the sums of row 0 restricted to
  panel rows j = a (mod sps);
* every other entry 0 (the TPU kernel leaves them unwritten).

``csrc/panel_reduce.cu`` replaces the TPU kernel
``comms_tpu/kernels/panel_reduce_pallas.py::panel_reductions``, with
hw <= 63 (at 64 its 128 lanes drop the v = +hw lag).  Neither package's
models call it: it is the standalone groundwork kernel it was on the
TPU.  The wrapper launches the kernel for CUDA tensors and runs
:func:`panel_reductions_plain` for CPU tensors; any other device raises.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import demodulation as _demod

__all__ = ["panel_reductions", "panel_reductions_plain", "HW_MAX"]

_LANES = 128
HW_MAX = 63

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def _check(p13, p24, hw: int, sps: int):
    if not 0 < hw <= HW_MAX:
        raise ValueError(f"hw must be in (0, {HW_MAX}], got {hw}")
    if not 1 <= sps <= 8:
        raise ValueError(f"sps must be in [1, 8], got {sps}")
    for name, p in (("p13", p13), ("p24", p24)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if (p.dtype != torch.float32 or tuple(p.shape) != (256, 256)
                or not p.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[256, 256] tensor, got {p.dtype} "
                             f"{tuple(p.shape)}")
    if p24.device != p13.device:
        raise ValueError("p13 and p24 must share a device")


def panel_reductions(p13, p24, hw: int, sps: int = 4):
    """[16, 128] boundary reductions of the panel accumulators (module
    docstring)."""
    global launches
    hw, sps = int(hw), int(sps)
    _check(p13, p24, hw, sps)
    dev = p13.device
    if dev.type == "cpu":
        return panel_reductions_plain(p13, p24, hw, sps)
    if dev.type != "cuda":
        raise ValueError(f"the panel reductions run on CUDA or CPU "
                         f"tensors, got {dev}")
    lib = _build.load()
    out = torch.empty((16, _LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.panel_reduce_launch(p13.data_ptr(), p24.data_ptr(), hw,
                                     sps, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"panel reduction kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def panel_reductions_plain(p13, p24, hw: int, sps: int = 4):
    """The kernel's function in plain PyTorch, on any device."""
    dev = p13.device
    P1, P3 = p13[:_LANES], p13[_LANES:]
    P2, P4 = -p24[:_LANES], -p24[_LANES:]
    a = np.arange(_LANES) % sps
    rphase = (a.astype(np.float32)[:, None]
              * np.float32(2.0 * np.pi / sps)).astype(np.float32)
    ph = _build.device_constant(rphase, dev)
    c2, s2 = torch.cos(ph), torch.sin(ph)
    Er = (c2 * P1 + s2 * P3) - (c2 * P4 - s2 * P2)
    Ei = (c2 * P2 + s2 * P4) + (c2 * P3 - s2 * P1)
    V = 2 * hw + 1
    cols = _build.device_index(
        np.arange(_LANES)[:, None] + np.arange(V)[None, :], dev)
    Dr = torch.gather(Er, 1, cols)             # [128, V]: E[j, j + v]
    Di = torch.gather(Ei, 1, cols)
    out = torch.zeros((16, _LANES), dtype=torch.float32, device=dev)
    out[0, :V] = Dr.sum(0)
    out[1, :V] = Di.sum(0)
    out[2, 0] = _demod.fast_atan2(out[1, hw - 1], out[0, hw - 1])
    for r in range(sps):
        out[8 + r, :V] = Dr[r::sps].sum(0)
    return out
