"""Time-sharded QPSK receiver: distributed synchronisation.

Counterpart of :mod:`comms_tpu.parallel.qpsk_rx_sharded`: the one-shot
fused receiver core (``models.qpsk_rx``) split over a time ring, with

* **global estimates from summed correlation panels**: each shard
  computes the [128, 128 + 2 HW] panels of its slice of the raw planes
  (K5's panel entry on CUDA shards), the four panels are summed in shard
  order, and every estimate (coarse carrier, Mengali timing with the
  matched-filter fold, per-phase symbol energies) is computed once from
  the sums; the per-shard edge truncation loses O(HW / N_shard)
  cross-boundary lag products, the edge terms the one-device core
  carries as well;
* **a per-shard fused symbol product** (K5's ``_scalars`` entry on CUDA
  shards) with the left neighbour's raw tail as carried context (MD-1
  samples of both planes, one launch of the ring kernel), so the global
  symbol grid has no gaps at shard boundaries;
* **global phase coherence**: each shard's symbol-rate rotation starts at
  ``phase0 = w * shard_start`` (reduced mod 2 pi per factor), and the
  symbol tail sums its estimator sums over the shards and rotates each
  shard from its global symbol offset; the port's residual-slope fit
  (``qpsk_rx._phase_slope``) runs on the global segment sums.
"""

from __future__ import annotations

import torch

from comms_tpu_torch.models import qpsk_rx as _rx
from comms_tpu_torch.ops import demodulation
from comms_tpu_torch.parallel import sharding as sh

__all__ = ["make_sharded_rx_step"]


def make_sharded_rx_step(cfg: "_rx.QpskRxConfig", mesh: sh.Mesh,
                         axis: str = "time"):
    """Returns ``(re[N], im[N]) -> (sym_planes[2, N/sps], diag)``, global
    tensors in and out.  ``cfg.sps`` must satisfy the fused core's
    constraint (4 <= sps, sps | 128); the per-shard length must be a
    multiple of sps (validated).

    Semantics: the one-shot fused receiver over the whole block with
    estimates global up to edge terms; the symbols match the one-device
    ``qpsk_rx._rx_core_fused`` to estimator-edge-term precision."""
    n = mesh.axis_size(axis)
    sps = cfg.sps
    lanes = demodulation.TimingEstimator.LANES
    if not (4 <= sps <= lanes and lanes % sps == 0):
        raise ValueError(f"sharded rx needs 4 <= sps | {lanes}, "
                         f"got {sps}")
    C = _rx.fused_gemm_ctx_len(cfg)
    pos = mesh.axis_index(axis)

    def reduce(parts):
        return sh.psum(parts, mesh, axis)[0]

    def step(re, im):
        res = sh.shard(re, mesh, (axis,))
        ims = sh.shard(im, mesh, (axis,))
        nloc = int(res[0].shape[0])
        if nloc % sps:
            # local k mod sps must equal global k mod sps: the r2 lag
            # rotation, the per-phase energy fold and the global symbol
            # grid all assume it.
            raise ValueError(
                f"per-shard length {nloc} must be a multiple of "
                f"sps={sps}")
        if nloc * n >= 2 ** 31:
            raise ValueError("global block >= 2^31 samples overflows "
                             "the int32 position grid")
        ntot = nloc * n

        # --- panels on the local slices; their sum makes them global.
        panels = [_rx._corr_panels(cfg, r, i) for r, i in zip(res, ims)]
        P = reduce([p[:4] for p in panels])
        f_est, t_est, lag, shift, p_star = _rx._estimates_from_panels(
            cfg, (*P, panels[0][4]))
        shift2 = torch.clamp(shift - p_star, -sps, 2 * sps - 4)

        # --- per-shard symbol product: the left neighbour's raw tail as
        # context (zeros on the first shard), the global de-rotation
        # phase at the shard's first sample.
        zc = res[0].new_zeros(C)
        ctx_r, ctx_i = sh.halo_exchange((res, ims), (zc, zc), C, mesh, axis)
        lo = 3 + torch.clamp(shift2, min=0)
        hi = ntot + torch.clamp(shift2, max=0)
        srs, sis = [], []
        for s in range(mesh.size):
            phase0 = _rx._two_pi_anchor(f_est, nloc, pos[s])
            sr, si = _rx._fused_symbol_gemm(
                cfg, res[s], ims[s], f_est, lag, shift2,
                ctx=(ctx_r[s], ctx_i[s]), phase0=phase0)
            # the one-shot core's edge mask, at global positions (head
            # transient on shard 0, shifted-off tail on the last shard)
            m4 = (torch.arange(sr.shape[0], device=sr.device)
                  + pos[s] * (nloc // sps)) * sps
            valid = (m4 >= lo) & (m4 < hi)
            srs.append(torch.where(valid, sr, 0.0))
            sis.append(torch.where(valid, si, 0.0))

        # --- fine carrier and Mengali phase: the shared symbol tail with
        # the shards' estimator sums added and each shard's global symbol
        # offset anchoring its rotation.
        syms, dtail = _rx._symbol_tail(
            srs, sis, reduce=reduce, sym_offset=(nloc // sps, pos))
        diag = {"freq": f_est, "timing": t_est, "sym_phase": p_star,
                **dtail}
        return sh.unshard(syms, mesh, (None, axis)), diag

    return step
