"""2-D (time x channel) mesh for the wideband band monitor.

Counterpart of :mod:`comms_tpu.parallel.wideband2d`: a ``('time',
'chan')`` mesh where

* **stage 1 (channelize)** is time-local: the raw sample axis is sharded
  over the flattened mesh, every shard channelizes its slice with one
  overlap-save halo (prototype length T-1) over the flattened ring;
* **corner turn** within each time row over ``chan``: shard (t, c) then
  holds all frames of time row t for its K/nc channels;
* **stage 2 (per-channel FM receivers)** is channel-local, with a 1-frame
  (demod lag) and an MD-1-frame (audio FIR) halo along ``time`` within
  each channel column;
* **reductions**: the per-channel power map sums the time rows of each
  column in row order; the next state is the last time row's.

The JAX package runs the per-shard channelizer and audio FIR at the XLA
level.  On CUDA shards the port routes them as its staged band monitor
does (``models.fm_band_monitor``): the channelizer through K8
(``kernels.channelizer``) when the shard's slice is a multiple of the
kernel step, and the audio FIR through K2 (``kernels.decim_fir``), all
the shard's channels in one launch (channel k as the re plane and k +
K/(2 nc) as the im plane of a batch row) when the shard holds an even
number of channels and its row of frames divides a kernel tile; else the
tensor ops.  Each halo is one launch of the ring kernel: the channelizer
halo both planes over the flattened ring, the demod halo both planes of
every column, the audio halo every column.  The demod runs on time-major
[frames, channels] planes, so every tail the rings read is contiguous.
Outputs equal the single-device band monitor (the halos reproduce every
window).

The mesh may span processes (``parallel.multihost``): after
``multihost.init`` :func:`mesh_2d` lays the grid over the group in rank
order, as the JAX package's grid over ``jax.devices()``, and the step
takes ``multihost.host_feed(block, mesh, ("time", "chan"))``.  Each
process then computes only its own shards; the halos, the stream
context and the corner turn's blocks that cross processes go through
the ring kernel into the other process's windows (gloo on the CPU), the
power map's sum and the state's last time row through gloo on host
copies, exact, so every process's shards equal the one-process mesh's
bit for bit.
"""

from __future__ import annotations

import torch

from comms_tpu_torch.kernels import channelizer as _CK
from comms_tpu_torch.kernels import decim_fir as _DF
from comms_tpu_torch.models.fm_band_monitor import BandMonitorConfig
from comms_tpu_torch.ops import channelizer as chan
from comms_tpu_torch.ops import demodulation as demod
from comms_tpu_torch.ops import fir
from comms_tpu_torch.parallel import multihost
from comms_tpu_torch.parallel import sharding as sh

__all__ = ["mesh_2d", "make_sharded_band_monitor_2d"]


def mesh_2d(nt: int, nc: int, t_axis: str = "time", c_axis: str = "chan",
            device="cuda") -> sh.Mesh:
    """An ``(nt, nc)`` mesh named ``(t_axis, c_axis)``.  In one process
    every shard lies on ``device`` (shards may share it); after
    ``multihost.init`` with W processes each owns nt * nc / W shards,
    contiguous in row-major order, on ``cuda:(rank % device_count)`` (or
    the CPU), and W must divide nt * nc (``multihost.process_mesh``)."""
    return multihost.process_mesh((nt, nc), (t_axis, c_axis), device)


def _audio_tile_rows(frames_row: int, kl: int, cfg) -> int:
    """Tile rows of the K2 route for a shard's [Kl, frames_row] demod
    rows, or 0 for the tensor route (the staged band monitor's rule, on
    the shard's row)."""
    if kl % 2 or cfg.audio_taps.shape[0] > _DF.max_taps(cfg.audio_dec):
        return 0
    tr = 128
    while tr >= 8 and frames_row % (tr * cfg.audio_dec * 128):
        tr //= 2
    return tr if tr >= 8 else 0


def make_sharded_band_monitor_2d(cfg: BandMonitorConfig, mesh: sh.Mesh,
                                 t_axis: str = "time", c_axis: str = "chan",
                                 fast_demod: bool = True):
    """``(state, iq_pairs[N, 2]) -> ((audio[K, M], power[K]), state)`` over
    the 2-D mesh, global tensors in and out on a mesh in one process.
    ``state`` is the single-device ``fm_band_monitor.init_state`` tuple
    (channelizer tail [T-1, 2], per-channel FM prev [K, 2], per-channel
    audio tails [K, MD-1]).  On a mesh across processes ``iq_pairs`` is
    ``multihost.host_feed``'s value over ``(t_axis, c_axis)`` (or the
    whole block on every process), audio and power come back as this
    process's shards (``sharding.Sharded``, laid out as JAX's out_specs:
    audio over (chan, time), power over chan) and the state whole on every
    process.  On CUDA shards K8 and K2 run where they apply (module
    docstring).

    Constraints (validated): ``N % (nt*nc*K) == 0``, ``K % nc == 0``,
    per-row frames ``% audio_dec == 0`` and ``>= MD - 1``, and the
    per-shard slice must cover the T-1 channelizer halo."""
    nt, nc = mesh.shape[t_axis], mesh.shape[c_axis]
    K = cfg.num_channels
    T = K * cfg.taps_per_branch
    Tm1 = cfg.audio_C.size - 1
    N = cfg.block
    if K % nc:
        raise ValueError(f"channels {K} must divide over chan axis {nc}")
    if N % (nt * nc * K):
        raise ValueError(f"block {N} must divide by devices*K "
                         f"= {nt * nc * K}")
    n_local = N // (nt * nc)          # raw samples per shard
    if n_local < T - 1:
        raise ValueError(f"per-device slice {n_local} smaller than "
                         f"channelizer halo {T - 1}")
    frames_row = N // (nt * K)        # frames per time row
    if frames_row % cfg.audio_dec:
        raise ValueError(f"per-row frames {frames_row} must divide by "
                         f"audio_dec {cfg.audio_dec}")
    if frames_row < Tm1:
        raise ValueError(f"per-row frames {frames_row} smaller than "
                         f"audio halo {Tm1}")
    both = (t_axis, c_axis)
    kl = K // nc
    at2 = demod.fast_atan2 if fast_demod else torch.atan2
    ftot = float(N // K)
    cuda = mesh.devices[mesh.local[0]].type == "cuda"
    k8 = (cuda and 128 % K == 0 and n_local % _CK.step_samples() == 0
          and T - 1 <= _CK.CTX_SAMPLES)
    tile = _audio_tile_rows(frames_row, kl, cfg) if cuda else 0
    last_t = [s for s in range(mesh.size)
              if mesh.coords(s)[t_axis] == nt - 1]
    W = cfg.audio_dec * 128

    def channelize(re, im, cre, cim):
        if not k8:
            yr, yi, _, _ = chan.channelize_block_planar(re, im, cfg.Hb,
                                                        cre, cim)
            return yr, yi
        zc = re.new_zeros(_CK.CTX_SAMPLES - (T - 1))
        yr, yi, _, _ = _CK.channelize_planar(
            re, im, cfg.prototype, torch.cat([zc, cre]),
            torch.cat([zc, cim]), num_channels=K)
        return yr, yi

    def audio_fir(d, dctx):
        # d [Kl, frames_row] channel-major, dctx [Kl, MD-1]
        if not tile:
            return fir.fir_decimate_poly(d, cfg.audio_C, dctx)[0]
        kctx = d.new_zeros((kl, W))
        kctx[:, W - Tm1:] = dctx
        h = kl // 2
        yr, yi, _, _ = _DF.fir_decimate_planar(
            d[:h], d[h:], cfg.audio_taps, cfg.audio_dec, kctx[:h],
            kctx[h:], tile_rows=tile)
        return torch.cat([yr, yi])

    def step(state, iq):
        ctx_pairs, prev_pairs, actxs = state
        pairs = sh.shard(iq, mesh, (both, None))
        res = [p[:, 0].contiguous() for p in pairs]
        ims = [p[:, 1].contiguous() for p in pairs]
        prev_s = sh.shard(prev_pairs, mesh, (c_axis, None))    # [Kl, 2]
        actx_s = sh.shard(actxs, mesh, (c_axis, None))         # [Kl, MD-1]
        local = range(len(mesh.local))

        # --- stage 1: channelize each shard's raw slice; overlap-save
        # halo from the flattened ring's left neighbour.
        cre, cim = sh.halo_exchange((res, ims), (ctx_pairs[:, 0],
                                                 ctx_pairs[:, 1]),
                                    T - 1, mesh, both)
        ys = [channelize(res[k], ims[k], cre[k], cim[k]) for k in local]
        new_ctx_re, new_ctx_im = (
            c[0] for c in sh.collect_ctx((res, ims), T - 1, mesh, both))

        # --- corner turn within the time row: [fl, K] -> [frames_row,
        # Kl] (time-major), both planes in one call.
        yr, yi = sh.corner_turn(([y[0] for y in ys], [y[1] for y in ys]),
                                mesh, c_axis)

        # --- stage 2: per-channel FM demod on time-major planes; the
        # lag-1 frame crosses time rows of the same column, row 0 reads
        # the carried per-channel prev state.
        prow_r, prow_i = sh.halo_exchange(
            (yr, yi), ([p[:, 0][None, :] for p in prev_s],
                       [p[:, 1][None, :] for p in prev_s]), 1, mesh, t_axis)
        d_tm = []
        for k in local:
            a, b = yr[k][1:], yr[k][:-1]
            c, d_ = yi[k][1:], yi[k][:-1]
            d_int = at2(c * b - a * d_, a * b + c * d_)
            p_r, p_i = prow_r[k][0], prow_i[k][0]
            r0, i0 = yr[k][0], yi[k][0]
            d0 = at2(i0 * p_r - r0 * p_i, r0 * p_r + i0 * p_i)
            d_tm.append(torch.cat([d0[None, :], d_int]))   # [frames, Kl]

        # --- audio FIR + decimate per channel: MD-1-frame halo along time,
        # row 0 reads the carried audio tails.
        dctx = sh.halo_exchange(d_tm, [a.T for a in actx_s], Tm1, mesh,
                                t_axis)                    # [MD-1, Kl]
        audio = [audio_fir(d_tm[k].T.contiguous(), dctx[k].T.contiguous())
                 for k in local]                           # [Kl, M/nt]

        # --- the per-channel power map: each column's time rows summed in
        # row order.
        power = sh.psum([torch.sum(yr[k] * yr[k] + yi[k] * yi[k], dim=0)
                         for k in local], mesh, t_axis)

        # --- the next state: the last time row's prev frame and audio
        # tails ([Kl, 2 + MD-1] a shard), gathered whole on every process.
        rows = sh.all_gather(
            [torch.cat([torch.stack([yr[k][-1], yi[k][-1]], dim=-1),
                        d_tm[k][d_tm[k].shape[0] - Tm1:].T], dim=1)
             for k in local], mesh)
        last = torch.cat([rows[s] for s in last_t])
        new_state = (torch.stack([new_ctx_re, new_ctx_im], dim=-1),
                     last[:, :2].contiguous(), last[:, 2:].contiguous())
        return ((sh.unshard(audio, mesh, (c_axis, t_axis)),
                 sh.unshard([p / ftot for p in power], mesh, (c_axis,))),
                new_state)

    return step

