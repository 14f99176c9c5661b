"""Sharded fused chains: the single-kernel FM chain and the fused band
monitor, per shard.

Counterpart of :mod:`comms_tpu.parallel.fused_wideband`.  The fused FM
kernel (K1, :mod:`comms_tpu_torch.kernels.fm_chain`) runs per shard on
its slice of the u8 planes, and each shard's carried context comes from
its left neighbour's raw input tail: the fused block step already
recomputes its context from the last ``FUSED_TAIL_SAMPLES`` (25,669) raw
samples (``fm_receiver.fused_ctx_from_raw_tail``), and a shard boundary
is a block boundary.  So one ring exchange of the u8 tails (both planes
in one launch of the ring kernel) plus the same recompute gives each
shard the context a sequential run of ``make_fused_block_fn`` over
per-shard-sized blocks would carry: the two are bit-equal.  Shard 0 uses
the carried stream state (the ring's wrapped tail is not read); the next
block's state is recomputed from the global tail.

:func:`make_sharded_band_monitor_step` composes the fused band-monitor
kernel (K9) the same way, with ``fm_band_monitor.
fused_state_from_raw_tail`` of the left neighbour's float32 tail.
"""

from __future__ import annotations

import torch

from comms_tpu_torch.kernels import band_monitor as _BM
from comms_tpu_torch.kernels import fm_chain as _K
from comms_tpu_torch.kernels import halo_ring as _HR
from comms_tpu_torch.models import fm_band_monitor as _M
from comms_tpu_torch.models import fm_receiver
from comms_tpu_torch.parallel import sharding as sh

__all__ = ["make_sharded_fused_step", "fused_init_state",
           "make_sharded_band_monitor_step", "TAIL_SAMPLES"]

TAIL_SAMPLES = fm_receiver.FUSED_TAIL_SAMPLES

# re-export so callers need one module
fused_init_state = fm_receiver.fused_init_state


def _raw_tails(mesh: sh.Mesh, axis, planes, tail: int):
    """Each shard's left neighbour's last ``tail`` samples of every plane,
    one launch of the ring kernel for all the planes (the ring wraps;
    the first shard's entry is not read)."""
    rings = mesh.rings(axis)
    if len(rings[0]) == 1:
        return [[None] * mesh.size for _ in planes]
    got = _HR.exchange([[p[s] for s in ring] for p in planes
                        for ring in rings], tail)
    out = [[None] * mesh.size for _ in planes]
    k = 0
    for pi in range(len(planes)):
        for ring in rings:
            for s, t in zip(ring, got[k]):
                out[pi][s] = t
            k += 1
    return out


def make_sharded_fused_step(mesh: sh.Mesh, block: int, axis: str = "time"):
    """``(state, re_u8[N], im_u8[N]) -> (audio[N/25], state)``, global
    planes and audio, one K1 launch per shard on CUDA shards.

    ``state`` is the fused chain's context dict (:func:`fused_init_state`
    at stream start), interchangeable with the single-device
    ``make_fused_block_fn`` state, so a stream can move between one
    device and a mesh mid-flight."""
    n = mesh.axis_size(axis)
    if block % n:
        raise ValueError(f"block {block} must divide over {n} shards")
    local_n = block // n
    if local_n % _K.IN_PER_STEP:
        raise ValueError(
            f"per-shard length {local_n} must be a multiple of the "
            f"kernel step {_K.IN_PER_STEP}")
    if local_n < TAIL_SAMPLES:
        raise ValueError(
            f"per-shard length {local_n} must cover the raw context "
            f"tail ({TAIL_SAMPLES})")
    first = [i == 0 for i in mesh.axis_index(axis)]
    taps = fm_receiver.FM_LPF_TAPS

    def step(state, re_u8, im_u8):
        res = sh.shard(re_u8, mesh, (axis,))
        ims = sh.shard(im_u8, mesh, (axis,))
        recv_re, recv_im = _raw_tails(mesh, axis, (res, ims), TAIL_SAMPLES)
        audio = []
        for s in range(mesh.size):
            ctx = (state if first[s] else
                   fm_receiver.fused_ctx_from_raw_tail(recv_re[s],
                                                       recv_im[s]))
            audio.append(_K.fm_chain_fused(res[s], ims[s], ctx, taps, taps))
        # the next block's stream context: the global raw tail.
        new_state = fm_receiver.fused_ctx_from_raw_tail(
            re_u8[-TAIL_SAMPLES:], im_u8[-TAIL_SAMPLES:])
        return sh.unshard(audio, mesh, (axis,)), new_state

    return step


def make_sharded_band_monitor_step(cfg, mesh: sh.Mesh, block: int,
                                   axis: str = "time"):
    """Sharded fused band monitor: ``(state, re[N], im[N]) -> (audio[K,
    N/K/dec], state)``, global planes and audio, one K9 launch per shard
    on CUDA shards.  Each shard's carried state (input-tail planes and
    spectrum halo) derives from its left neighbour's raw float32 tail
    (both planes in one ring launch) through ``fm_band_monitor.
    fused_state_from_raw_tail``; ``state`` (``init_state_fused``) is
    interchangeable with the single-device fused stream mid-flight, to
    the spectrum-halo recompute's ~1e-5."""
    n = mesh.axis_size(axis)
    if block % n:
        raise ValueError(f"block {block} must divide over {n} shards")
    local_n = block // n
    if local_n % _BM.step_samples():
        raise ValueError(
            f"per-shard length {local_n} must be a multiple of the "
            f"kernel step {_BM.step_samples()}")
    tail = _M.fused_tail_samples(cfg)
    if local_n < tail:
        raise ValueError(
            f"per-shard length {local_n} must cover the raw context "
            f"tail ({tail})")
    first = [i == 0 for i in mesh.axis_index(axis)]

    def step(state, re, im):
        res = sh.shard(re, mesh, (axis,))
        ims = sh.shard(im, mesh, (axis,))
        recv_re, recv_im = _raw_tails(mesh, axis, (res, ims), tail)
        audio = []
        for s in range(mesh.size):
            st = (state if first[s] else
                  _M.fused_state_from_raw_tail(cfg, recv_re[s], recv_im[s]))
            a, *_ = _BM.band_monitor_planar(
                res[s], ims[s], cfg.prototype, cfg.audio_taps,
                cfg.audio_dec, *st, num_channels=cfg.num_channels)
            audio.append(a.T)                   # [K, local frames]
        new_state = _M.fused_state_from_raw_tail(cfg, re[-tail:],
                                                 im[-tail:])
        return torch.cat(audio, dim=1), new_state

    return step
