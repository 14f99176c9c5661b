"""Sharded wideband chain: time-block sharded FIR + FM demod + FIR with
overlap-save halo exchange, and the sharded Welch PSDs.

Counterpart of :mod:`comms_tpu.parallel.wideband` (BASELINE config 5)
on the port's mesh (:mod:`comms_tpu_torch.parallel.sharding`), in one
process or across processes (``parallel.multihost``):

    f32 IQ pairs [N, 2], N sharded over the ring
      -> FIR LPF        (halo T-1: the ring kernel)
      -> decimate /D1   (local; shard length % D1 == 0)
      -> FM demod       (halo 1)
      -> FIR audio LPF  (halo T-1)
      -> decimate /D2
      plus the frequency-offset estimate (yprev halo + psum)

Four ring exchanges per step (IQ halo, ``yprev``, FM prev, audio halo),
each one launch of the ring kernel on CUDA shards.  The steps take and
return global tensors in one process, so a sharded step is a drop-in
``block_fn`` for ``runtime.stream.StreamRunner``; across processes the
chain takes ``multihost.host_feed``'s value and returns this process's
audio shards (``sharding.Sharded``), the estimate and the state on every
process; the PSD makers take it too (the segment-sharded PSD comes back
whole on every process, the frequency-sharded ones as this process's
bins).

The PSD makers: :func:`make_sharded_psd` (the frequency axis sharded,
the distributed FFT of :mod:`.dfft` inlined), :func:`make_sharded_psd_
segments` (the segment axis sharded, each shard's Welch numerator
through the four-step kernel K10, ``kernels.fft_big.welch_numerator``)
and :func:`make_sharded_psd_planar` (planes; the 3-D serving shape).
``use_kernel=None`` picks K10 for CUDA shards where the JAX package picks
its Pallas kernel on a TPU (a one-shard mesh for the frequency-sharded
makers; any mesh for the segment-sharded one) and the plain route on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import fft_big as _FB
from comms_tpu_torch.ops import demodulation, fir
from comms_tpu_torch.ops import spectrum
from comms_tpu_torch.parallel import dfft as dfft_mod
from comms_tpu_torch.parallel import sharding as sh

__all__ = ["WidebandConfig", "make_sharded_step", "make_sharded_psd",
           "make_sharded_psd_segments", "make_sharded_psd_planar",
           "init_state", "state_from_jax"]


class WidebandConfig:
    """The chain's taps and sizes.  The taps are real, so the complex IQ
    runs through the IQ FIR as two real products (the JAX package makes
    its band matrix complex with zero imaginary part; the outputs agree
    to rounding)."""

    def __init__(self, taps_lpf, block: int = 1 << 20, dec1: int = 5,
                 dec2: int = 5):
        t = np.asarray(taps_lpf)
        self.num_taps = len(t)
        self.B_iq = fir.banded_tap_matrix(t.astype(np.float32))
        self.B_audio = fir.banded_tap_matrix(t.astype(np.float32))
        self.block = int(block)
        self.dec1 = int(dec1)
        self.dec2 = int(dec2)


def init_state(cfg: WidebandConfig, device="cuda"):
    """(IQ FIR tail [T-1, 2] pairs, FM prev [2], audio FIR tail [T-1]),
    float32 zeros."""
    T = cfg.num_taps
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((T - 1, 2), **f32), torch.zeros((2,), **f32),
            torch.zeros((T - 1,), **f32))


def state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state`-shaped state (numpy arrays)
    as this package's state on ``device``."""
    return tuple(torch.tensor(np.asarray(s, np.float32), device=device)
                 for s in state)


def make_sharded_step(cfg: WidebandConfig, mesh: sh.Mesh,
                      axis: str = "time", rdma_halo: bool = False):
    """``(state, iq_pairs[N, 2]) -> ((audio[M], freq_est[]), new_state)``
    over the ring along ``axis``, global tensors in and out.

    ``rdma_halo`` is kept so that callers of the JAX signature work: the
    JAX package routes its halos through an XLA ``ppermute`` (False) or a
    Pallas RDMA ring (True), one contract with bit-equal results.  Both
    values take the same ring kernel."""
    del rdma_halo
    n = mesh.axis_size(axis)
    if cfg.block % n:
        raise ValueError("block must divide evenly over shards")
    local = cfg.block // n
    if local % cfg.dec1 or (local // cfg.dec1) % cfg.dec2:
        raise ValueError("per-shard length must divide by dec1 and dec2")
    T = cfg.num_taps
    first = [i == 0 for i in mesh.local_axis_index(axis)]

    def hx(xs, ctx, halo):
        return sh.halo_exchange(xs, ctx, halo, mesh, axis)

    def step(state, iq_pairs):
        ctx_pairs, prev_pair, actx = state
        pairs = sh.shard(iq_pairs, mesh, (axis, None))
        xs = [torch.complex(p[:, 0], p[:, 1]) for p in pairs]

        # --- FIR LPF with ring halo (overlap-save).
        ctx = torch.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        halos = hx(xs, ctx, T - 1)
        ys = [fir.fir_block(x, cfg.B_iq, h)[0] for x, h in zip(xs, halos)]
        new_ctx = sh.collect_ctx(xs, T - 1, mesh, axis)[0]

        # --- frequency estimate on the filtered signal: lag-1 sums, the
        # cross-shard term from the left neighbour's last y sample.
        yprev = hx(ys, torch.zeros(1, dtype=ys[0].dtype,
                                   device=ys[0].device), 1)
        parts = []
        for y, yp, f in zip(ys, yprev, first):
            lag = torch.sum(y[1:] * torch.conj(y[:-1]))
            parts.append(lag if f else lag + y[0] * torch.conj(yp[0]))
        fsum = sh.psum_estimate(parts, mesh, axis)[0]
        freq = torch.atan2(fsum.imag, fsum.real)

        # --- decimate (local; shard length % dec keeps the stride).
        ys = [y[:: cfg.dec1] for y in ys]

        # --- FM demod with a 1-sample halo.
        prev_g = torch.complex(prev_pair[0], prev_pair[1])
        hps = hx(ys, prev_g[None], 1)
        ds = [demodulation.fast_angle(
            y * torch.conj(torch.cat([hp, y[:-1]]))).to(torch.float32)
            for y, hp in zip(ys, hps)]
        new_prev_c = sh.collect_ctx(ys, 1, mesh, axis)[0]

        # --- audio FIR + decimate.
        ahs = hx(ds, actx, T - 1)
        audio = [fir.fir_block(d, cfg.B_audio, ah)[0][:: cfg.dec2]
                 for d, ah in zip(ds, ahs)]
        new_actx = sh.collect_ctx(ds, T - 1, mesh, axis)[0]

        new_state = (
            torch.stack([new_ctx.real, new_ctx.imag], dim=-1),
            torch.stack([new_prev_c[0].real, new_prev_c[0].imag]),
            new_actx,
        )
        return (sh.unshard(audio, mesh, (axis,)), freq), new_state

    return step


def _welch_window(fft_size: int, window):
    """Shared window/scale preamble of the three PSD makers."""
    w = np.asarray(window if window is not None
                   else spectrum.hann(fft_size), np.float64)
    if w.shape[0] != fft_size:
        raise ValueError("window length must equal fft_size")
    return w.astype(np.float32), 1.0 / float(np.sum(w ** 2))


def _on_cuda(mesh: sh.Mesh) -> bool:
    return mesh.devices[mesh.local[0]].type == "cuda"


def _freq_sharded_psd(fft_size, mesh, axis, w32, scale, local_radix):
    """The dfft route of the frequency-sharded makers: per-shard complex
    chunks [B, F/n] in, the PSD [F] out."""
    d = dfft_mod.make_dfft(fft_size, mesh, axis, local_radix=local_radix)
    n = mesh.axis_size(axis)
    local_f = fft_size // n
    wl = [torch.from_numpy(w32[q * local_f:(q + 1) * local_f])
          .to(mesh.devices[s])
          for q, s in zip(mesh.local_axis_index(axis), mesh.local)]

    def psd(xs):
        # per-segment mean removal needs the cross-shard mean (psum).
        sums = sh.psum([x.sum(dim=1, keepdim=True) for x in xs], mesh, axis)
        ys = [(x - m / fft_size) * w[None, :] for x, m, w in zip(xs, sums, wl)]
        specs = d.local_fn(ys)
        return sh.unshard([torch.mean(s.abs() ** 2, dim=0) * scale
                           for s in specs], mesh, (axis,))

    return psd


def make_sharded_psd(fft_size: int, mesh: sh.Mesh, axis: str = "time",
                     window=None, local_radix=None, use_kernel=None):
    """Wideband Welch PSD on a sharded stream: segments of ``fft_size``
    samples span all shards (the frequency axis is sharded) and the FFT is
    the distributed transform of :mod:`.dfft`.  Returns ``(pairs[B,
    fft_size, 2]) -> psd[fft_size]``: B non-overlapping segments averaged,
    periodic Hann by default, the normalisation of
    ``ops.spectrum.welch_psd`` (fs = 1, density).

    ``use_kernel``: on a one-shard mesh with a two-factor ``fft_size``,
    the whole Welch numerator through K10 (``fft_big.welch_numerator``).
    None picks it for a CUDA mesh; the multi-shard path is the dfft."""
    n = mesh.axis_size(axis)
    w32, scale = _welch_window(fft_size, window)
    if use_kernel is None:
        use_kernel = (n == 1 and _FB.supported_big(fft_size)
                      and _on_cuda(mesh))
    if use_kernel:
        if n != 1:
            raise ValueError("use_kernel PSD path needs a 1-shard mesh "
                             "(the multi-shard path is the dfft)")

        def fast(pairs):                         # [B, F, 2]
            acc = _FB.welch_numerator(pairs[..., 0], pairs[..., 1], w32)
            return acc * (scale / pairs.shape[0])

        return fast

    psd = _freq_sharded_psd(fft_size, mesh, axis, w32, scale, local_radix)

    def entry(pairs):
        xs = [torch.complex(p[..., 0], p[..., 1])
              for p in sh.shard(pairs, mesh, (None, axis, None))]
        return psd(xs)

    return entry


def make_sharded_psd_segments(fft_size: int, mesh: sh.Mesh,
                              axis: str = "time", window=None,
                              use_kernel=None):
    """Segment-parallel Welch PSD: the segment axis is sharded (each
    spectrum fits one shard), every shard accumulates the Welch numerator
    of its segments (through K10 with ``use_kernel``), and one psum of the
    [F] accumulators, in shard order, combines them.  Returns
    ``(pairs[B, fft_size, 2]) -> psd[fft_size]``, B % shards == 0.
    Window, demean and density as :func:`make_sharded_psd`.
    ``use_kernel=None`` picks K10 for a CUDA mesh and a two-factor
    ``fft_size``."""
    w32, scale = _welch_window(fft_size, window)
    if use_kernel is None:
        use_kernel = _FB.supported_big(fft_size) and _on_cuda(mesh)
    if use_kernel and not _FB.supported_big(fft_size):
        raise ValueError(f"fft_size {fft_size} has no two-factor "
                         "decomposition into 256..2048-point stages")
    wt = {}

    def numerator(p):
        re, im = p[..., 0], p[..., 1]
        if use_kernel:
            return _FB.welch_numerator(re, im, w32)
        if p.device not in wt:
            wt[p.device] = torch.from_numpy(w32).to(p.device)
        x = torch.complex(re, im)
        x = x - torch.mean(x, dim=1, keepdim=True)
        spec = torch.fft.fft(x * wt[p.device][None, :], dim=1)
        return torch.sum(spec.abs() ** 2, dim=0)

    def entry(pairs):
        parts = [numerator(p) for p in sh.shard(pairs, mesh,
                                                 (axis, None, None))]
        acc = sh.psum(parts, mesh, axis)[0]
        return acc * np.float32(scale / pairs.shape[0])

    return entry


def make_sharded_psd_planar(fft_size: int, mesh: sh.Mesh,
                            axis: str = "time", window=None,
                            local_radix=None, use_kernel=None):
    """Plane-native variant of :func:`make_sharded_psd`: ``(re[B,
    fft_size], im[B, fft_size]) -> psd[fft_size]``, also taking the
    pre-factorised ``[B, n1, n2]`` serving shape.  Window, demean and
    normalisation as :func:`make_sharded_psd`; ``use_kernel`` as there."""
    n = mesh.axis_size(axis)
    w32, scale = _welch_window(fft_size, window)
    if use_kernel is None:
        use_kernel = (n == 1 and _FB.supported_big(fft_size)
                      and _on_cuda(mesh))
    if use_kernel:
        if n != 1:
            raise ValueError("use_kernel PSD path needs a 1-shard mesh")

        def fast(re, im):
            # [B, F] planes, or the pre-factorised [B, n1, n2] segments
            acc = _FB.welch_numerator(re, im, w32)
            return acc * (scale / re.shape[0])

        return fast

    psd = _freq_sharded_psd(fft_size, mesh, axis, w32, scale, local_radix)

    def entry(re, im):
        if re.ndim == 3:     # pre-factorised serving shape
            re = re.reshape(re.shape[0], -1)
            im = im.reshape(im.shape[0], -1)
        spec = (None, axis)
        xs = [torch.complex(r, i) for r, i in
              zip(sh.shard(re, mesh, spec), sh.shard(im, mesh, spec))]
        return psd(xs)

    return entry
