"""Distributed FFT: decimation in frequency over the mesh, natural order.

Counterpart of :mod:`comms_tpu.parallel.dfft`.  One FFT of ``N = R * C``
points (``R = r * n``: n shards, r a local radix) is computed by all the
shards of a ring; shard s owns the contiguous natural-order chunk
``x[s*r*C : (s+1)*r*C]``, the framework's time sharding.  Four stages,
two all-to-alls, everything else local:

1. the cross-shard R-point DFT per local index j: shard s's rows u' of
   the [R, C] view contribute ``W_R^{p (s r + u')}``, one local [R, r] x
   [r, C] product per shard; an all-to-all routes p-group t to shard t,
   which sums the sources in shard order;
2. the twiddle ``W_N^{p j}``;
3. the local C-point FFT (``torch.fft.fft``, as the JAX package's
   ``jnp.fft.fft`` outside any Pallas kernel): shard t holds X[p + R m];
4. the natural-order restore: a second all-to-all and a local transpose
   give shard s the bins ``X[s r C : (s+1) r C]``.  Requires ``n | C``,
   hence ``n^2 | N`` (the JAX module's docstring proves it); otherwise
   ``natural_order=False`` gives the R-interleaved spectrum.

The phase factors come from the exact integer residues ``(p (s r + u))
mod R`` and ``(p j) mod N``; the angles are formed in float64 and then
cast, so the precision does not degrade with N.  They are built once per
shard and dtype, at the first call.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.parallel import sharding as sh

__all__ = ["make_dfft", "pick_local_radix", "dfft_reference"]


def pick_local_radix(fft_size: int, n_dev: int,
                     max_local_fft: int | None = None) -> int:
    """Smallest local radix r >= 1 such that N = (r*n) * C with n | C
    (the natural-order condition) and, if given, C <= max_local_fft.
    Raises if none exists."""
    N, n = int(fft_size), int(n_dev)
    r = 1
    while r * n * n <= N:
        C = N // (r * n)
        if N % (r * n) == 0 and C % n == 0 and (
                max_local_fft is None or C <= max_local_fft):
            return r
        r += 1
    raise ValueError(
        f"no factorization N={N} = (r*{n})*C with {n} | C"
        + (f" and C <= {max_local_fft}" if max_local_fft else "")
        + " exists; pass natural_order=False for the interleaved spectrum")


def _phases(idx: np.ndarray, period: int, dtype, device) -> torch.Tensor:
    """exp(-2j pi idx / period) from exact integer residues, the angle
    formed in float64 and cast to ``dtype``."""
    ang = (-2.0 * np.pi / period) * np.mod(idx, period).astype(np.float64)
    return torch.from_numpy(np.exp(1j * ang)).to(device=device, dtype=dtype)


def make_dfft(fft_size: int, mesh: sh.Mesh, axis: str = "time",
              natural_order: bool = True, local_radix: int | None = None):
    """Build a distributed FFT over the ring(s) along ``axis``.

    ``dfft(x)``: global complex ``[..., fft_size]`` in, the spectrum out,
    natural order by default.  ``dfft.local_fn(xs)`` is the staged form
    for inlining into a larger sharded step (the sharded PSD): the list of
    per-shard chunks ``[..., r*C]`` in, the list of per-shard spectra out.
    ``dfft.R`` / ``dfft.C`` / ``dfft.r`` expose the factorization.  The
    phase factors are made in the input's complex dtype, once per dtype
    and shard.  Across processes the all-to-alls' crossing blocks go
    through the ring kernel into the other processes' windows on CUDA
    (gloo on the CPU; ``sharding.all_to_all``) and ``dfft(x)`` returns
    this process's shards of the spectrum (``sharding.Sharded``)."""
    n_dev = mesh.axis_size(axis)
    N = int(fft_size)
    if local_radix is not None:
        r = int(local_radix)
    elif natural_order and n_dev > 1:
        r = pick_local_radix(N, n_dev)
    else:
        r = 1
    R = r * n_dev
    if N % R:
        raise ValueError(f"fft_size {N} must divide by R = r*n = {R}")
    C = N // R
    if natural_order and C % n_dev:
        raise ValueError(
            f"natural order needs n | C (n={n_dev}, C={C}); "
            "pass natural_order=False for the interleaved spectrum")
    if N >= (1 << 31):
        raise ValueError("fft_size must be < 2^31 for exact integer twiddles")
    if R * R >= (1 << 31):
        raise ValueError(f"R = {R} too large for exact stage-1 phases")

    pos = mesh.local_axis_index(axis)
    p = np.arange(R, dtype=np.int64)[:, None]
    u = np.arange(r, dtype=np.int64)[None, :]
    pl = np.arange(r, dtype=np.int64)[:, None]
    j = np.arange(C, dtype=np.int64)[None, :]
    tables = {}

    def phases_for(dtype):
        if dtype not in tables:
            tables[dtype] = [
                (_phases(p * (q * r + u), R, dtype, mesh.devices[s]),
                 _phases((q * r + pl) * j, N, dtype, mesh.devices[s]))
                for q, s in zip(pos, mesh.local)]
        return tables[dtype]

    def local_fn(xs):
        if R == 1:
            return [torch.fft.fft(x) for x in xs]
        lead = tuple(xs[0].shape[:-1])
        nlead = len(lead)
        cdtype = xs[0].dtype if xs[0].is_complex() else torch.complex64
        tab = phases_for(cdtype)
        # -- stage 1: R-point DFT across the [R, C] row view.
        contrib = []
        for s, x in enumerate(xs):
            xm = torch.movedim(x.reshape(lead + (r, C)), -2, 0)  # [u, .., j]
            contrib.append(torch.tensordot(tab[s][0], xm.to(cdtype), dims=1))
        recv = sh.all_to_all(contrib, mesh, axis, 0, 0)
        seqs = []
        for s, rv in enumerate(recv):
            # rows [t*r:(t+1)*r) came from source shard t: sum the
            # sources in shard order.
            blocks = rv.reshape((n_dev, r) + tuple(rv.shape[1:]))
            g = blocks[0]
            for b in range(1, n_dev):
                g = g + blocks[b]
            # -- stage 2: twiddle; global p = pos*r + pl on this shard.
            z = g * tab[s][1].reshape((r,) + (1,) * nlead + (C,))
            # -- stage 3: local C-point FFT -> X[p + R*m], p local.
            seqs.append(torch.fft.fft(z))                # [pl, ..., m]
        if not natural_order:
            # interleaved layout: [..., pl*C + m] holds X[(s*r+pl) + R*m].
            return [torch.movedim(q, 0, -2).reshape(lead + (r * C,))
                    for q in seqs]
        # -- stage 4: m-group t belongs to destination shard t.
        sends = [torch.movedim(q.reshape((r,) + lead + (n_dev, C // n_dev)),
                               -2, 0) for q in seqs]   # [dest, pl, .., m']
        recv = sh.all_to_all(sends, mesh, axis, 0, 0)  # [t, pl, ..., m']
        # out flat index = R*m' + t*r + pl -> order [..., m', t, pl].
        return [torch.movedim(q, (0, 1), (-2, -1)).reshape(lead + (r * C,))
                for q in recv]

    def dfft(x):
        spec = (None,) * (x.ndim - 1) + (axis,)
        return sh.unshard(local_fn(sh.shard(x, mesh, spec)), mesh, spec)

    dfft.R, dfft.C, dfft.r = R, C, r
    dfft.natural_order = natural_order
    dfft.local_fn = local_fn
    return dfft


def dfft_reference(x):
    """numpy oracle."""
    return np.fft.fft(np.asarray(x), axis=-1)
