"""The BlockOp protocol: a node of the reference's graph as a pure block
transform.

Counterpart of :mod:`comms_tpu.runtime.block`.  Each op is

    apply(state, x) -> (y, new_state)

over a fixed-size block, with the per-sample carried state (FIR tail,
mixer phase, FM ``prev``, LFSR register, PRNG key) held explicitly.  The
ops have the JAX ops' fields and behaviour: ``rate`` (a Fraction),
``halo`` (carried input samples), ``out_len``, ``init_state``,
``out_dtype``, ``apply`` and the sharding hooks.  ``init_state`` takes
the stream dtype and a ``device`` (default "cuda").  The states have the
JAX states' structure and meaning, leaf for leaf, so checkpoints carry
across (:mod:`comms_tpu_torch.runtime.checkpoint`).

**The FIR ops and the kernels.**  :class:`Fir` and :class:`FirDecimate`
run a block through a CUDA kernel of the port whenever the kernel's
contract holds, and through the JAX op's GEMM (``ops/fir.fir_block``,
``fir_decimate_poly``) otherwise.  The rule reads only shapes and
dtypes, so it picks the same route on any device; on CPU tensors the
kernel's wrapper runs its plain version.  A block takes the kernel when

* the stream is complex64 or float32 and the GEMM's output would be too
  (real taps of any float type on a complex64 stream; float32 or
  complex64 taps on a float32 stream);
* 2 <= T and T <= the entry's tap limit: ``decim_fir.max_taps(dec)``
  for dec > 1 (K2's ``fir_decimate_planar``), ``fir.MAX_TAPS`` for
  dec <= 1 (K2's kernel at D = 1, K4's ``fir_planar``);
* the block is a multiple of the entry's quantum, 8 * 128 * max(dec, 1)
  samples (eight rows of the kernel's tile, :func:`kernel_quantum`).

A real stream goes to the kernel as its real plane beside a zero
imaginary plane; complex taps whose imaginary parts are all zero go as
real taps.  No error of a kernel changes the route.

**Sharding.**  ``shard_apply(state, xs, mesh, axis)`` runs an op over a
time-sharded block: ``xs`` is the list of per-shard tensors of
:mod:`comms_tpu_torch.parallel.sharding` (``None`` for a source), and it
returns the per-shard outputs and the new (unsharded) stream state.  Ops
with a halo follow the overlap-save protocol: one ring exchange
(:func:`~comms_tpu_torch.parallel.sharding.halo_exchange`, the K12 kernel
on the card) gives each shard its left neighbour's tail, and the last
shard's tail is the next state.  ``Mixer``, ``Nco``, ``Decimate`` and the
sources override it as the JAX ops do.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Callable

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import decim_fir as _DF
from comms_tpu_torch.kernels import fir as _FP
from comms_tpu_torch.ops import demodulation as _demod
from comms_tpu_torch.ops import fft as _fft
from comms_tpu_torch.ops import fir as _fir
from comms_tpu_torch.ops import mixer as _mixer
from comms_tpu_torch.ops import modulation as _mod
from comms_tpu_torch.ops import prns as _prns
from comms_tpu_torch.ops import pulse as _pulse
from comms_tpu_torch.ops import random as _random
from comms_tpu_torch.ops import resample as _resample
from comms_tpu_torch.parallel import sharding as _sh

__all__ = [
    "BlockOp",
    "Lambda",
    "Fir",
    "FirDecimate",
    "Mixer",
    "Nco",
    "FmDemod",
    "Decimate",
    "Upsample",
    "RationalResample",
    "PulseShape",
    "Fft",
    "Ifft",
    "BpskMod",
    "QpskMod",
    "PrnSource",
    "UniformSource",
    "NormalSource",
    "RandomBitSource",
    "kernel_quantum",
    "takes_kernel",
]

_TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class BlockOp:
    """Base class: stateless passthrough with unit rate.

    ``halo``: number of carried *input* samples the op needs from the
    previous block (drives the halo exchange when time-sharded)."""

    @property
    def rate(self) -> Fraction:
        return Fraction(1, 1)

    @property
    def halo(self) -> int:
        return 0

    def out_len(self, n: int) -> int:
        """Output block length for input length ``n`` (the rational rate;
        ops with another length rule override)."""
        out = Fraction(n) * self.rate
        if out.denominator != 1:
            raise ValueError(f"block size {n} is not integral through "
                             f"{self} (rate {self.rate})")
        return int(out)

    def init_state(self, dtype=torch.complex64, device="cuda") -> Any:
        return ()

    def out_dtype(self, in_dtype):
        """Stream dtype after this op (drives the state dtypes of the ops
        after it)."""
        return in_dtype

    def apply(self, state, x):
        return x, state

    # ------------------------------------------------- sharding hooks
    def state_to_halo(self, state):
        """Carried state -> the [halo] input tail (the identity for ops
        whose state is the tail)."""
        return state

    def halo_to_state(self, halo_arr):
        """[halo] input tail -> the state apply() expects."""
        return halo_arr

    def shard_apply(self, state, xs, mesh, axis="time"):
        """Run the op over per-shard blocks ``xs`` (module docstring).
        Returns ``(ys, new_state)``: stateless ops run each shard
        alone; ops with a halo take their left neighbour's tail."""
        h = self.halo
        if h == 0:
            outs = [self.apply(state, x) for x in xs]
            return [y for y, _ in outs], outs[0][1]
        halos = _sh.halo_exchange(xs, self.state_to_halo(state), h, mesh,
                                  axis)
        ys = [self.apply(self.halo_to_state(hx), x)[0]
              for hx, x in zip(halos, xs)]
        tail = _sh.collect_ctx(xs, h, mesh, axis)[0]
        return ys, self.halo_to_state(tail)


@dataclasses.dataclass(frozen=True)
class Lambda(BlockOp):
    """Any stateless elementwise or shape-preserving function (the
    reference examples' ConvertNode pattern)."""

    fn: Callable
    out_per_in: Fraction = Fraction(1, 1)
    result_dtype: Any = None  # set when fn changes the stream dtype

    @property
    def rate(self) -> Fraction:
        return Fraction(self.out_per_in)

    def out_dtype(self, in_dtype):
        return (self.result_dtype if self.result_dtype is not None
                else in_dtype)

    def apply(self, state, x):
        return self.fn(x), state


# ------------------------------------------------------- the FIR route

_KERNEL_DTYPES = (torch.complex64, torch.float32)
_QUANTUM_ROWS = 8 * 128


def _taps_dtype(taps: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, taps.dtype)).dtype


def _gemm_out_dtype(x_dtype, taps: np.ndarray) -> torch.dtype:
    """The dtype ``ops/fir`` gives a stream of ``x_dtype`` through
    ``taps`` (real taps on a complex stream keep the stream's dtype)."""
    if x_dtype.is_complex and not np.iscomplexobj(taps):
        return x_dtype
    return torch.promote_types(x_dtype, _taps_dtype(taps))


def kernel_quantum(dec: int) -> int:
    """Block quantum of the FIR ops' kernel route at decimation ``dec``:
    eight rows of the kernel's ``128 * max(dec, 1)``-sample tile."""
    return _QUANTUM_ROWS * max(int(dec), 1)


def takes_kernel(x_dtype, n: int, taps, dec: int) -> bool:
    """Whether a block of ``n`` samples of ``x_dtype`` through ``taps`` at
    decimation ``dec`` takes the kernel route (module docstring)."""
    taps = np.asarray(taps)
    T = taps.shape[0]
    limit = _DF.max_taps(dec) if dec > 1 else _FP.MAX_TAPS
    return (x_dtype in _KERNEL_DTYPES
            and _gemm_out_dtype(x_dtype, taps) in _KERNEL_DTYPES
            and 2 <= T <= limit
            and n > 0 and n % kernel_quantum(dec) == 0)


def _kernel_taps(taps: np.ndarray, x_dtype) -> np.ndarray:
    """Complex taps with zero imaginary parts as real taps, on a complex
    stream (the real-tap path of the kernel and of the GEMM)."""
    if (np.iscomplexobj(taps) and x_dtype.is_complex
            and not np.any(taps.imag)):
        return taps.real.copy()
    return taps


def _fir_apply(op, state, x, dec: int):
    """A FIR op's block: the kernel route where ``takes_kernel`` says so,
    else the JAX op's GEMM with the op's band matrix for ``x``'s device,
    resolved once (real taps where the complex ones have zero imaginary
    parts and the stream is complex, as the kernel takes them)."""
    taps = _kernel_taps(op._taps_np, x.dtype)
    if takes_kernel(x.dtype, x.shape[0], taps, dec):
        if dec <= 1:
            return _FP.fir_block(x, taps, state, tile_rows=8)
        return _DF.fir_decimate_block(x, taps, dec, state)
    key = (str(x.device), taps.dtype.str)
    hit = op._dev.get(key)
    if hit is None:
        if dec > 1:
            C = _fir.decimating_branch_taps(taps, dec)
            hit = (C, _fir.decimating_band(C, x.device))
        else:
            hit = (None, torch.from_numpy(
                _fir.banded_tap_matrix(taps)).to(x.device))
        op._dev[key] = hit
    C, band = hit
    if dec <= 1:
        return _fir.fir_block(x, band, state)
    return _fir.fir_decimate_poly(x, C, state, band=band)


@dataclasses.dataclass(frozen=True)
class Fir(BlockOp):
    """Streaming FIR (the reference's FirNode/BatchFirNode)."""

    taps: tuple  # hashable; the tap values
    _taps_np: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    @staticmethod
    def make(taps) -> "Fir":
        taps = np.asarray(taps)
        return Fir(tuple(taps.tolist()), taps)

    def __post_init__(self):
        if self._taps_np is None:
            object.__setattr__(self, "_taps_np", np.asarray(self.taps))

    @property
    def num_taps(self) -> int:
        return len(self.taps)

    @property
    def halo(self) -> int:
        return self.num_taps - 1

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _fir.init_ctx(self.num_taps, dtype=dtype, device=device)

    def apply(self, state, x):
        return _fir_apply(self, state, x, 1)


@dataclasses.dataclass(frozen=True)
class FirDecimate(BlockOp):
    """Fused FIR + decimate (the fm_radio hot pair) computing only the
    kept outputs.  Carried context: M*dec - 1 input samples (M =
    ceil(T/dec)); dec <= 1 is a full-rate FIR with T-1."""

    taps: tuple
    dec: int
    _taps_np: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    @staticmethod
    def make(taps, dec: int) -> "FirDecimate":
        taps = np.asarray(taps)
        return FirDecimate(tuple(taps.tolist()), int(dec), taps)

    def __post_init__(self):
        if self._taps_np is None:
            object.__setattr__(self, "_taps_np", np.asarray(self.taps))

    @property
    def rate(self) -> Fraction:
        return Fraction(1, max(self.dec, 1))

    @property
    def halo(self) -> int:
        T = len(self.taps)
        if self.dec <= 1:
            return T - 1
        return self.dec * -(-T // self.dec) - 1

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return torch.zeros((self.halo,), dtype=dtype, device=device)

    def apply(self, state, x):
        return _fir_apply(self, state, x, self.dec)


# ------------------------------------------------------------- mixers

def _mix_cdtype(in_dtype) -> torch.dtype:
    """Ramp dtype matching the mixer's output promotion rule."""
    return torch.promote_types(in_dtype, torch.complex64)


_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


@dataclasses.dataclass(frozen=True)
class Mixer(BlockOp):
    """Closed-form complex mixer (the reference's MixerNode).  The unit
    ramp of a block length is computed on the host in float64 and kept
    on each device once.  The state is the 64-bit fixed-point phase as
    host integers (hi, lo)."""

    dphase: float
    phase0: float = 0.0
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _mixer.phase_fix_init(self.phase0)

    def out_dtype(self, in_dtype):
        return _mix_cdtype(in_dtype)

    def _ramp(self, n: int, cdtype, device):
        key = (n, cdtype, str(device))
        hit = self._dev.get(key)
        if hit is None:
            ramp, _ = _mixer.mixer_ramp(n, self.dphase,
                                        dtype=_NP_COMPLEX[cdtype])
            hit = (torch.from_numpy(ramp).to(device),
                   _mixer.advance_fix(n, self.dphase))
            self._dev[key] = hit
        return hit

    def apply(self, state, x):
        cd = _mix_cdtype(x.dtype)
        ramp, adv = self._ramp(int(x.shape[0]), cd, x.device)
        return _mixer.mixer_block_fix(x.to(cd), state, ramp, adv)

    def shard_apply(self, state, xs, mesh, axis="time"):
        # Shard s starts s * local_n samples into the block: its
        # fixed-point phase is the carried one advanced s times; the
        # stream advances n_shards times.
        idx = mesh.axis_index(axis)
        n = mesh.axis_size(axis)
        ys = []
        for s, x in enumerate(xs):
            cd = _mix_cdtype(x.dtype)
            ramp, adv = self._ramp(int(x.shape[0]), cd, x.device)
            p = state
            for _ in range(idx[s]):
                p = _mixer.add_fix(p, adv)
            ys.append(_mixer.mixer_block_fix(x.to(cd), p, ramp, adv)[0])
        p = state
        for _ in range(n):
            p = _mixer.add_fix(p, adv)
        return ys, p


@dataclasses.dataclass(frozen=True)
class Nco(BlockOp):
    """NCO over a block of phase errors (the reference's NcoNode)."""

    dphase: float
    phase0: float = 0.0

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return torch.full((), float(np.float32(self.phase0)),
                          dtype=torch.float32, device=device)

    def out_dtype(self, in_dtype):
        return _mix_cdtype(in_dtype)

    def apply(self, state, perr):
        return _mixer.nco_block(perr, state, self.dphase)

    def shard_apply(self, state, perrs, mesh, axis="time"):
        # The phase is the running sum of dphase steps plus every earlier
        # phase error, a prefix across shards: shard s starts at the
        # carried phase + s * (local_n * dphase mod 2pi) (host float64)
        # + the earlier shards' error totals (an all-gather of one scalar
        # a shard, masked and summed).
        local_n = int(perrs[0].shape[0])
        adv = float(np.mod(np.float64(local_n)
                           * np.float64(_mixer.normalize_dphase(self.dphase)),
                           _TWO_PI))
        idx = mesh.axis_index(axis)
        n = mesh.axis_size(axis)
        totals = [torch.sum(p) for p in perrs]
        all_t = torch.stack([t.to(perrs[0].device) for t in totals])
        two_pi = np.float32(_TWO_PI)
        ar = torch.arange(n, device=all_t.device)
        ys = []
        for s, p in enumerate(perrs):
            prefix = torch.sum(torch.where(ar < idx[s], all_t,
                                           torch.zeros_like(all_t)))
            off = np.float32(np.mod(np.float32(idx[s]) * np.float32(adv),
                                    two_pi))
            phase_s = torch.remainder(state + off + prefix, two_pi)
            ys.append(_mixer.nco_block(p, phase_s, self.dphase)[0])
        step = np.float32(np.mod(n * np.float64(adv), _TWO_PI))
        new = torch.remainder(state + step + torch.sum(all_t), two_pi)
        return ys, new.to(state.dtype)


@dataclasses.dataclass(frozen=True)
class FmDemod(BlockOp):
    """Quadrature FM demod (the reference's FMDemodNode), complex in, real
    out.  ``fast`` selects the polynomial atan2; default exact."""

    fast: bool = False

    @property
    def halo(self) -> int:
        return 1

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _demod.fm_demod_init(dtype=dtype, device=device)

    def apply(self, state, x):
        return _demod.fm_demod_block(x, state, fast=self.fast)

    def state_to_halo(self, state):
        return state[None]

    def halo_to_state(self, halo_arr):
        return halo_arr[0]

    def out_dtype(self, in_dtype):
        return torch.empty((), dtype=in_dtype).real.dtype


@dataclasses.dataclass(frozen=True)
class Decimate(BlockOp):
    """Keep every dec-th sample.  ``streaming=False`` resets the stride
    each block (the reference's DecimateNode); ``streaming=True`` carries
    the phase."""

    dec: int
    streaming: bool = False

    @property
    def rate(self) -> Fraction:
        return Fraction(1, max(self.dec, 1))

    def out_len(self, n: int) -> int:
        if self.dec in (0, 1):
            return n
        if self.streaming:
            if n % self.dec:
                raise ValueError(f"streaming decimation needs n % dec == 0, "
                                 f"got {n} % {self.dec}")
            return n // self.dec
        return -(-n // self.dec)     # per-block reset keeps ceil(n/dec)

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return (_resample.decimate_stream_init(device) if self.streaming
                else ())

    def apply(self, state, x):
        if self.streaming:
            return _resample.decimate_stream(x, state, self.dec)
        return _resample.decimate_block(x, self.dec), state

    def shard_apply(self, state, xs, mesh, axis="time"):
        # A per-shard stride reset equals the one-device per-block reset
        # only when each shard's length divides by dec.
        for x in xs:
            if self.dec > 1 and x.shape[0] % self.dec:
                raise ValueError(
                    f"Decimate(dec={self.dec}) under time-sharding needs "
                    f"per-shard length % dec == 0, got {x.shape[0]}")
        outs = [self.apply(state, x) for x in xs]
        return [y for y, _ in outs], outs[0][1]


@dataclasses.dataclass(frozen=True)
class Upsample(BlockOp):
    """Zero-stuff (the reference's UpsampleNode)."""

    ups: int

    @property
    def rate(self) -> Fraction:
        return Fraction(max(self.ups, 1), 1)

    def apply(self, state, x):
        return _resample.upsample_block(x, self.ups), state


@dataclasses.dataclass(frozen=True)
class RationalResample(BlockOp):
    """Polyphase P/Q rational resampler.  The state is the carried input
    tail, so the overlap-save sharding protocol applies."""

    taps: tuple
    up: int
    down: int
    _mats: Any = dataclasses.field(default=None, repr=False, compare=False)
    _offsets: Any = dataclasses.field(default=None, repr=False,
                                      compare=False)
    _P: int = dataclasses.field(default=0, repr=False, compare=False)

    @staticmethod
    def make(taps, up: int, down: int) -> "RationalResample":
        return RationalResample(tuple(np.asarray(taps).tolist()),
                                int(up), int(down))

    def __post_init__(self):
        if self._mats is None:
            mats, offs, P = _resample.rational_taps(
                np.asarray(self.taps), self.up, self.down)
            object.__setattr__(self, "_mats", mats)
            object.__setattr__(self, "_offsets", offs)
            object.__setattr__(self, "_P", P)

    @property
    def rate(self) -> Fraction:
        return Fraction(self.up, self.down)

    @property
    def halo(self) -> int:
        return max(m.size - 1 for m in self._mats)

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _resample.rational_resample_init(self._mats, dtype=dtype,
                                                device=device)

    def apply(self, state, x):
        return _resample.rational_resample_block(
            x, self._mats, self._offsets, self._P, state)


@dataclasses.dataclass(frozen=True)
class PulseShape(BlockOp):
    """Polyphase pulse shaping (the reference's PulseNode): symbols in,
    sps samples per symbol out.  The phase matrix is kept on each
    device once."""

    taps: tuple
    sps: int
    _H: Any = dataclasses.field(default=None, repr=False, compare=False)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    @staticmethod
    def make(taps, sps: int) -> "PulseShape":
        taps = np.asarray(taps)
        return PulseShape(tuple(taps.tolist()), int(sps),
                          _pulse.polyphase_taps(taps, sps))

    def __post_init__(self):
        if self._H is None:
            object.__setattr__(
                self, "_H",
                _pulse.polyphase_taps(np.asarray(self.taps), self.sps))

    @property
    def rate(self) -> Fraction:
        return Fraction(self.sps, 1)

    @property
    def halo(self) -> int:
        # carried input-SYMBOL tail (overlap-save in the symbol domain)
        return max(-(-len(self.taps) // self.sps) - 1, 0)

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _pulse.pulse_init_ctx(len(self.taps), self.sps, dtype=dtype,
                                     device=device)

    def apply(self, state, x):
        dt = _pulse.shape_dtype(x.dtype, self._H)
        key = (dt, str(x.device))
        Hd = self._dev.get(key)
        if Hd is None:
            Hd = _pulse.flipped_taps(self._H, x.device, dt)
            self._dev[key] = Hd
        return _pulse.pulse_shape_block(x, self._H, state, taps_dev=Hd)


@dataclasses.dataclass(frozen=True)
class Fft(BlockOp):
    """Per-block FFT (the reference's FFTBatchNode)."""

    fft_size: int

    def out_dtype(self, in_dtype):
        return _mix_cdtype(in_dtype)

    def apply(self, state, x):
        return _fft.fft_block(x, self.fft_size), state


@dataclasses.dataclass(frozen=True)
class Ifft(BlockOp):
    """Per-block IFFT, rustfft-unnormalized by default."""

    fft_size: int
    normalize: bool = False

    def apply(self, state, x):
        return _fft.ifft_block(x, self.fft_size, self.normalize), state


@dataclasses.dataclass(frozen=True)
class BpskMod(BlockOp):
    """Bits -> BPSK symbols.  ``example_convention`` selects the examples'
    2b-1 map over digital.rs's 1-2b map."""

    example_convention: bool = False
    dtype: Any = torch.complex64

    def out_dtype(self, in_dtype):
        return self.dtype

    def apply(self, state, bits):
        fn = (_mod.bpsk_bit_mod_example if self.example_convention
              else _mod.bpsk_bit_mod)
        return fn(bits, dtype=self.dtype), state


@dataclasses.dataclass(frozen=True)
class QpskMod(BlockOp):
    """Bit pairs -> QPSK symbols (2 bits in per symbol out)."""

    example_convention: bool = False
    dtype: Any = torch.complex64

    @property
    def rate(self) -> Fraction:
        return Fraction(1, 2)

    def out_dtype(self, in_dtype):
        return self.dtype

    def apply(self, state, bits):
        if self.example_convention:
            return _mod.qpsk_bits_mod_example(bits, dtype=self.dtype), state
        pairs = bits.reshape(-1, 2).to(torch.int32)
        vals = pairs[:, 0] + 2 * pairs[:, 1]
        return _mod.qpsk_bit_mod(vals, dtype=self.dtype), state


# ------------------------------------------------------------- sources

@dataclasses.dataclass(frozen=True)
class _SourceOp(BlockOp):
    """Base for free-running sources.  Under time-sharding the block is
    drawn once (a pure function of the carried key) and each shard takes
    its chunk: bit-exact to the one-device sequence.  ``PrnSource``
    overrides with a distributed form."""

    def shard_apply(self, state, xs, mesh, axis="time"):
        y_full, new_state = self.apply(state, None)
        n = mesh.axis_size(axis)
        B = int(y_full.shape[0])
        if B % n:
            raise ValueError(f"{type(self).__name__} block {B} not "
                             f"divisible across {n} shards")
        local = B // n
        idx = mesh.axis_index(axis)
        return [y_full[i * local:(i + 1) * local] for i in idx], new_state


@dataclasses.dataclass(frozen=True)
class PrnSource(_SourceOp):
    """LFSR bit source (the reference's PrnsNode)."""

    spec: Any = dataclasses.field(compare=False)
    seed: int = 0x01

    @staticmethod
    def make(poly_mask: int, seed: int, width: int,
             block: int) -> "PrnSource":
        return PrnSource(_prns.PrnSpec.make(poly_mask, width, block), seed)

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return self.spec.init_state(self.seed, device=device)

    def apply(self, state, _x=None):
        return _prns.prn_block(self.spec, state)

    def shard_apply(self, state, xs, mesh, axis="time"):
        # Distributed exact form: shard s makes bits [s*local,
        # (s+1)*local) from the register A^(s*local) @ s0, 1/n of the
        # block's work; the concatenation is the one-device sequence.
        n = mesh.axis_size(axis)
        if n == 1:
            bits, new = self.apply(state)
            return [bits] * mesh.size, new
        spec = self.spec
        local = spec.block // n
        dev = state.device
        shift = _build.device_constant(_prns.shard_shift_matrices(spec, n),
                                       dev)
        M_local = _build.device_constant(spec.out_matrix[:local], dev)
        A_blk = _build.device_constant(spec.adv_matrix, dev)
        s = state.to(torch.float32)
        ys = []
        for i in mesh.axis_index(axis):
            s_shard = torch.remainder(shift[i] @ s, 2)
            ys.append(torch.remainder(M_local @ s_shard, 2).to(torch.int8))
        return ys, torch.remainder(A_blk @ s, 2).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class UniformSource(_SourceOp):
    """Uniform random source (the reference's UniformNode)."""

    block: int
    start: float = 0.0
    end: float = 1.0
    seed: int = 0
    dtype: Any = torch.float32

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _random.source_init(self.seed, device)

    def apply(self, state, _x=None):
        return _random.uniform_block(state, self.block, self.start,
                                     self.end, self.dtype)


@dataclasses.dataclass(frozen=True)
class NormalSource(_SourceOp):
    """Normal random source (the reference's NormalNode), float32 or
    float64."""

    block: int
    mu: float = 0.0
    std_dev: float = 1.0
    seed: int = 0
    dtype: Any = torch.float32

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _random.source_init(self.seed, device)

    def apply(self, state, _x=None):
        return _random.normal_block(state, self.block, self.mu,
                                    self.std_dev, self.dtype)


@dataclasses.dataclass(frozen=True)
class RandomBitSource(_SourceOp):
    """random_bit() source (the reference's rand_node.rs)."""

    block: int
    seed: int = 0

    def init_state(self, dtype=torch.complex64, device="cuda"):
        return _random.source_init(self.seed, device)

    def apply(self, state, _x=None):
        return _random.random_bits_block(state, self.block)
