"""FM broadcast receiver: the reference's flagship receive pipeline.

Counterpart of :mod:`comms_tpu.models.fm_receiver`
(``examples/fm_radio.rs:144-168`` in the reference):

    u8 IQ (262,144/block @ 1.14 Msps) -> (x-127.5)/127.5
    -> 63-tap LPF (FIR) -> decimate /5 -> FM quadrature demod
    -> 63-tap LPF (FIR) -> decimate /5 -> 45.6 kHz audio f32

Two ways to run a block:

* :func:`make_block_fn` — the chain as tensor ops (polyphase or dense),
  on any device; carried state = FIR tails + the previous mid sample.
* :func:`make_fused_block_fn` — the single-kernel chain
  (:mod:`comms_tpu_torch.kernels.fm_chain`) over planar u8 planes; its
  carried context is recomputed per block from the raw input tail.
* :func:`make_pipeline` — the chain as a composed
  :class:`comms_tpu_torch.runtime.Pipeline` of BlockOps, whose two
  decimating FIRs run on the decimating-FIR kernel (K2) where the block
  meets its quantum.

:func:`run_file` demodulates a recorded capture, read ahead by the
native C++ block reader (:mod:`comms_tpu_torch.native`), taking the
fused path on a CUDA device when the block size allows it.  The 63 LPF
coefficients are the data constants of fm_radio.rs:29-55.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from comms_tpu_torch.kernels import fm_chain
from comms_tpu_torch.ops import demodulation, fir

__all__ = ["FM_LPF_TAPS", "FmReceiverConfig", "make_block_fn",
           "make_scan_fn", "make_pipeline", "init_state", "run_file",
           "make_fused_block_fn",
           "fused_init_state", "FUSED_BLOCK_QUANTUM", "FUSED_TAIL_SAMPLES",
           "fused_ctx_from_raw_tail", "state_from_jax",
           "fused_state_from_jax"]

# Low-pass filter coefficients from the reference example
# (fm_radio.rs:29-55) — data, symmetric 63-tap LPF.
FM_LPF_TAPS = np.array([
    -0.01801270027742274, -0.004656920885448867, -0.002648852132912597,
    0.0008677368918448623, 0.005009212152225975, 0.008526175375849215,
    0.010172968340398776, 0.00912437509989248, 0.005334905990231011,
    -0.0003335859703032652, -0.0063014158102353, -0.01064075999239304,
    -0.011581891677991056, -0.008341954525032592, -0.0012824780121151447,
    0.007845515892673058, 0.016328062816332187, 0.021185546181771774,
    0.02007654361670823, 0.01217403940591024, -0.0013140567851934943,
    -0.017152074443356792, -0.030621606809715814, -0.03659663988110718,
    -0.030901697984472332, -0.01147126195667417, 0.02079513703320541,
    0.06194329755943689, 0.10559594630001239, 0.14421303245485026,
    0.17074726962322123, 0.18019648556329151, 0.17074726962322123,
    0.14421303245485026, 0.10559594630001239, 0.06194329755943689,
    0.02079513703320541, -0.01147126195667417, -0.030901697984472332,
    -0.03659663988110718, -0.030621606809715814, -0.017152074443356792,
    -0.0013140567851934943, 0.01217403940591024, 0.02007654361670823,
    0.021185546181771774, 0.016328062816332187, 0.007845515892673058,
    -0.0012824780121151447, -0.008341954525032592, -0.011581891677991056,
    -0.01064075999239304, -0.0063014158102353, -0.0003335859703032652,
    0.005334905990231011, 0.00912437509989248, 0.010172968340398776,
    0.008526175375849215, 0.005009212152225975, 0.0008677368918448623,
    -0.002648852132912597, -0.004656920885448867, -0.01801270027742274,
], dtype=np.float64)


class FmReceiverConfig:
    """Block 262,144 samples (the rtl-sdr read granularity,
    rtlsdr_radio.rs:74-77); decimations 5 and 5 (fm_radio.rs:148-151).

    Two compute paths, selected by block divisibility:

    * **polyphase** (block % (dec1*dec2) == 0): decimating FIRs compute
      only the kept outputs, with continuous decimation stride across
      blocks (streaming-correct).
    * **dense** (reference parity): full-rate banded FIR then
      per-block-reset stride, matching the reference's chain for its
      2^18 block size (which 5 does not divide).

    The taps are float32 and real on both stages, so complex input runs
    as two real products per stage.
    """

    def __init__(self, block: int = 262144, dec1: int = 5, dec2: int = 5):
        self.block = int(block)
        self.dec1 = int(dec1)
        self.dec2 = int(dec2)
        self.num_taps = len(FM_LPF_TAPS)
        self.polyphase = (self.block % (dec1 * dec2) == 0
                          and dec1 > 1 and dec2 > 1)
        taps = FM_LPF_TAPS.astype(np.float32)
        if self.polyphase:
            self.Hb_iq = fir.decimating_branch_taps(taps, dec1)
            self.Hb_audio = fir.decimating_branch_taps(taps, dec2)
        else:
            self.B_iq = fir.banded_tap_matrix(taps)
            self.B_audio = fir.banded_tap_matrix(taps)

    @property
    def audio_per_block(self) -> int:
        return _tail_valid_out(self, self.block)

    @property
    def ctx1_len(self) -> int:
        return (self.Hb_iq.size - 1 if self.polyphase
                else self.num_taps - 1)

    @property
    def ctx2_len(self) -> int:
        return (self.Hb_audio.size - 1 if self.polyphase
                else self.num_taps - 1)


def init_state(cfg: FmReceiverConfig, device="cuda"):
    """Zero state: (IQ FIR tail as [L, 2] f32 pairs, previous mid sample
    as [2] f32, audio FIR tail [L2] f32)."""
    f32 = torch.float32
    return (
        torch.zeros((cfg.ctx1_len, 2), dtype=f32, device=device),
        torch.zeros((2,), dtype=f32, device=device),
        torch.zeros((cfg.ctx2_len,), dtype=f32, device=device),
    )


def state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state`-shaped state (as numpy
    arrays) as this package's state on ``device``; the streams then
    continue identically (the taps are the same constants on both
    sides)."""
    return tuple(torch.tensor(np.asarray(s, np.float32), device=device)
                 for s in state)


def make_block_fn(cfg: FmReceiverConfig):
    """``(state, iq_u8_pairs[N, 2]) -> (audio_f32[M], new_state)`` on the
    device of the input.  Rows are raw rtl-sdr bytes (re, im) as uint8,
    exactly the recorded file layout."""
    if cfg.polyphase:
        F1, F2 = cfg.Hb_iq, cfg.Hb_audio
    else:
        F1, F2 = cfg.B_iq, cfg.B_audio

    def block(state, iq_u8):
        ctx_pairs, prev_pair, actx = state
        # ConvertNode (fm_radio.rs:77-91): u8 -> (x - 127.5) / 127.5
        f = (iq_u8.to(torch.float32) - 127.5) / 127.5
        x = torch.complex(f[:, 0], f[:, 1])

        ctx = torch.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        if cfg.polyphase:
            y, ctx = fir.fir_decimate_poly(x, F1, ctx)
        else:
            y, ctx = fir.fir_block(x, F1, ctx)
            y = y[:: cfg.dec1]

        prev = torch.complex(prev_pair[0], prev_pair[1])
        d, prev = demodulation.fm_demod_block(y, prev, fast=True)

        if cfg.polyphase:
            audio, actx = fir.fir_decimate_poly(d, F2, actx)
        else:
            a, actx = fir.fir_block(d, F2, actx)
            audio = a[:: cfg.dec2]

        new_state = (
            torch.stack([ctx.real, ctx.imag], dim=-1),
            torch.stack([prev.real, prev.imag]),
            actx,
        )
        return audio, new_state

    return block


def make_pipeline(cfg: Optional[FmReceiverConfig] = None):
    """The same chain on the runtime layer: a
    :class:`comms_tpu_torch.runtime.Pipeline` of BlockOps, ``(state,
    iq_u8[N, 2]) -> (audio[N/25], state)`` through ``pipe.step``.

    Both stages are ``FirDecimate``: on K2's kernel where the block is a
    multiple of its quantum (``runtime.block.kernel_quantum``: 5,120
    samples at dec 5 for the first stage, and the second stage's input
    the same multiple of its own), else on :func:`make_block_fn`'s
    GEMM, to which it is then equal bit for bit.  The first stage's
    taps are complex with zero imaginary parts, as in the JAX package;
    they run as real taps."""
    from comms_tpu_torch.runtime import FirDecimate, FmDemod, Lambda, Pipeline

    cfg = cfg or FmReceiverConfig()

    def convert(iq_u8):
        f = (iq_u8.to(torch.float32) - 127.5) / 127.5
        return torch.complex(f[:, 0], f[:, 1])

    return Pipeline([
        Lambda(convert, result_dtype=torch.complex64),
        FirDecimate.make(FM_LPF_TAPS.astype(np.complex64), cfg.dec1),
        FmDemod(fast=True),       # matches make_block_fn's demod
        FirDecimate.make(FM_LPF_TAPS.astype(np.float32), cfg.dec2),
    ])


def make_scan_fn(cfg: FmReceiverConfig):
    """Multi-block step: ``(state, iq_u8[num_blocks, block, 2]) ->
    (audio[num_blocks, M], state)``, the blocks in a loop with the state
    carried on the device."""
    block = make_block_fn(cfg)

    def scan(state, blocks):
        outs = []
        for xb in blocks:
            audio, state = block(state, xb)
            outs.append(audio)
        return torch.stack(outs), state

    return scan


def _tail_valid_out(cfg: FmReceiverConfig, v: int) -> int:
    """Audio samples of a length-``v`` ragged tail that are exact
    samples of the infinite stream.  The chain is causal — audio[j]
    depends only on inputs <= j*dec1*dec2 — so zero-padding the tail to
    a full block and truncating to this count reproduces the unchopped
    stream exactly."""
    mid = -(-v // cfg.dec1)
    return -(-mid // cfg.dec2)


def _append_tail(block_fn, state, tail_iq: np.ndarray,
                 cfg: FmReceiverConfig, chunks: list, device) -> None:
    """Process a final ragged block: pad to the full block shape and
    keep only the causally valid prefix of the audio."""
    v = int(tail_iq.shape[0])
    if v == 0:
        return
    pad = np.zeros((cfg.block - v, 2), np.uint8)
    iq = torch.from_numpy(np.concatenate([tail_iq, pad])).to(device)
    audio, _ = block_fn(state, iq)
    chunks.append(audio[: _tail_valid_out(cfg, v)].cpu().numpy())


# --------------------------------------------------------------- fused path
# The single-kernel chain (kernels/fm_chain.py): planar u8 planes in,
# audio out.  The block length must be a multiple of the kernel's block
# quantum; the carried context is recomputed per block from the raw
# input tail with the tensor ops (~26k samples).

FUSED_BLOCK_QUANTUM = fm_chain.IN_PER_STEP    # 102,400

# Raw samples needed to recompute the kernel's full carried context:
# the d tail needs 5121 mid samples = 5121*5 inputs + 64 of FIR
# context; the x tail (20480) is a suffix of that window.
_FUSED_M_T = fm_chain.CTX_D + 1
_FUSED_L_X = _FUSED_M_T * 5
_FUSED_CTX1 = 64
FUSED_TAIL_SAMPLES = _FUSED_L_X + _FUSED_CTX1   # 25,669


def fused_ctx_from_raw_tail(re_u8, im_u8):
    """Derive :func:`make_fused_block_fn`'s carried context from the
    last ``>= FUSED_TAIL_SAMPLES`` raw u8 samples immediately preceding
    a block boundary (tensors; the context lands on their device).
    ``d`` is the exact ``torch.atan2`` of the lag-1 product, as the JAX
    package uses the exact angle there."""
    if re_u8.shape[0] < FUSED_TAIL_SAMPLES:
        raise ValueError(
            f"need >= {FUSED_TAIL_SAMPLES} raw tail samples, "
            f"got {re_u8.shape[0]}")
    f32 = torch.float32
    Hb = fir.decimating_branch_taps(FM_LPF_TAPS.astype(np.float32), 5)
    span = FUSED_TAIL_SAMPLES
    fre = (re_u8[-span:].to(f32) - 127.5) / 127.5
    fim = (im_u8[-span:].to(f32) - 127.5) / 127.5
    x_t = torch.complex(fre, fim)
    mid_t, _ = fir.fir_decimate_poly(x_t[_FUSED_CTX1:], Hb,
                                     x_t[:_FUSED_CTX1])
    a, b = mid_t[1:], mid_t[:-1]
    zre, zim = demodulation._mul_conj(a.real, a.imag, b.real, b.imag)
    return {
        "xre": re_u8[-fm_chain.CTX_X:].to(f32),
        "xim": im_u8[-fm_chain.CTX_X:].to(f32),
        "d": torch.atan2(zim, zre),
        "prev": torch.stack([mid_t[-1].real, mid_t[-1].imag]),
    }


def fused_init_state(device="cuda"):
    """Stream-start context for :func:`make_fused_block_fn`."""
    return fm_chain.zero_ctx(device)


def fused_state_from_jax(ctx, device="cuda"):
    """The JAX package's fused context dict (as numpy arrays) as this
    package's context on ``device``."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in ctx.items()}


def make_fused_block_fn(cfg: Optional[FmReceiverConfig] = None):
    """``(state, re_u8[N], im_u8[N]) -> (audio[N/25], state)`` running
    the fused chain.  N = cfg.block must be a multiple of
    FUSED_BLOCK_QUANTUM.  On CUDA tensors it runs the kernel, on CPU
    tensors the kernel's plain version."""
    cfg = cfg or FmReceiverConfig(block=64 * FUSED_BLOCK_QUANTUM)
    if cfg.block % FUSED_BLOCK_QUANTUM:
        raise ValueError(
            f"fused chain needs block % {FUSED_BLOCK_QUANTUM} == 0, "
            f"got {cfg.block}")
    if cfg.dec1 != 5 or cfg.dec2 != 5:
        raise ValueError("fused chain is specialized to dec1 = dec2 = 5")

    def block(state, re_u8, im_u8):
        audio = fm_chain.fm_chain_fused(re_u8, im_u8, state,
                                        FM_LPF_TAPS, FM_LPF_TAPS)
        new_state = fused_ctx_from_raw_tail(
            re_u8[-FUSED_TAIL_SAMPLES:], im_u8[-FUSED_TAIL_SAMPLES:])
        return audio, new_state

    return block


def _fused_to_xla_state(cfg: FmReceiverConfig, fstate):
    """Map the fused kernel's context onto make_block_fn's state (for
    the ragged-tail block)."""
    xre = fstate["xre"][-cfg.ctx1_len:]
    xim = fstate["xim"][-cfg.ctx1_len:]
    ctx_pairs = (torch.stack([xre, xim], dim=-1) - 127.5) / 127.5
    return (ctx_pairs, fstate["prev"], fstate["d"][-cfg.ctx2_len:])


def _read_blocks(iq_path, nbytes: int):
    """The capture's bytes, ``nbytes`` a block, as uint8 arrays; the last
    block may be short.  Through the native reader when it builds: a C++
    thread reads the next blocks ahead while the device works, and each
    block is a view borrowed from its ring, valid until the next one is
    asked for.  Only the reader's construction may fall back to numpy
    reads; once streaming starts every error propagates (a retry
    mid-stream would repeat blocks with advanced state)."""
    from comms_tpu_torch.native import NativeBlockReader

    try:
        reader = NativeBlockReader(iq_path, block_bytes=nbytes)
    except (RuntimeError, OSError):
        return _numpy_blocks(iq_path, nbytes)
    return _native_blocks(reader)


def _native_blocks(reader):
    with reader:
        while True:
            data = reader.next_block()
            if data is None:
                return
            yield data


def _numpy_blocks(iq_path, nbytes: int):
    with open(iq_path, "rb") as f:
        while True:
            data = np.fromfile(f, dtype=np.uint8, count=nbytes)
            yield data
            if data.size < nbytes:
                return


def run_file(iq_path, cfg: Optional[FmReceiverConfig] = None,
             out_path=None, fused: Optional[bool] = None,
             device="cuda") -> np.ndarray:
    """Demodulate a recorded u8-IQ file on ``device``; returns (and
    optionally writes, as f32 PCM) the audio stream.  A final partial
    block is zero-padded to the block shape and masked to its causally
    valid length, so a capture of ANY length demodulates to the exact
    sample.

    ``fused``: run full blocks through the single-kernel chain
    (requires cfg.block % FUSED_BLOCK_QUANTUM == 0; the interleaved
    bytes are split into planes on the device).  Default: fused when
    the block size allows it and ``device`` is CUDA.  The ragged tail
    always runs through :func:`make_block_fn` (its state derived from
    the fused context)."""
    cfg = cfg or FmReceiverConfig()
    device = torch.device(device)
    if fused is None:
        fused = (cfg.polyphase and cfg.block % FUSED_BLOCK_QUANTUM == 0
                 and cfg.dec1 == 5 and cfg.dec2 == 5
                 and device.type == "cuda")
    block = make_block_fn(cfg)
    if fused:
        fblock = make_fused_block_fn(cfg)
        state = fused_init_state(device)

        def process(state, iq):
            return fblock(state, iq[:, 0].contiguous(),
                          iq[:, 1].contiguous())

        def tail_state(state):
            return _fused_to_xla_state(cfg, state)
    else:
        state = init_state(cfg, device)
        process = block

        def tail_state(state):
            return state

    chunks = []
    nbytes = cfg.block * 2
    blocks = _read_blocks(iq_path, nbytes)
    try:
        for data in blocks:
            if data.size < nbytes:
                # copied out of the reader's ring before it is reclaimed
                tail = np.array(data[: 2 * (data.size // 2)])
                _append_tail(block, tail_state(state), tail.reshape(-1, 2),
                             cfg, chunks, device)
                break
            # The next block hands this one's buffer back to the reader
            # thread, so the step must be done reading it by then.  It
            # is: the copy below is from pageable memory, which PyTorch
            # stages before .to() returns (no non_blocking copy, no
            # pinned view); on the CPU, copy=True makes it a copy too.
            iq = torch.from_numpy(data.reshape(-1, 2))
            audio, state = process(state, iq.to(device, copy=True))
            chunks.append(audio.cpu().numpy())
    finally:
        blocks.close()
    audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if out_path is not None:
        audio.astype(np.float32).tofile(out_path)
    return audio
