#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the FM broadcast
receiver, the wideband FM band monitor, the QPSK receiver, FFT and Welch
spectrum monitoring, the sharded layer on an 8-shard mesh of the card,
the BPSK and QPSK transmitters, the QPSK link, the file edges (the
native block reader, audio, the file-replay radio and the examples),
and the sharded layer across two and four processes on the card.

    python3 chip_smoke.py        # from the repository root

Phases (each raises on failure, so any failure exits non-zero):

1. card name and power limit (nvidia-smi), torch and CUDA versions;
2. build the kernels from ``comms_tpu_torch/csrc`` (one nvcc per source,
   in parallel) and print ptxas's register and spill report; build the
   native block reader with g++ (``run_file`` reads through it from
   phase 4 on; a failed build fails the run) and print its path and
   seconds;
3. FM: the fused FM kernel against its plain PyTorch version on the
   card, at the 26,214,400-sample block (from the stream-start context
   and from a mid-stream one) and on white noise;
4. FM main path: ``run_file`` over a capture of three full blocks and a
   ragged tail, fused and unfused, plus a small capture against the CPU
   run of the same code; ``StreamRunner`` over the fused block step, 8
   blocks after 3 warm-up blocks, state chained, depth 4, from
   device-resident and from pinned host blocks; the dense
   262,144-sample block of the reference's entry config, on the card
   against the CPU;
5. band monitor kernels against their plain versions at the main path's
   shapes: the channelizer (K=64 and K=16, 16,777,216 samples, zero and
   mid-stream context; both also against a float64 channelizer), the
   decimating FIR (the staged audio stage's
   batch of 8 channel pairs, and the same chopped in two calls through
   the carried context: bit for bit) and its poly-FIR entry (dec 5, 63
   and 641 taps), the fused band monitor (K=16 and K=64, 16,777,216 samples,
   zero and mid-stream state) on a capture with one FM station at the
   centre of every channel, and on white noise at 3 x 16,384 samples;
   the staged lag-1 demod (409,600 frames of 64 channels, both atan2s,
   from mid-stream);
6. band monitor main path: ``StreamRunner`` over the fused block step
   at K=16, 8 blocks of 16,777,216 after 3 warm-up blocks, depth 4,
   state chained, from device-resident and from pinned host blocks; the
   staged block step (channelizer, lag-1 demod and decimating-FIR
   kernels) and the 64-channel channelizer model on the same blocks;
   fused against staged, each channel's tone against its spectrum, and
   exact launch counts per kernel;
7. kernel and plain-version times at the main paths' shapes (CUDA
   events around calls queued behind a spin kernel, so they time the
   device and not the wrapper's host code; the channelizer at K=64 and
   K=16, the poly-FIR entry at 63 and 641 taps), each beside the card's
   name and power limit, and a ``torch.profiler`` split of 8 served FM
   blocks, of 8 served band-monitor blocks, and of 3 staged
   band-monitor and 3 channelizer-model blocks (the device's busy
   share and its time by operation: K1, K9, K8, K2, the sink's
   device-to-host copy);
8. QPSK: a synthetic capture of 33,554,432 samples (2^25, bench.py's
   capture), the FIR kernel (the matched filter's 32 real taps, and 257
   complex taps from a mid-stream context), the symbol kernel's three
   entries with panels at halfwidth 51 (zero and carried context) and
   the panel reductions against their plain versions (twice on the same
   panels, bit for bit); panels repeat bit for bit, and stay within 1e-5
   of the panels of float64 planes at 2^19, 2^22 and 2^25 samples; the
   kernel route against the tensor route at one IN_PER_STEP block;
9. QPSK main paths: the one-shot receiver (fused core: the symbol
   kernel's panel and ``_scalars`` entries) and the staged core (the FIR
   kernel) on the capture, zero bit errors over the whole capture, the
   capture's timing estimate rebuilt from the panel reductions;
   ``StreamRunner`` over the fused stream step, 8 gap-free blocks of
   33,554,432 after 3 warm-up blocks, depth 4, state chained, from
   device-resident and from pinned host blocks, zero bit errors after the
   warm-up block with one lag across the seams; the fast step on the
   same blocks; two blocks under ``torch.cuda.set_sync_debug_mode
   ("error")``; exact launch counts;
10. QPSK kernel, plain-version and library (a packed ``torch.matmul``
   for the panels) times, the symbol kernel alone (both entries, its own
   row in the kernel table, with its launches on both main paths), and
   a ``torch.profiler`` split of one served block;
11. spectrum kernels against their plain versions at full width, on a
   white-noise capture: the FFT kernel at 16,777,216 samples as rows of
   every size, 256..16384 (scale 1/sqrt(n), against a float64 oracle
   on a subset of rows, the plane-swap step twice an exact bin reversal)
   and the 256-point spectrogram; the PSD kernel's stream entry and its
   row entry (the stream's ``unfold`` view) at every size, 256..16384,
   against the plain version and a float64 oracle bin by bin, the two
   entries bit for bit, and the row entry through ``welch_psd``; then
   three tones standing out of the noise of a tone capture;
   the four-step kernel: ``welch_numerator`` at 2^20 x 32 in its three
   ingest layouts, with means and with sparse demean, stage A, and
   ``fft_large`` at 2^20 x 32 and 2^22 x 8;
12. spectrum main path: ``welch_psd_planar`` served through
   ``StreamRunner`` (8 blocks of 16,777,216 after 3 warm-up blocks, depth
   4, device-resident and pinned host blocks), ``welch_psd``,
   ``spectrogram``, the 2^20 x 32 wideband ``welch_psd`` and both
   ``fft_large`` shapes; exact launch counts per kernel entry; a
   ``torch.profiler`` split of one served block;
13. spectrum kernel, plain-version and library (``torch.fft.fft``) times;
   the FFT kernel at every size beside its plain version,
   ``torch.fft.fft`` of a complex tensor packed beforehand and its bound;
   the PSD kernel's two entries at every size beside its plain version,
   the FFT-alone yardstick (``torch.fft.fft`` of the same segments packed
   beforehand) and its bound;
   a ``torch.profiler`` split of the 256-point spectrogram, kernel route
   against tensor route;
14. every kernel table row carries its bound (the largest of bytes over
   3.35 TB/s, float32 operations over 67 TFLOP/s and, for K5's panels,
   3xTF32 operations over 495 TFLOP/s, from this run's shapes) and, where
   one PyTorch call computes the same function (``F.conv1d`` for the FIR
   entries, ``torch.fft.fft`` for the FFT entries, a packed
   ``torch.matmul`` for the QPSK panels), that call's time;
15. the ring halo exchange kernel (K12) against its plain version bit for
   bit, at the sharded paths' halos (complex64, float32 and u8 tails, the
   wrapped and the carried-context forms, the 2-D column rings, both
   planes in one launch) and on a 1 MiB-per-shard ring; then byte for
   byte over a sweep of the sources' byte offsets 0..15 x lengths 1, 15,
   16, 17, 4,095 and 25,669 elements and 1 MiB, for u8, float32 and
   complex64, wrapped and with contexts;
16. the sharded layer on an 8-shard mesh of the card (the counts of every
   kernel start at 0 before each path and are read after it): the sharded
   wideband chain at 26,214,400 samples against the same chain on one
   shard and its ``rdma_halo`` build bit for bit, two blocks streamed; the
   sharded fused FM step bit for bit against a sequential run of the
   fused block step over the 8 per-shard blocks, served through
   ``StreamRunner`` beside the unsharded fused step; the band monitor at
   16,777,216, K=16, fused per shard (K9) and on the 2 x 4 mesh (K8 + K2
   per shard) against the one-device paths; the sharded QPSK receiver on
   the 2^25-sample capture with zero bit errors; the frequency-sharded
   (dfft) and segment-sharded (K10 per shard) PSDs at 2^20 x 32 per bin
   against ``welch_psd``; K12's launches per path and each path's
   per-shard kernel launches;
17. ``dryrun_multichip(8)`` on the card, and K12's kernel, plain-version,
   bound and library (``torch._foreach_copy_``) times beside the launch
   floor (an empty kernel with K12's 2 KB and with a 16-byte parameter
   block), and the wrapper's host µs per call (100 unsynchronised calls).
   Phase 10 prints the floor beside the panel reductions' time too;
18. transmit (no kernel of its own): the BPSK and QPSK transmitters'
   fast paths at 16,777,216 samples a block (QPSK with its mixer at
   dphase 0.01, phase0 0.6) and pair paths at the reference's 4096-symbol
   and 4096-bit blocks; one block of each on the card against the CPU
   (the drawn bits and the fast paths' packed words and states bit for
   bit, the pair paths within 1 LSB), 3 chained blocks of each against a
   float64 oracle built on the card from the bits the port's threefry
   drew (within 1 LSB, under 1% of samples differing); a loopback of
   2^24 bits (33,554,432 samples) with QPSK's carrier offset, phase and
   noise through the one-shot receiver and the staged core (zero bit
   errors) and K11 on its panels, with the one-shot phase's launch
   counts; each fast path served through ``StreamRunner`` with no sink
   and with a copying sink (Msps), the host's enqueue ms, the device ms
   a block, and ``torch.profiler`` splits of one block and of 8 served
   blocks (device operations, busy share);
19. the composable runtime (``comms_tpu_torch/runtime``; the counts of
   K2, K4 and K12 start at 0 before each path and are read after it):
   the FM receiver's ``make_pipeline`` at 26,214,400 samples, 3 blocks
   chained (K2 twice a block, against ``make_block_fn`` and the tones),
   served through ``StreamRunner`` (Msps, busy share); the ``Fir`` op at
   33,554,432 complex64 samples with 32 real taps (K4's entry) and a
   ``FirDecimate`` op at 16,777,216, dec 4, 32 taps (K2), each against
   the GEMM op on the same input; the BPSK and QPSK ``make_pipeline`` at
   16,777,216 samples a block, 3 blocks bit-equal to ``make_block_fn``;
   the FM pipeline's ``make_sharded_step`` over 8 shards against the
   unsharded pipeline (K12 once per op with a halo); dry-run config 3;
   the ``Graph`` feedback doubler; a checkpoint saved mid-stream and
   resumed bit for bit; ``BatchedStreamRunner`` over 3 FM streams against
   separate runs; kernel rows for K2 at the pipeline's two stages, K4 and
   K2 under the ops, and K12 at the pipeline's halos;
20. the QPSK link (the counts of K5 and of the recurrence kernels start
   at 0 before each path and are read after it): the fused stream step
   over 3 streams of 262,144 samples through ``BatchedStreamRunner`` with
   ``mode="vmap"`` (the step runs once a stream) bit-equal to
   ``mode="unroll"``; the Costas-loop kernel against its plain version at
   2,048 and 16,384 symbols and timed at 2,048 and 2^20; the AGC scan
   kernel against its plain version at 4,096 samples and timed at 4,096
   and 262,144; the dependent chain's measured floor of both loops
   (``tools/recurrence_floor.chain_floor``, its probe built in phase 2
   beside the package: the step on register-resident data, one warp; the
   fewest SASS instructions a step, for the issue term); the batched
   kernels (B streams a launch, one lane a stream) against the batched
   plain versions bit for bit at B = 1, 8, 32, 64, 512 and 16,896 (2,048
   symbols, 4,096 samples), each timed beside its bound; the Costas
   receiver (``make_stream_fn``, 8,192-sample
   blocks) served through ``StreamRunner`` over the JAX test's channel
   (34 blocks, a carrier step at block 17), zero bit errors after 3
   acquisition blocks, then served again over the same blocks for its
   rate (each step call's host time on both passes), with its host
   enqueue, device ms and a profile of one block; the network loopback: the port's QPSK
   transmitter on the card (4,096 bits a block, 128 blocks) through
   ``qpsk_stream.stream_blocks`` over TCP on 127.0.0.1 to
   ``receive_blocks`` in a thread, raw and CBOR, then the Costas receiver
   on the card, zero bit errors after acquisition; the split serving
   step against the fast step (1e-5) and the ``est_lag=2`` fused step
   (zero bit errors after its two warm-up blocks) at 33,554,432 samples,
   each served with no sink beside the fused step (``est_lag=1``), with
   K5's launches a block; the Costas receiver served for 8 and 64
   streams (each its own channel, seeds 11 + b) through
   ``BatchedStreamRunner``: ``mode="vmap"`` with the batched vmap rule
   (one Costas launch a round), the same with the per-slice rule (a
   launch a stream), and ``mode="unroll"``: zero bit errors on every
   stream; the Costas op's calls under vmap (its [B, n] inputs as vmap
   passes them) against the batched plain version bit for bit at the
   carrier step's round and the last; the vmapped symbols and states
   against unroll bit for bit, else within TOL_SPLIT, else within
   TOL_VMAP_SYM and TOL_VMAP_STATE a block with the same decisions on
   every stream (it prints which); the per-slice rule bit for bit with
   the batched one; each route's Msps, host enqueue and device ms a
   round and busy share; kernel rows for the Costas loop and the AGC
   scan;
21. the file edges (the counts of every kernel start at 0 before each
   path and are read after it): the native block reader available (phase
   2 built it); ``run_file`` at 26,214,400-sample
   blocks over phase 4's capture through the native reader, 3 K1
   launches, bit-equal to the same call with the reader's construction
   made to fail (numpy reads); both readers' read GB/s over the capture
   and ``run_file``'s seconds a block with each; the capture served from
   ``FileReplayRadio`` through ``StreamRunner`` over the fused step into
   a ``WavSink``, bit-equal to ``run_file``'s blocks and the WAV's frames
   the scaled audio; ``play_audio.play_file`` on that audio as f32 and
   i16 PCM; then each of the eleven examples' ``main`` on the card, one
   line each with its seconds, its launches and its check (the FM tones
   in fm_radio's WAV, the WAVs of multi_stream_serving against
   ``run_file``'s blocks, zero bit errors from qpsk_receiver, each band
   monitor channel's tone, the channelizer's tones, the transmitters'
   files against the CPU's, qpsk_zmq's received samples against the
   transmitter's blocks, the PSD's carriers, the sharded FM stream bit
   for bit).
22. worker processes on the card (``parallel.multihost``, gloo; each
   started as ``chip_smoke.py --pod-worker RANK PROCS LOCAL PORT DIR``
   with a timeout, its output read; one that exits non-zero, times out
   or prints no OK line fails the run), in two spawns, each program
   against the same program on a mesh of as many shards in one process,
   bit for bit.  First 2 processes x 4 shards of an 8-shard pod mesh:
   the psum; K12's cross-process form at the fused raw tails (25,669-byte
   u8 tails, the ring wrapped, 3 calls, a cross-process launch a call on
   each rank) against the exchange in one process; the fused FM step at
   26,214,400 samples, 3 blocks chained from stream start (the counts at
   0 before, K1 4 a block a rank, K12 1 and 2 a block; audio and state
   written by the workers and compared here); the wideband chain at
   26,214,400 and the QPSK receiver at 2^25 (K5 per shard); the
   frequency-sharded PSD at 2^20 x 32, its dfft's two all-to-alls on K12
   (one cross-process launch each a rank); dry-run config 8 across the
   processes.  Then 4 processes x 2 shards.  Both spawns run the 2-D
   band monitor at 16,777,216 samples, K = 16, on a 2 x 4 ``mesh_2d``
   laid over the processes, 2 blocks chained (counts at 0 before: K8 and
   K2 once a local shard a block, K12's cross-process launches those of
   ``band2d_crossings``, the corner turn's counted apart: none at 2 x 4,
   one a block a rank at 4 x 2, where each time row spans two
   processes).  The second spawn also times one corner turn at the 2-D
   step's shapes on the device route beside the gloo route (host copies).
   It prints K12's cross-process device ms and host µs a call (and the
   gloo barrier's alone) beside its plain version (gloo on host
   tensors), the fused step's and the 2-D step's wall ms a block on the
   processes beside one process x 8 shards, the corner turn's host µs
   and device span beside gloo, and each worker's seconds, each beside
   the card's name and power limit; K12's cross-process rows (the halo,
   the all-to-all) join the kernel table.

The inputs are synthetic captures made from fixed seeds (numpy for the
FM receiver, torch on the card for the band monitor, numpy bits and
torch on the card for the QPSK capture, torch on the card for the
spectrum captures, the port's threefry for the transmitters).  The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BLOCK = 26_214_400      # one wideband-capture block (bench.py's size)
RAGGED = 3_777          # ragged tail of the run_file capture
SERVE_BLOCKS = 8
SERVE_DEPTH = 4
SERVE_WARMUP = 3
ENTRY_BLOCK = 262_144   # rtl-sdr read size, the dense path
NOISE_N = 204_800
# Kernel vs plain: both float32 with different summation orders; on a
# clean FM capture the phase step is far from +-pi, so errors stay
# ~1e-6.  White noise can sit near the atan2 branch cut, where a last-
# bit difference in z moves one d by up to 2*pi*|h|, hence its wider
# bound (the JAX package's own 1e-3 parity bound for this chain).
TOL_KERNEL = 1e-4
TOL_NOISE = 1e-3
TOL_PATHS = 1e-3        # fused vs unfused run_file (the JAX bound)
TOL_DENSE = 1e-4        # dense block on the card vs the CPU
REPO = Path(__file__).resolve().parent

# Band monitor (bench.py:488-625): the wideband block, the fused K=16
# configuration served, and the K=64 BASELINE channelizer.
BM_BLOCK = 16_777_216
BM_K = 16
BM_K64 = 64
LD_FRAMES = 409_600     # the staged demod at bm64_staged's block / K
BM_NOISE = 16_384       # white noise runs at 3 x this
POLY_DEC = 5
POLY_N = 409 * 64 * POLY_DEC * 128   # 16,752,640: the poly entry's quantum
# Kernel vs plain, relative to the plain output's largest magnitude: the
# JAX package's parity bounds for the same kernels (float32 on both
# sides here, in other summation orders).  On the station capture every
# phase step stays within about +-pi/2, far from the atan2 branch cut.
TOL_CHAN = 1e-5
TOL_FIR = 5e-5
TOL_BM = 2e-4
TOL_DEMOD = 1e-6        # rad: the demod kernel's FMA-contracted atan2


# QPSK receiver (bench.py:414-485): one 2^25-sample capture of the
# qpsk_tx waveform (RRC sps 4, 32 taps, beta 0.25) with the impairments
# of tests/test_qpsk_rx.py:52-62.  The capture repeats a 2^22-sample
# period (circular pulse shaping and delay), so any run of blocks of a
# multiple of the period is one gap-free stream.
QPSK_N = 33_554_432
QPSK_PERIOD = 4_194_304
QPSK_CFO, QPSK_PHASE, QPSK_DELAY, QPSK_NOISE = 0.01, 0.6, 2.3, 0.02
QPSK_MARGIN = 16        # symbols skipped at a one-shot block's edges
# Kernel vs plain: float32 on both sides in other summation orders, the
# same de-rotation angle decomposition (symbols, relative to the largest
# symbol); panels relative to the largest panel entry; the kernel route
# vs the tensor route (another angle decomposition) at the JAX test's
# 1e-3 (tests/test_qpsk_rx.py:170-178).
TOL_SYM = 1e-4
TOL_PANEL = 1e-5
PANEL_F64_N = (1 << 19, 1 << 22, QPSK_N)   # panels held to float64 here
TOL_ROUTE = 1e-3
TOL_REDUCE = 1e-4
TOL_STREAM_SYM = 2e-3   # fast vs fused stream step (the JAX test's)
TOL_STREAM_STATE = 1e-3
# Kernel launches of the one-shot phase (9a): the fused receiver (K5's
# panels, its ``_scalars`` symbol entry), the staged core (K4, the matched
# filter) and K11 on the capture's panels, no plain version.
QPSK_ONE_SHOT_LAUNCHES = {"qpsk_panels": 1, "qpsk_symbol_gemm": 1,
                          "qpsk_symbol_gemm_scalars": 1, "qpsk_symbols": 1,
                          "fir_planar": 1, "panel_reductions": 1,
                          "plain": 0}

# FFT and spectrum monitoring: the Welch serving block and FFT rows of
# bench.py:796-940 (16,777,216 samples, 1024 bins), the FFT kernel's
# sizes, a capture with three tones at known bins of a 1024-point FFT
# (amplitudes 1, 0.5, 0.25) plus noise of sigma 0.01, and the wideband
# PSD of bench.py:628-670 (2^20 bins x 32 segments) with the 2^22 x 8
# edge of the four-step stages.
SP_N = 16_777_216
SP_NFFT = 1024
SP_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
SP_TONES = (101, 300, 777)
SP_NOISE = 0.01
BIG = ((1 << 20, 32), (1 << 22, 8))
# The JAX tests' bounds (FFT outputs 1e-5 against a float64 oracle, PSDs
# 2e-5), the three K10 layouts 1e-5, the kernel and tensor Welch routes
# and the spectrogram 1e-4, the involution 1e-4: relative to the largest
# magnitude, except K7's PSDs and the Welch routes, which are held bin by
# bin (each bin's error relative to that bin).
TOL_FFT = 1e-5
TOL_PSD = 2e-5
TOL_LAYOUT = 1e-5
TOL_WELCH = 1e-4
TOL_INVOLUTION = 1e-4

# The sharded layer: an in-process mesh of 8 shards on the one card (the
# counterpart of the JAX package's 8-device virtual CPU mesh), the FM and
# wideband blocks at BLOCK (3,276,800 samples a shard), the band monitor
# at BM_BLOCK, the QPSK capture, the PSDs at BIG[0]; K12 is also timed on
# a ring of 1 MiB per shard.  The sharded chain against the same chain on
# one shard and the 2-D band monitor against the one-device staged path:
# the same float32 operations on the same windows (the JAX tests' bounds,
# 1e-4 and 1e-5 absolute); the sharded fused band monitor against the
# one-device fused path at TOL_BM (its boundary state is recomputed from
# the raw tail); the PSDs per bin at TOL_PSD.
SH_SHARDS = 8
SH_RING_MIB = 1 << 20
TOL_SH_CHAIN = 1e-4
TOL_SH_2D = 1e-5

# Transmit: the fast paths at bench.py's blocks (BPSK 2^22 symbols,
# bench.py:358, and QPSK 2^23 bits, bench.py:394: 16,777,216 samples
# each), QPSK with its mixer on; the pair paths at the reference's block
# (4096 symbols, 4096 bits).  Each path's chained blocks are held to a
# float64 oracle built on the card from the bits the port's PRNG drew:
# within 1 LSB, under 1% of samples differing (the JAX tests' bounds,
# tests/test_models.py:55-57).  The loopback sends 2^24 bits (33,554,432
# samples, QPSK_N) with QPSK_CFO and QPSK_PHASE through the mixer, adds
# QPSK_NOISE, and decodes them with the port's QPSK receiver.
TX_BPSK_SYMS = 1 << 22
TX_QPSK_BITS = 1 << 23
TX_DPHASE, TX_PHASE0 = 0.01, 0.6
TX_PAIR = 4096
TX_CHAIN = 3
TX_LOOP_BITS = 1 << 24
TX_SEED = 7
TX_LSB_SHARE = 0.01

# Phase 19, the composable runtime (comms_tpu_torch/runtime): the FM
# pipeline at BLOCK, its FIR ops on K2's kernel; the Fir op (K4's entry
# at D = 1) and a FirDecimate op against the GEMM route; the transmit
# pipelines at 16,777,216 samples a block; the sharded FM pipeline; the
# batched runner over 3 FM streams.
RT_FIR_N = 33_554_432
RT_DEC_N = 16_777_216
RT_DEC = 4
RT_TAPS = 32
RT_STREAMS = 3
TOL_RT_FM = 2e-4        # the FM chain vs its tensor path (the CPU tests')

# The card's published rates (NVIDIA H100 SXM data sheet, at its 700 W
# limit): a kernel's bound is the largest of its bytes over the memory
# rate, its operations on the CUDA cores over their float32 rate, and its
# operations on the tensor cores over their dense TF32 rate (three TF32
# operations for each float32 one in 3xTF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(nbytes: float, flops: float, tf32x3_flops: float = 0.0):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``nbytes`` (each input read once, each output written once), to do
    ``flops`` float32 operations on the CUDA cores and ``tf32x3_flops``
    float32 operations on the tensor cores in 3xTF32 (three TF32
    operations each); ``bound_by`` is "bytes" or "operations"."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = max(flops / F32_FLOP_PER_S, 3 * tf32x3_flops / TF32_FLOP_PER_S)
    return (t_b, "bytes") if t_b >= 1e3 * t_o else (1e3 * t_o, "operations")


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               nbytes, flops, library_ms=None, tf32x3_flops=0.0,
               bound_ms_by=None) -> dict:
    """One entry of the kernel table: the bound is computed from this run's
    shapes (``nbytes``, ``flops`` on the CUDA cores, ``tf32x3_flops`` on
    the tensor cores), or given as ``bound_ms_by`` (ms, "bytes" or
    "operations") where a measured floor sets it; every time was measured
    in this run."""
    b_ms, by = bound_ms_by or bound(nbytes, flops, tf32x3_flops)
    tc = (f" + {tf32x3_flops / 1e9:.3f} GFLOP in 3xTF32" if tf32x3_flops
          else "")
    print(f"bound of {name}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} "
          f"GFLOP{tc} -> {b_ms:.4f} ms ({by}); kernel {ms:.4f} ms")
    return {"name": name, "route": "cuda",
            "source": "comms_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms}


def conv1d_ms(rows, taps, stride: int, want=None):
    """The library yardstick of a FIR: the time of one ``F.conv1d`` call
    (cuDNN, TF32 off) over ``rows`` [C, L] (each row its T-1 context
    samples, then the block) with the flipped taps, which computes y[f] =
    sum_t taps[t] x[f*stride - t].  With complex taps ``rows`` is the re
    and im planes [2, L], taken as two input channels into two output
    channels (weights [[hr, -hi], [hi, hr]]).  With ``want`` [C, M] (the
    kernel's output) it also prints their difference."""
    import torch
    import torch.nn.functional as F

    h = np.asarray(taps)[::-1]
    if np.iscomplexobj(h) and np.any(h.imag):
        x = rows[None].contiguous()
        w = np.stack([np.stack([h.real, -h.imag]),
                      np.stack([h.imag, h.real])])
    else:
        x = rows[:, None, :].contiguous()
        w = h.real[None, None]
    w = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(x.device)
    if want is not None:
        y = F.conv1d(x, w, stride=stride).reshape(rows.shape[0], -1)
        print(f"conv1d (stride {stride}, {w.shape[-1]} taps) vs kernel: "
              f"{rel_err(y, want):.3g} relative")
    return cuda_ms(lambda: F.conv1d(x, w, stride=stride))


def fm_tones(t, sin=np.sin):
    """The FM captures' instantaneous frequency (rad/sample) at sample
    indices ``t``: a carrier offset and two modulating tones."""
    return (0.05 + 0.12 * sin(2 * np.pi * 1.3e-4 * t)
            + 0.08 * sin(2 * np.pi * 3.1e-5 * t + 1.0))


def synth_capture(n: int, seed: int):
    """u8 IQ [n, 2] of a carrier frequency-modulated by two tones, at
    amplitude 100 around 127.5 plus Gaussian noise (sigma 2), and its
    instantaneous frequency w [n] in rad/sample.  |w| <= 0.25, so the
    phase step per mid-rate sample (5w) stays far from +-pi."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    w = fm_tones(t)
    ph = np.cumsum(w)
    iq = np.empty((n, 2), np.uint8)
    iq[:, 0] = np.clip(np.round(100 * np.cos(ph) + 127.5
                                + rng.normal(scale=2.0, size=n)), 0, 255)
    iq[:, 1] = np.clip(np.round(100 * np.sin(ph) + 127.5
                                + rng.normal(scale=2.0, size=n)), 0, 255)
    return iq, w


def demod_matches_tones(audio: np.ndarray, w: np.ndarray) -> float:
    """Correlation of the audio with the modulating frequency, aligned
    by the two filters' group delay (31 input + 31 mid samples)."""
    f = np.arange(16, audio.shape[0])
    idx = 25 * f - (31 + 5 * 31)
    return float(np.corrcoef(audio[f], w[idx])[0, 1])


def max_err(a, b) -> float:
    return float((a - b).abs().max().item())


_SPIN_CYCLES_PER_MS = []


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Device time of ``fn()`` in ms: CUDA events, median of ``reps``.
    Each timed call is queued behind a spin kernel that lasts three times
    the host's enqueue of ``fn`` plus 0.5 ms, so the events see the
    device's work back to back and not the wrapper's host code."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    host_ms = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    spin = int(_SPIN_CYCLES_PER_MS[0] * (3 * host_ms + 0.5))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fm_receiver_phases(dev, card: str):
    """Phases 3, 4 and the FM part of 7; returns K1's kernel-table row and
    the capture (u8 IQ [n, 2] and its instantaneous frequency), which
    phase 21 reads again."""
    import torch

    from comms_tpu_torch.kernels import fm_chain as K
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.runtime import StreamRunner

    taps = fm.FM_LPF_TAPS
    n_total = 3 * BLOCK + RAGGED
    t0 = time.perf_counter()
    iq, w = synth_capture(n_total, seed=0)
    print(f"capture: {n_total} samples in {time.perf_counter() - t0:.1f} s")

    def planes(a, b):
        x = torch.from_numpy(iq[a:b]).to(dev)
        return x[:, 0].contiguous(), x[:, 1].contiguous()

    # ---- 3. FM kernel vs plain
    L0 = K.launches
    re0, im0 = planes(0, BLOCK)
    re1, im1 = planes(BLOCK, 2 * BLOCK)
    ctx_mid = fm.fused_ctx_from_raw_tail(re0, im0)
    errs = {}
    for name, (re, im, ctx) in {
            "zero_ctx": (re0, im0, K.zero_ctx(dev)),
            "mid_stream_ctx": (re1, im1, ctx_mid)}.items():
        got = K.fm_chain_fused(re, im, ctx, taps, taps)
        want = K.fm_chain_plain(re, im, ctx, taps, taps)
        torch.cuda.synchronize()
        if got.shape != (BLOCK // 25,) or not torch.isfinite(got).all():
            fail(f"kernel output {name}: shape {tuple(got.shape)} or "
                 f"non-finite values")
        errs[name] = max_err(got, want)
    rng = np.random.default_rng(1)
    noise = torch.from_numpy(
        rng.integers(0, 256, size=(2, NOISE_N), dtype=np.uint8)).to(dev)
    for ctx in (K.zero_ctx(dev), ctx_mid):
        got = K.fm_chain_fused(noise[0], noise[1], ctx, taps, taps)
        want = K.fm_chain_plain(noise[0], noise[1], ctx, taps, taps)
        torch.cuda.synchronize()
        errs.setdefault("white_noise", 0.0)
        errs["white_noise"] = max(errs["white_noise"], max_err(got, want))
    print("kernel vs plain max abs err:", json.dumps(errs))
    if max(errs["zero_ctx"], errs["mid_stream_ctx"]) > TOL_KERNEL:
        fail(f"kernel disagrees with plain beyond {TOL_KERNEL}: {errs}")
    if errs["white_noise"] > TOL_NOISE:
        fail(f"kernel disagrees with plain on noise beyond {TOL_NOISE}")
    if K.launches - L0 != 4:
        fail(f"expected 4 launches in phase 3, counted {K.launches - L0}")
    max_abs_err = max(errs["zero_ctx"], errs["mid_stream_ctx"])

    # ---- 4. the FM main path: counts start at 0 here
    K.launches = 0
    cfg = fm.FmReceiverConfig(block=BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "capture.iq"
        iq.tofile(path)
        t0 = time.perf_counter()
        fused = fm.run_file(path, cfg, device=dev)
        fused_s = time.perf_counter() - t0
        if K.launches != 3:
            fail(f"run_file fused: {K.launches} kernel launches, expected 3")
        unfused = fm.run_file(path, cfg, fused=False, device="cuda")
        small = Path(tmp) / "small.iq"
        iq[:2 * fm.FUSED_BLOCK_QUANTUM + RAGGED].tofile(small)
        small_cfg = fm.FmReceiverConfig(block=fm.FUSED_BLOCK_QUANTUM)
        small_gpu = fm.run_file(small, small_cfg, device="cuda")
        small_cpu = fm.run_file(small, small_cfg, device="cpu")
    want_len = fm._tail_valid_out(cfg, n_total)
    for name, a in (("fused", fused), ("unfused", unfused)):
        if a.shape != (want_len,) or not np.isfinite(a).all():
            fail(f"run_file {name}: shape {a.shape}, want ({want_len},), "
                 f"or non-finite values")
    paths_err = float(np.abs(fused - unfused).max())
    small_err = float(np.abs(small_gpu - small_cpu).max())
    corr = demod_matches_tones(fused, w)
    print(f"run_file: {want_len} audio samples, fused {fused_s:.2f} s, "
          f"fused vs unfused {paths_err:.3g}, small capture card vs CPU "
          f"{small_err:.3g}, correlation with the modulating tones "
          f"{corr:.5f}")
    if paths_err > TOL_PATHS or small_err > TOL_PATHS:
        fail("run_file paths disagree")
    if corr < 0.99:
        fail(f"demodulated audio does not follow the tones: {corr}")
    if K.launches != 5:
        fail(f"run_file: {K.launches} launches, expected 5")

    fblock = fm.make_fused_block_fn(cfg)
    dev_blocks = [planes(b * BLOCK, (b + 1) * BLOCK) for b in range(3)]
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in dev_blocks]

    def serve(blocks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda s, x: fblock(s, *x), fm.fused_init_state(dev),
            (blocks[i % 3] for i in range(n)), sink=outs.append,
            samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
            device=dev)
        return runner.run().msps, np.concatenate(outs)

    rates, served = {}, {}
    for name, blocks in (("device", dev_blocks), ("pinned_host",
                                                  host_blocks)):
        serve(blocks, SERVE_WARMUP)   # fills the pinned-memory cache
        rates[name], served[name] = serve(blocks, SERVE_BLOCKS)
    print(f"serving Msps ({SERVE_BLOCKS} blocks of {BLOCK}, depth "
          f"{SERVE_DEPTH}, after {SERVE_WARMUP} warm-up blocks):",
          json.dumps(rates))
    if not np.array_equal(served["device"], served["pinned_host"]):
        fail("serving from device and from pinned host blocks differ")
    head = served["device"][:3 * (BLOCK // 25)]
    if float(np.abs(head - fused[:head.shape[0]]).max()) > 1e-6:
        fail("served blocks differ from run_file's blocks")

    entry = fm.FmReceiverConfig(block=ENTRY_BLOCK)
    if entry.polyphase:
        fail("the entry config must take the dense path")
    outs = {}
    for d in ("cuda", "cpu"):
        blk = fm.make_block_fn(entry)
        st = fm.init_state(entry, d)
        res = []
        for b in range(2):
            xb = torch.from_numpy(iq[b * ENTRY_BLOCK:(b + 1) * ENTRY_BLOCK])
            a, st = blk(st, xb.to(d))
            res.append(a.cpu().numpy())
        outs[d] = np.concatenate(res)
    dense_err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    print(f"entry config (dense, 2 x {ENTRY_BLOCK}): card vs CPU "
          f"{dense_err:.3g}")
    if dense_err > TOL_DENSE or outs["cuda"].shape != (
            2 * entry.audio_per_block,):
        fail("dense entry path disagrees between the card and the CPU")
    main_launches = K.launches
    expected = 5 + 2 * (SERVE_WARMUP + SERVE_BLOCKS)
    if main_launches != expected:
        fail(f"main path launched the kernel {main_launches} times, "
             f"expected {expected}")

    # ---- 7. times at the full block, and where a served block's device
    # time goes
    profile_served(lambda: serve(dev_blocks, SERVE_BLOCKS), card,
                   f"{SERVE_BLOCKS} served FM blocks (device-resident)")
    ms = cuda_ms(lambda: K.fm_chain_fused(re1, im1, ctx_mid, taps, taps))
    plain_ms = cuda_ms(lambda: K.fm_chain_plain(re1, im1, ctx_mid, taps,
                                                taps))
    print(f"fm_chain at N={BLOCK} on {card}: kernel {ms:.4f} ms "
          f"({BLOCK / ms / 1e6:.2f} Gsps), plain {plain_ms:.4f} ms")

    # Bytes: the u8 planes in, the audio out.  Operations: stage 1 (63
    # real taps on complex samples at the N/5 outputs it keeps), the demod
    # (conjugate product and degree-15 atan2, ~46 flops) and stage 2.
    nbytes = 2 * BLOCK + 4 * (BLOCK // 25)
    flops = (BLOCK // 5) * (4 * 63 + 46) + (BLOCK // 25) * 2 * 63
    row = kernel_row("fm_chain_fused", "fm_chain.cu",
                     "comms_tpu/kernels/fm_chain_pallas.py:385",
                     main_launches, max_abs_err, ms, plain_ms, nbytes,
                     flops)
    return row, iq, w


def build_native() -> None:
    """Build (or load) the native block reader with g++ and print its
    path and seconds.  ``run_file`` reads through it from phase 4 on, so
    a failed build fails the run: no quiet fallback to numpy reads."""
    from comms_tpu_torch import native
    from comms_tpu_torch.native import loader

    built = not loader.library_path().exists()
    t0 = time.perf_counter()
    if not native.native_available():
        fail(f"the native reader does not build: {loader._build_error}")
    print(f"native reader: {loader.library_path()} "
          f"{'built' if built else 'loaded'} in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(g++ {' '.join(loader.CXX_FLAGS)})")


def print_ptxas_report(build) -> None:
    """Registers and spills over the built kernel functions."""
    import re

    log = Path(f"{build.library_path()}.log")
    if not log.exists():
        print("ptxas: no report (the library was built before this run)")
        return
    text = log.read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                           text))
    print(f"ptxas: {len(regs)} kernel functions, {min(regs)}-{max(regs)} "
          f"registers per thread, {spill} bytes of spill stores")


def print_ptxas_kernels(build, names) -> None:
    """ptxas's registers, shared memory and spills of the kernels named
    in ``names`` (matched as the mangled name's length-prefixed part, so
    ``fir_kernel`` does not match ``decim_fir_kernel``)."""
    import re

    log = Path(f"{build.library_path()}.log")
    if not log.exists():
        return
    mangled = {f"{len(n)}{n}": n for n in names}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        elif current and "Used" in line and any(k in current
                                                for k in mangled):
            short = next(n for k, n in mangled.items() if k in current)
            ti = re.search(r"I((?:L[ib]\d+E)+)E", current)
            tmpl = "<" + ", ".join(
                v if k == "i" else ("true" if v == "1" else "false")
                for k, v in re.findall(r"L([ib])(\d+)E", ti.group(1))
            ) + ">" if ti else ""
            print(f"ptxas {short}{tmpl}: {line.split(':', 1)[1].strip()}")
            current = None


def station_capture(n: int, k: int, seed: int, dev):
    """f32 planes [n] on the card: one FM station at the centre of each
    of the k channels, station c carrying a tone at 0.01 + 0.04*c/(k-1)
    of the channel rate with a deviation of 0.25 of the channel spacing
    (the JAX package's tests/test_band_monitor_pallas.py:126-141), the
    sum scaled by 1/k, plus Gaussian noise of sigma 0.01.  Every phase
    step per channel frame stays within about +-pi/2.  Returns (re, im,
    tones in cycles per channel frame)."""
    import torch

    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.arange(n, **f64)
    re = torch.zeros(n, **f64)
    im = torch.zeros(n, **f64)
    tones = []
    for c in range(k):
        fa = 0.01 + 0.04 * c / (k - 1)
        tones.append(fa)
        ph = (2 * np.pi * c / k) * t + (2 * np.pi * 0.25 / k) * torch.cumsum(
            torch.sin((2 * np.pi * fa / k) * t), 0)
        re += torch.cos(ph)
        im += torch.sin(ph)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    re = re / k + 0.01 * torch.randn(n, generator=g, **f64)
    im = im / k + 0.01 * torch.randn(n, generator=g, **f64)
    return re.float(), im.float(), tones


def rel_err(got, want) -> float:
    return max_err(got, want) / float(want.abs().max().item())


def channelize_f64(re, im, prototype, ctx_re, ctx_im, k: int):
    """K8's function in float64 on the same float32 planes, context and
    taps (the kernel's float32 branch matrix C [M, K]): V[m, c] =
    sum_k C[k-1, c] x[(m-k)K + c + 1], the branches relabelled (U[:, n] =
    V[:, n-1 mod K]) and Y = FFT(U).  Returns (yr, yi) float64."""
    import torch

    from comms_tpu_torch.kernels import channelizer as CK

    C = torch.from_numpy(CK.branch_matrix(np.asarray(prototype, np.float64),
                                          k).astype(np.float64)).to(re.device)
    M = C.shape[0]
    t = M * k - 1
    x = torch.complex(torch.cat([ctx_re[-t:], re]).double(),
                      torch.cat([ctx_im[-t:], im]).double())
    frames = re.shape[0] // k
    R = x[:(frames + M - 1) * k].reshape(frames + M - 1, k)
    V = C[M - 1] * R[:frames]
    for kk in range(M - 1, 0, -1):
        V += C[kk - 1] * R[M - kk:M - kk + frames]
    Y = torch.fft.fft(torch.roll(V, 1, dims=1), dim=1)
    return Y.real, Y.imag


def bin_err(got, want) -> float:
    """The largest error of any element relative to that element of
    ``want`` (a PSD's bins are all positive)."""
    return float(((got - want).abs() / want.abs()).max().item())


def tone_ratios(audio, tones, dec: int):
    """Per channel: the spectrum's value at the channel's tone over its
    median (audio [K, n] on the card, first 64 samples skipped)."""
    import torch

    a = audio[:, 64:].double()
    a = a - a.mean(dim=1, keepdim=True)
    w = torch.hann_window(a.shape[1], periodic=False, dtype=a.dtype,
                          device=a.device)
    X = torch.fft.rfft(a * w, dim=1).abs()
    f = torch.fft.rfftfreq(a.shape[1], 1.0, device=a.device)
    out = []
    for c, fa in enumerate(tones):
        b = int((f - fa * dec).abs().argmin())
        out.append(float(X[c, b] / X[c].median()))
    return out


def band_monitor_phases(dev, card: str) -> list:
    """Phases 5, 6 and the band-monitor part of 7; returns the kernel
    table rows of K8, K2, the K3 entry, K9 and the lag-1 demod."""
    import torch

    from comms_tpu_torch.kernels import band_monitor as BM
    from comms_tpu_torch.kernels import channelizer as CK
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.kernels import fm_chain as FK
    from comms_tpu_torch.kernels import lag1_demod as LD
    from comms_tpu_torch.models import channelizer as chm
    from comms_tpu_torch.models import fm_band_monitor as bm
    from comms_tpu_torch.runtime import StreamRunner

    # Plain-version calls, counted so that the main path can show none.
    plain_calls = [0]

    def counting(fn):
        def wrapped(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    for mod in (CK, DF, BM, LD):
        mod._plain = counting(mod._plain)

    t0 = time.perf_counter()
    re16, im16, tones16 = station_capture(3 * BM_BLOCK, BM_K, 1, dev)
    re64, im64, _ = station_capture(2 * BM_BLOCK, BM_K64, 2, dev)
    torch.cuda.synchronize()
    print(f"station captures: 3 x {BM_BLOCK} (K={BM_K}) and 2 x "
          f"{BM_BLOCK} (K={BM_K64}) in {time.perf_counter() - t0:.1f} s")

    def blk(x, b):
        return x[b * BM_BLOCK:(b + 1) * BM_BLOCK]

    cfg = bm.BandMonitorConfig(num_channels=BM_K, block=BM_BLOCK)
    cfg64 = bm.BandMonitorConfig(num_channels=BM_K64, block=BM_BLOCK)
    errs = {}

    # ---- 5a. channelizer kernel vs plain (K=64 BASELINE and K=16), and
    # both against a float64 channelizer of the same inputs
    f64_errs = {}
    for k, re, im in ((BM_K64, re64, im64), (BM_K, re16, im16)):
        h = (cfg64 if k == BM_K64 else cfg).prototype
        zc = torch.zeros(CK.CTX_SAMPLES, device=dev)
        for name, b, cr, ci in (
                ("zero_ctx", 0, zc, zc),
                ("mid_stream_ctx", 1, blk(re, 0)[-CK.CTX_SAMPLES:],
                 blk(im, 0)[-CK.CTX_SAMPLES:])):
            got = CK.channelize_planar(blk(re, b), blk(im, b), h, cr, ci, k)
            want = CK.channelize_plain(blk(re, b), blk(im, b), h, cr, ci, k)
            f64 = channelize_f64(blk(re, b), blk(im, b), h, cr, ci, k)
            torch.cuda.synchronize()
            for g, w, d in zip(got[:2], want[:2], f64):
                if g.shape != (BM_BLOCK // k, k) or not torch.isfinite(
                        g).all():
                    fail(f"channelizer K={k} {name}: shape "
                         f"{tuple(g.shape)} or non-finite values")
                e = rel_err(g, w)
                if e > TOL_CHAN:
                    fail(f"channelizer K={k} {name}: {e} > {TOL_CHAN}")
                errs[f"channelize_K{k}_{name}"] = max(
                    errs.get(f"channelize_K{k}_{name}", (0.0, 0.0)),
                    (max_err(g, w), e))
                ek, ep = f64_errs.get(f"K{k}_{name}", (0.0, 0.0))
                f64_errs[f"K{k}_{name}"] = (
                    max(ek, rel_err(g.double(), d)),
                    max(ep, rel_err(w.double(), d)))
            del f64
    print("channelizer vs a float64 channelizer (relative to the largest "
          "output; kernel, plain):", json.dumps(f64_errs))

    # ---- 5b. decimating FIR at the staged audio stage's shapes, and
    # the poly-FIR entry at dec 5 with 63 and 641 taps
    rng = np.random.default_rng(3)
    rows, n_ch = BM_K // 2, BM_BLOCK // BM_K
    W = cfg.audio_dec * 128
    tile = bm._audio_tile_rows(cfg)

    def dev_normal(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)

    dr, di = dev_normal(rows, n_ch), dev_normal(rows, n_ch)
    fcr, fci = dev_normal(rows, W), dev_normal(rows, W)
    got = DF.fir_decimate_planar(dr, di, cfg.audio_taps, cfg.audio_dec,
                                 fcr, fci, tile_rows=tile)
    want = DF.fir_decimate_plain(dr, di, cfg.audio_taps, cfg.audio_dec,
                                 fcr, fci)
    torch.cuda.synchronize()
    g, w = torch.complex(got[0], got[1]), torch.complex(*want)
    errs["fir_decimate_staged"] = (max_err(g, w), rel_err(g, w))
    # chopped at an odd multiple of the quantum, through the carried
    # context: the one-shot call's bits
    cut = 3 * tile * W
    a = DF.fir_decimate_planar(dr[:, :cut].contiguous(),
                               di[:, :cut].contiguous(), cfg.audio_taps,
                               cfg.audio_dec, fcr, fci, tile_rows=tile)
    b = DF.fir_decimate_planar(dr[:, cut:].contiguous(),
                               di[:, cut:].contiguous(), cfg.audio_taps,
                               cfg.audio_dec, a[2], a[3], tile_rows=tile)
    for k in range(2):
        if not torch.equal(torch.cat([a[k], b[k]], 1), got[k]):
            fail("decimating FIR: two chopped calls differ from one call "
                 "at the staged audio stage's shape")
    print(f"decimating FIR chopped at {cut} of {n_ch} samples a row: "
          f"bit-identical to one call")
    pr, pi = dev_normal(POLY_N), dev_normal(POLY_N)
    pcr = dev_normal(DF.CTX_ROWS * POLY_DEC * 128)
    pci = dev_normal(DF.CTX_ROWS * POLY_DEC * 128)
    poly_taps = {n: rng.normal(size=n) for n in (63, 641)}
    for n, h in poly_taps.items():
        got = DF.poly_fir_planar(pr, pi, h, pcr, pci, POLY_DEC)
        want = DF.fir_decimate_plain(pr, pi, h, POLY_DEC, pcr, pci)
        torch.cuda.synchronize()
        g, w = torch.complex(got[0], got[1]), torch.complex(*want)
        errs[f"poly_fir_{n}_taps"] = (max_err(g, w), rel_err(g, w))
    for name in ("fir_decimate_staged", "poly_fir_63_taps",
                 "poly_fir_641_taps"):
        if not errs[name][1] <= TOL_FIR:
            fail(f"{name}: {errs[name]} beyond {TOL_FIR}")

    # ---- 5b'. the staged demod at bm64_staged's shape (409,600 frames of
    # 64 channels) from mid-stream, both atan2s: d within TOL_DEMOD rad of
    # plain, the next prev exact
    yr64, yi64 = dev_normal(LD_FRAMES, BM_K64), dev_normal(LD_FRAMES, BM_K64)
    prev64 = dev_normal(BM_K64, 2)
    for fast in (True, False):
        got = LD.lag1_demod(yr64, yi64, prev64, fast=fast)
        want = LD.lag1_demod_plain(yr64, yi64, prev64, fast=fast)
        torch.cuda.synchronize()
        e = max_err(got[0], want[0])
        errs[f"lag1_demod_{'poly' if fast else 'atan2f'}"] = (
            e, e / float(want[0].abs().max()))
        if not (e <= TOL_DEMOD and torch.equal(got[1], want[1])):
            fail(f"lag1 demod (fast={fast}): d {e} rad from plain, next "
                 f"prev equal: {torch.equal(got[1], want[1])}")

    # ---- 5c. fused band monitor vs plain on the station captures, from
    # zero and mid-stream state, then on white noise
    for c, re, im in ((cfg, re16, im16), (cfg64, re64, im64)):
        args = (c.prototype, c.audio_taps, c.audio_dec)
        st = bm.init_state_fused(c, dev)
        for name, b in (("zero_state", 0), ("mid_stream_state", 1)):
            got = BM.band_monitor_planar(blk(re, b), blk(im, b), *args, *st,
                                         num_channels=c.num_channels)
            want = BM.band_monitor_plain(blk(re, b), blk(im, b), *args,
                                         *st, num_channels=c.num_channels)
            torch.cuda.synchronize()
            if not torch.isfinite(got[0]).all():
                fail(f"band monitor K={c.num_channels} {name}: non-finite")
            e = rel_err(got[0], want[0])
            es = max(rel_err(got[3], want[3]), rel_err(got[4], want[4]))
            if e > TOL_BM or es > TOL_CHAN or not (
                    torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])):
                fail(f"band monitor K={c.num_channels} {name}: audio "
                     f"{e}, spectrum tail {es}")
            errs[f"band_monitor_K{c.num_channels}_{name}"] = (
                max_err(got[0], want[0]), e)
            st = got[1:]
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    for c in (cfg, cfg64):
        args = (c.prototype, c.audio_taps, c.audio_dec)
        sk = sp = bm.init_state_fused(c, dev)
        for _ in range(3):
            x = torch.randn(2, BM_NOISE, generator=g, device=dev)
            got = BM.band_monitor_planar(x[0], x[1], *args, *sk,
                                         num_channels=c.num_channels)
            want = BM.band_monitor_plain(x[0], x[1], *args, *sp,
                                         num_channels=c.num_channels)
            torch.cuda.synchronize()
            e = rel_err(got[0], want[0])
            if e > TOL_BM:
                fail(f"band monitor K={c.num_channels} white noise: {e}")
            key = f"band_monitor_K{c.num_channels}_white_noise"
            errs[key] = max(errs.get(key, (0.0, 0.0)),
                            (max_err(got[0], want[0]), e))
            sk, sp = got[1:], want[1:]
    print("band monitor kernels vs plain (max abs err, relative):",
          json.dumps(errs))

    # ---- 6. the band monitor main path: every count starts at 0 here
    CK.launches = DF.launches = BM.launches = FK.launches = 0
    LD.launches = 0
    plain_calls[0] = 0
    fblock = bm.make_fused_block_fn(cfg)
    dev_blocks = [(blk(re16, b), blk(im16, b)) for b in range(3)]
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in dev_blocks]

    def serve(blocks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda s, x: fblock(s, *x), bm.init_state_fused(cfg, dev),
            (blocks[i % 3] for i in range(n)), sink=outs.append,
            samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
            device=dev)
        return runner.run().msps, outs

    rates, served = {}, {}
    for name, blocks in (("device", dev_blocks),
                         ("pinned_host", host_blocks)):
        serve(blocks, SERVE_WARMUP)
        rates[name], served[name] = serve(blocks, SERVE_BLOCKS)
    print(f"band monitor serving Msps (K={BM_K}, {SERVE_BLOCKS} blocks of "
          f"{BM_BLOCK}, depth {SERVE_DEPTH}, after {SERVE_WARMUP} warm-up "
          f"blocks) on {card}:", json.dumps(rates))
    fused_counts = (BM.launches, CK.launches, DF.launches, plain_calls[0])
    if fused_counts != (2 * (SERVE_WARMUP + SERVE_BLOCKS), 0, 0, 0):
        fail(f"fused serving: (K9, K8, K2, plain) launches {fused_counts}")
    for a, b in zip(served["device"], served["pinned_host"]):
        if not np.array_equal(a, b):
            fail("serving from device and from pinned host blocks differ")
    if served["device"][0].shape != (BM_K, cfg.audio_per_channel):
        fail(f"served audio shape {served['device'][0].shape}")

    staged = bm.make_planar_block_fn(cfg)
    st = bm.init_state(cfg, dev)
    staged_out = []
    for r, i in dev_blocks:
        a, st = staged(st, r, i)
        staged_out.append(a)
    fused3 = torch.from_numpy(np.concatenate(served["device"][:3], 1)).to(
        dev)
    staged3 = torch.cat(staged_out, 1)
    e_paths = rel_err(fused3, staged3)
    ratios = tone_ratios(fused3, tones16, cfg.audio_dec)
    print(f"fused vs staged (3 blocks): {e_paths:.3g} relative; tone peak "
          f"over spectrum median per channel: "
          f"{json.dumps([round(r, 1) for r in ratios])}")
    if not e_paths <= TOL_BM:
        fail(f"fused and staged band monitor disagree: {e_paths}")
    if min(ratios) <= 10:
        fail(f"a channel's tone does not stand out: {ratios}")

    chcfg = chm.ChannelizerConfig(num_channels=BM_K64, block=BM_BLOCK)
    ch_k, ch_t = (chm.make_planar_block_fn(chcfg),
                  chm.make_planar_block_fn(chcfg, use_kernel=False))
    sk = st_ = chm.init_state(chcfg, dev)
    e_ch = 0.0
    for r, i in dev_blocks:
        (yr, yi), sk = ch_k(sk, r, i)
        (tr, ti), st_ = ch_t(st_, r, i)
        e_ch = max(e_ch, rel_err(yr, tr), rel_err(yi, ti))
        if not torch.equal(sk, st_) or not torch.isfinite(yr).all():
            fail("channelizer model: state or output wrong")
    print(f"channelizer model (K={BM_K64}, 3 blocks): kernel vs tensor "
          f"route {e_ch:.3g} relative")
    if not e_ch <= TOL_CHAN:
        fail(f"channelizer model routes disagree: {e_ch}")
    torch.cuda.synchronize()
    main_counts = {"band_monitor": BM.launches, "channelize": CK.launches,
                   "fir_decimate": DF.launches, "fm_chain": FK.launches,
                   "lag1_demod": LD.launches, "plain": plain_calls[0]}
    print("band monitor main path launches:", json.dumps(main_counts))
    want_counts = {"band_monitor": 2 * (SERVE_WARMUP + SERVE_BLOCKS),
                   "channelize": 6, "fir_decimate": 3, "fm_chain": 0,
                   "lag1_demod": 3, "plain": 0}
    if main_counts != want_counts:
        fail(f"main path launches {main_counts}, expected {want_counts}")

    # ---- 7. where a served block's device time goes (after the counts:
    # these blocks launch K9 again), then times at the main paths' shapes
    profile_served(lambda: serve(dev_blocks, SERVE_BLOCKS), card,
                   f"{SERVE_BLOCKS} served band-monitor blocks (K={BM_K}, "
                   f"device-resident)")

    # ... and the two K8 paths: the staged band monitor and the
    # 64-channel channelizer model, 3 device-resident blocks each
    def staged_blocks():
        s = bm.init_state(cfg, dev)
        for r, i in dev_blocks:
            _, s = staged(s, r, i)

    def channelizer_blocks():
        s = chm.init_state(chcfg, dev)
        for r, i in dev_blocks:
            _, s = ch_k(s, r, i)

    profile_served(staged_blocks, card, f"3 staged band-monitor blocks "
                   f"(K={BM_K}: K8, demod, K2)")
    profile_served(channelizer_blocks, card,
                   f"3 channelizer-model blocks (K={BM_K64})")
    mid64 = (blk(re64, 0)[-CK.CTX_SAMPLES:].clone(),
             blk(im64, 0)[-CK.CTX_SAMPLES:].clone())
    mid16 = (blk(re16, 0)[-CK.CTX_SAMPLES:].clone(),
             blk(im16, 0)[-CK.CTX_SAMPLES:].clone())
    bm_state = BM.band_monitor_planar(
        blk(re16, 0), blk(im16, 0), cfg.prototype, cfg.audio_taps,
        cfg.audio_dec, *bm.init_state_fused(cfg, dev), num_channels=BM_K)[1:]
    bm_args = (blk(re16, 1), blk(im16, 1), cfg.prototype, cfg.audio_taps,
               cfg.audio_dec, *bm_state)
    timed = {
        "channelize": (
            lambda: CK.channelize_planar(blk(re64, 1), blk(im64, 1),
                                         cfg64.prototype, *mid64, BM_K64),
            lambda: CK.channelize_plain(blk(re64, 1), blk(im64, 1),
                                        cfg64.prototype, *mid64, BM_K64),
            f"K={BM_K64}, N={BM_BLOCK}", BM_BLOCK),
        # K8 at the staged band monitor's K (half its main-path launches)
        "channelize_K16": (
            lambda: CK.channelize_planar(blk(re16, 1), blk(im16, 1),
                                         cfg.prototype, *mid16, BM_K),
            lambda: CK.channelize_plain(blk(re16, 1), blk(im16, 1),
                                        cfg.prototype, *mid16, BM_K),
            f"K={BM_K}, N={BM_BLOCK}", BM_BLOCK),
        "fir_decimate": (
            lambda: DF.fir_decimate_planar(dr, di, cfg.audio_taps,
                                           cfg.audio_dec, fcr, fci,
                                           tile_rows=tile),
            lambda: DF.fir_decimate_plain(dr, di, cfg.audio_taps,
                                          cfg.audio_dec, fcr, fci),
            f"{rows} rows x {n_ch}, dec {cfg.audio_dec}, "
            f"{cfg.audio_taps.shape[0]} taps", 2 * rows * n_ch),
        "poly_fir": (
            lambda: DF.poly_fir_planar(pr, pi, poly_taps[63], pcr, pci,
                                       POLY_DEC),
            lambda: DF.fir_decimate_plain(pr, pi, poly_taps[63], POLY_DEC,
                                          pcr, pci),
            f"N={POLY_N}, dec {POLY_DEC}, 63 taps", POLY_N),
        "poly_fir_641": (
            lambda: DF.poly_fir_planar(pr, pi, poly_taps[641], pcr, pci,
                                       POLY_DEC),
            lambda: DF.fir_decimate_plain(pr, pi, poly_taps[641], POLY_DEC,
                                          pcr, pci),
            f"N={POLY_N}, dec {POLY_DEC}, 641 taps", POLY_N),
        "band_monitor": (
            lambda: BM.band_monitor_planar(*bm_args, num_channels=BM_K),
            lambda: BM.band_monitor_plain(*bm_args, num_channels=BM_K),
            f"K={BM_K}, N={BM_BLOCK}", BM_BLOCK),
        "lag1_demod": (
            lambda: LD.lag1_demod(yr64, yi64, prev64),
            lambda: LD.lag1_demod_plain(yr64, yi64, prev64),
            f"K={BM_K64}, {LD_FRAMES} frames", BM_K64 * LD_FRAMES),
    }
    times = {}
    for name, (kern, plain, shape, n) in timed.items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        times[name] = (ms, plain_ms)
        print(f"{name} at {shape} on {card}: kernel {ms:.4f} ms "
              f"({n / ms / 1e6:.2f} Gsps), plain {plain_ms:.4f} ms")

    # The library yardstick of the two FIR entries: F.conv1d with the
    # stride of the decimation, on the same planes and contexts.
    T = cfg.audio_taps.shape[0]
    lib_dec = conv1d_ms(
        torch.cat([torch.cat([fcr[:, -(T - 1):], dr], 1),
                   torch.cat([fci[:, -(T - 1):], di], 1)]),
        cfg.audio_taps, cfg.audio_dec,
        want=torch.cat(DF.fir_decimate_planar(
            dr, di, cfg.audio_taps, cfg.audio_dec, fcr, fci,
            tile_rows=tile)[:2]))
    h63 = poly_taps[63]
    lib_poly = conv1d_ms(
        torch.stack([torch.cat([pcr[-62:], pr]), torch.cat([pci[-62:], pi])]),
        h63, POLY_DEC,
        want=torch.stack(DF.poly_fir_planar(pr, pi, h63, pcr, pci,
                                            POLY_DEC)[:2]))
    h641 = poly_taps[641]
    lib_641 = conv1d_ms(
        torch.stack([torch.cat([pcr[-640:], pr]),
                     torch.cat([pci[-640:], pi])]),
        h641, POLY_DEC,
        want=torch.stack(DF.poly_fir_planar(pr, pi, h641, pcr, pci,
                                            POLY_DEC)[:2]))
    print(f"library (F.conv1d) on {card}: fir_decimate {lib_dec:.4f} ms, "
          f"poly_fir {lib_poly:.4f} ms, poly_fir 641 taps {lib_641:.4f} ms")

    def worst(prefix):
        return max(v[0] for k, v in errs.items() if k.startswith(prefix))

    # Bytes and operations from the shapes (complex samples 8 bytes; real
    # taps on complex samples 4 flops a tap; the filterbank's K-point DFT
    # as an FFT, 5 K log2(K) flops per K samples; the demod ~46 flops a
    # channel sample).
    N, M16, M64 = BM_BLOCK, cfg.taps_per_branch, cfg64.taps_per_branch
    dec = cfg.audio_dec
    n_in = rows * n_ch
    table = [
        ("channelize", "channelizer.cu",
         "comms_tpu/kernels/channelizer_pallas.py:305",
         main_counts["channelize"], worst("channelize_"),
         16 * N, N * (4 * M64 + 5 * np.log2(BM_K64)), None),
        ("fir_decimate", "decim_fir.cu",
         "comms_tpu/kernels/decim_fir_pallas.py:262",
         main_counts["fir_decimate"], worst("fir_decimate_"),
         8 * n_in + 8 * n_in // dec, 4 * T * n_in // dec, lib_dec),
        # The poly-FIR entry launches the same kernel as fir_decimate;
        # its count is that kernel's.
        ("poly_fir", "decim_fir.cu",
         "comms_tpu/kernels/poly_fir_pallas.py:173",
         main_counts["fir_decimate"], worst("poly_fir_"),
         8 * POLY_N + 8 * POLY_N // POLY_DEC, 4 * 63 * POLY_N // POLY_DEC,
         lib_poly),
        # the same entry at 641 taps: bound by its FMAs
        ("poly_fir_641", "decim_fir.cu",
         "comms_tpu/kernels/poly_fir_pallas.py:173",
         main_counts["fir_decimate"], worst("poly_fir_641"),
         8 * POLY_N + 8 * POLY_N // POLY_DEC, 4 * 641 * POLY_N // POLY_DEC,
         lib_641),
        ("band_monitor", "band_monitor.cu",
         "comms_tpu/kernels/band_monitor_pallas.py:349",
         main_counts["band_monitor"], worst("band_monitor_"),
         8 * N + 4 * N // dec,
         N * (4 * M16 + 5 * np.log2(BM_K) + 46) + 2 * T * N // dec, None),
        # planes in, d out, prev in and out; 32 operations a sample
        # (benchmark/benchlib/demod_cost.py)
        ("lag1_demod", "lag1_demod.cu",
         "none: comms_tpu/models/fm_band_monitor.py _planar_core (jnp)",
         main_counts["lag1_demod"], worst("lag1_demod_"),
         4 * (3 * BM_K64 * LD_FRAMES + 4 * BM_K64),
         32 * BM_K64 * LD_FRAMES, None),
    ]
    return [kernel_row(name, f, rep, n, err, times[name][0],
                       times[name][1], nbytes, flops, lib)
            for name, f, rep, n, err, nbytes, flops, lib in table]


def qpsk_capture(dev, seed: int):
    """The QPSK capture: float32 planes [QPSK_N] on the card and the bits
    of one period (numpy uint8 [QPSK_PERIOD / 2]).  Random bits (numpy),
    the consecutive-bit-pair map, qpsk_tx's RRC pulse (sps 4, 32 taps,
    beta 0.25, not normalised: 1.41 rms, the level the JAX tests add
    their noise to) and a delay of QPSK_DELAY samples applied to one
    period circularly (float64 FFTs, no cuDNN), the period repeated, the
    carrier offset with its global phase, complex Gaussian noise."""
    import torch

    from comms_tpu_torch.ops import taps as ttaps

    f64 = dict(dtype=torch.float64, device=dev)
    L = QPSK_PERIOD
    bits = np.random.default_rng(seed).integers(0, 2, size=L // 2,
                                                dtype=np.uint8)
    b = torch.from_numpy(bits.astype(np.float64)).to(dev)
    up = torch.zeros(L, dtype=torch.complex128, device=dev)
    up[::4] = torch.complex(2.0 * b[0::2] - 1.0, 2.0 * b[1::2] - 1.0)
    h = np.real(ttaps.rrc_taps(32, 4.0, 0.25))
    hp = torch.zeros(L, **f64)
    hp[:32] = torch.from_numpy(h)
    k = torch.fft.fftfreq(L, **f64)
    base = torch.fft.ifft(torch.fft.fft(up) * torch.fft.fft(hp)
                          * torch.exp(-2j * np.pi * QPSK_DELAY * k))
    n = torch.arange(QPSK_N, **f64)
    x = base.repeat(QPSK_N // L) * torch.exp(1j * (QPSK_CFO * n
                                                   + QPSK_PHASE))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    noise = QPSK_NOISE * torch.randn(2, QPSK_N, generator=g, **f64)
    return ((x.real + noise[0]).float().contiguous(),
            (x.imag + noise[1]).float().contiguous(), bits)


def qpsk_bit_errors(sym, first: int, bits, rot: int, lag: int):
    """Bit errors of symbol planes ``sym`` [2, M] (on the card), whose
    symbol 0 is stream symbol ``first``, against the periodic reference
    bits: stream symbol g decides transmitted symbol g - lag after a
    rotation by j^rot."""
    import torch

    re, im = sym[0], sym[1]
    for _ in range(rot % 4):
        re, im = -im, re
    ref = torch.from_numpy(bits.reshape(-1, 2).astype(bool)).to(sym.device)
    idx = (torch.arange(sym.shape[1], device=sym.device) + first - lag) % (
        ref.shape[0])
    want = ref[idx]
    return int(((re > 0) != want[:, 0]).sum() + ((im > 0) != want[:, 1])
               .sum())


def qpsk_align(sym, first: int, bits):
    """``(rot, lag)`` of the best of the 4 rotations x symbol lags in
    [0, 16] on 1500 symbols from ``sym`` [2, M] (stream symbol ``first``
    at index 0), and its errors there."""
    from comms_tpu_torch.models import qpsk_rx as trx

    Ls = bits.shape[0] // 2
    head = sym[:, :4096].cpu().numpy()
    ref = bits.reshape(-1, 2)[(first + np.arange(4096)) % Ls].reshape(-1)
    (rot, lag), errs, _ = trx.resolve_ambiguity(head, ref, search=1500)
    return rot, lag, errs


def qpsk_phases(dev, card: str) -> list:
    """Phases 8-10; returns the kernel table rows of K4, K5's symbol
    kernel alone, K5's three entries and K11."""
    import torch

    from comms_tpu_torch.kernels import fir as FK
    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.kernels import panel_reduce as PR
    from comms_tpu_torch.kernels import qpsk_sym as QS
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.models import qpsk_rx_stream as tstream
    from comms_tpu_torch.ops import interp as tinterp
    from comms_tpu_torch.runtime import StreamRunner

    plain_calls = [0]

    def counting(fn):
        def wrapped(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    QS.qpsk_symbol_plain = counting(QS.qpsk_symbol_plain)
    QS.qpsk_panels_plain = counting(QS.qpsk_panels_plain)
    FK.fir_plain = counting(FK.fir_plain)
    PR.panel_reductions_plain = counting(PR.panel_reductions_plain)

    t0 = time.perf_counter()
    re, im, bits = qpsk_capture(dev, seed=7)
    torch.cuda.synchronize()
    print(f"QPSK capture: {QPSK_N} samples (period {QPSK_PERIOD}) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = trx.QpskRxConfig()
    hw = cfg.panel_hw
    errs = {}

    def rel(a, b):
        return max_err(a, b), rel_err(a, b)

    # ---- 8a. the FIR kernel: the matched filter (zero context) and 257
    # complex taps from a mid-stream context
    cz_r, cz_i = FK.planar_ctx_zero(dev)
    mid_r, mid_i = FK.planar_ctx_from_tail(im, re)
    rng = np.random.default_rng(8)
    taps257 = rng.normal(size=257) + 1j * rng.normal(size=257)
    fir_cases = {"fir_mf_32": (cfg.mf_taps, cz_r, cz_i),
                 "fir_257_complex": (taps257, mid_r.contiguous(),
                                     mid_i.contiguous())}
    for name, (h, cr, ci) in fir_cases.items():
        yr, yi, _, _ = FK.fir_planar(re, im, h, cr, ci)
        wr, wi = FK.fir_plain(re, im, h, cr, ci)
        torch.cuda.synchronize()
        g, w = torch.complex(yr, yi), torch.complex(wr, wi)
        if g.shape != (QPSK_N,) or not torch.isfinite(g).all():
            fail(f"{name}: shape {tuple(g.shape)} or non-finite values")
        errs[name] = rel(g, w)
        if errs[name][1] > TOL_FIR:
            fail(f"{name}: {errs[name]} beyond {TOL_FIR}")

    # ---- 8b. the symbol kernel's entries at full width
    w_est = torch.tensor(0.0101, device=dev)
    lag = torch.from_numpy(tinterp.lagrange_taps(0.3).astype(
        np.float32)).to(dev)
    shift2 = torch.tensor(-1, dtype=torch.int32, device=dev)
    phase0 = 0.31
    fr, fi = trx.modulated_taps(cfg, w_est, lag, shift2)
    ws = w_est * 4
    C = trx.fused_gemm_ctx_len(cfg)
    ctx_mid = (im[-C:].clone(), re[-C:].clone())
    panels_plain = QS.qpsk_panels_plain(re, im, hw)
    pscale = max(float(p.abs().max()) for p in panels_plain[:4])

    def panel_err(got):
        return max(max_err(g, w) for g, w in zip(got[:4], panels_plain[:4]))

    sym_plain = {}
    for name, ctx in (("zero_ctx", None), ("mid_stream_ctx", ctx_mid)):
        sr, si, pan = QS.qpsk_symbol_gemm(re, im, fr, fi, ws, phase0, ctx,
                                          panels_hw=hw)
        pr, pi = QS.qpsk_symbol_plain(re, im, fr, fi, ws, phase0, ctx)
        torch.cuda.synchronize()
        g, w = torch.complex(sr, si), torch.complex(pr, pi)
        sym_plain[name] = w
        if g.shape != (QPSK_N // 4,) or not torch.isfinite(g).all():
            fail(f"symbol kernel {name}: shape or non-finite values")
        errs[f"qpsk_symbol_gemm_{name}"] = rel(g, w)
        errs[f"qpsk_symbol_gemm_panels_{name}"] = (panel_err(pan),
                                                   panel_err(pan) / pscale)
    kr, ki, kpan = QS.qpsk_symbol_gemm_scalars(
        re, im, cfg.mf_taps, w_est, lag, shift2, phase0=phase0, ctx=ctx_mid,
        panels_hw=hw)
    torch.cuda.synchronize()
    errs["qpsk_symbol_gemm_scalars"] = rel(torch.complex(kr, ki),
                                           sym_plain["mid_stream_ctx"])
    errs["qpsk_symbol_gemm_scalars_panels"] = (panel_err(kpan),
                                               panel_err(kpan) / pscale)
    qp = QS.qpsk_panels(re, im, hw)
    again = QS.qpsk_panels(re, im, hw)
    torch.cuda.synchronize()
    errs["qpsk_panels"] = (panel_err(qp), panel_err(qp) / pscale)
    if not all(torch.equal(a, b) for a, b in zip(qp[:4], again[:4])):
        fail("the panels differ between two runs")
    if not all(torch.equal(a, b) for a, b in zip(qp[:4], kpan[:4])):
        fail("the panels of the panel entry and the _scalars entry differ")
    # the panels (3xTF32 on the tensor cores) against the panels of float64
    # copies of the planes, at three lengths: the error must not grow with
    # the rows summed faster than the float32 sums' own
    e64 = {}
    for n in PANEL_F64_N:
        got = qp if n == QPSK_N else QS.qpsk_panels(re[:n], im[:n], hw)
        ref = QS.qpsk_panels_plain(re[:n].double(), im[:n].double(), hw)
        f32 = panels_plain if n == QPSK_N else QS.qpsk_panels_plain(
            re[:n], im[:n], hw)
        scale = max(float(p.abs().max()) for p in ref[:4])
        e64[n] = {name: max(float((g.double() - r).abs().max())
                            for g, r in zip(pan[:4], ref[:4])) / scale
                  for name, pan in (("kernel", got), ("plain", f32))}
        del ref
    print("QPSK panels vs float64 panels (relative to the largest entry; "
          "plain = cuBLAS float32):", json.dumps(e64))
    if not all(v["kernel"] <= TOL_PANEL for v in e64.values()):
        fail(f"panels vs float64 beyond {TOL_PANEL}: {e64}")
    for k, (_, e) in errs.items():
        tol = TOL_PANEL if "panel" in k else (
            TOL_SYM if k.startswith("qpsk") else TOL_FIR)
        if not e <= tol:
            fail(f"{k}: {e} beyond {tol}")
    blk = QS.IN_PER_STEP
    routes = [trx._fused_symbol_gemm(
        trx.QpskRxConfig(use_kernel=uk), re[:blk], im[:blk], w_est, lag,
        shift2, ctx=ctx_mid, phase0=phase0) for uk in (None, False)]
    torch.cuda.synchronize()
    e_route = rel_err(torch.complex(*routes[0]), torch.complex(*routes[1]))
    if not e_route <= TOL_ROUTE:
        fail(f"symbol kernel route vs tensor route: {e_route}")

    # ---- 8c. the panel reductions on the capture's panels
    p13 = torch.zeros((256, 256), device=dev)
    p24 = torch.zeros((256, 256), device=dev)
    width = qp[4]["width"]
    p13[:128, :width], p13[128:, :width] = qp[0], qp[2]
    p24[:128, :width], p24[128:, :width] = -qp[1], -qp[3]
    red = PR.panel_reductions(p13, p24, hw)
    red_again = PR.panel_reductions(p13, p24, hw)
    red_plain = PR.panel_reductions_plain(p13, p24, hw)
    torch.cuda.synchronize()
    if not torch.equal(red, red_again):
        fail("panel reductions: two calls on the same panels differ")
    rows = [0, 1] + [8 + a for a in range(cfg.sps)]
    V = 2 * hw + 1
    errs["panel_reductions"] = rel(red[rows][:, :V], red_plain[rows][:, :V])
    gr, gi = cfg.timing.lag_sums_r2(qp)
    f_rot = float(torch.atan2(gi[hw - 1], gr[hw - 1]))
    f_model = float(trx._estimates_from_panels(cfg, qp)[0])
    print(f"panel reductions: row 2 {float(red[2, 0]):.7f} rad (plain "
          f"{float(red_plain[2, 0]):.7f}, angle of the r2-rotated v=-1 lag "
          f"sum {f_rot:.7f}; the receiver's f_est {f_model:.7f})")
    if not errs["panel_reductions"][1] <= TOL_REDUCE:
        fail(f"panel reductions: {errs['panel_reductions']}")
    if max(abs(float(red[2, 0]) - float(red_plain[2, 0])),
           abs(float(red[2, 0]) - f_rot)) > 1e-5:
        fail("panel reductions: row 2 is not the rotated v=-1 angle")
    print("QPSK kernels vs plain (max abs err, relative):", json.dumps(errs),
          f"kernel route vs tensor route {e_route:.3g}")

    # ---- 9a. the one-shot main paths: counts start at 0 here
    FK.launches = PR.launches = 0
    for k in QS.launches:
        QS.launches[k] = 0
    plain_calls[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sym, diag = trx.make_rx_fn_planar(cfg)(re, im)
    torch.cuda.synchronize()
    rx_s = time.perf_counter() - t0
    M = QPSK_N // 4
    rot, lag0, head_errs = qpsk_align(sym, 0, bits)
    lo, hi = lag0 + QPSK_MARGIN, M - QPSK_MARGIN
    ber = qpsk_bit_errors(sym[:, lo:hi], lo, bits, rot, lag0)
    sym_s, diag_s = trx._rx_core_staged(cfg, re, im)
    rot_s, lag_s, _ = qpsk_align(sym_s, 0, bits)
    ber_s = qpsk_bit_errors(sym_s[:, lo:hi], lo, bits, rot_s, lag_s)
    # the capture's timing estimate from the panel reductions' lag sums
    red_main = PR.panel_reductions(p13, p24, hw)
    t_k11 = cfg.timing.estimate_from_lag_sums(
        red_main[0, :V], red_main[1, :V], weights=cfg.wq2,
        lag_rot=diag["freq"])
    one_shot = {k: float(v) for k, v in diag.items()}
    staged = {k: float(v) for k, v in diag_s.items()}
    print(f"one-shot receiver ({QPSK_N} samples, {rx_s:.3f} s incl. the "
          f"first call's set-up): {json.dumps(one_shot)}; lag {lag0} rot "
          f"{rot}; {ber} bit errors over {2 * (hi - lo)} bits")
    print(f"staged core: {json.dumps(staged)}; {ber_s} bit errors; timing "
          f"from the panel reductions {float(t_k11):.6f}")
    if ber or ber_s or head_errs:
        fail(f"bit errors: one-shot {ber}, staged {ber_s}")
    if abs(one_shot["freq"] - QPSK_CFO) >= 0.01:
        fail(f"frequency estimate {one_shot['freq']}")
    if (one_shot["sym_phase"] != staged["sym_phase"]
            or abs(one_shot["freq"] - staged["freq"]) >= 2e-3
            or abs(one_shot["timing"] - staged["timing"]) >= 1e-2):
        fail("fused and staged cores disagree")
    if abs(float(t_k11) - one_shot["timing"]) > 1e-4:
        fail(f"timing from the panel reductions {float(t_k11)}")
    one_shot_counts = {"qpsk_panels": QS.launches["qpsk_panels"],
                       "qpsk_symbol_gemm": QS.launches["qpsk_symbol_gemm"],
                       "qpsk_symbol_gemm_scalars":
                           QS.launches["qpsk_symbol_gemm_scalars"],
                       "qpsk_symbols": QS.launches["qpsk_symbols"],
                       "fir_planar": FK.launches,
                       "panel_reductions": PR.launches,
                       "plain": plain_calls[0]}
    print("QPSK one-shot main path launches:", json.dumps(one_shot_counts))
    want = QPSK_ONE_SHOT_LAUNCHES
    if one_shot_counts != want:
        fail(f"one-shot launches {one_shot_counts}, expected {want}")

    # ---- 9b. serving: 8 gap-free blocks (block k is the capture turned by
    # the carrier's phase advance over k blocks); counts start at 0 here
    blocks = []
    for b in range(SERVE_BLOCKS):
        a = (QPSK_CFO * b * QPSK_N) % (2 * np.pi)
        c, s_ = float(np.cos(a)), float(np.sin(a))
        blocks.append(((re * c - im * s_).contiguous(),
                       (re * s_ + im * c).contiguous()))
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in blocks]
    step = tstream.make_stream_fused_fn(cfg)
    FK.launches = PR.launches = 0
    for k in QS.launches:
        QS.launches[k] = 0
    plain_calls[0] = 0

    def serve(blks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda st, x: step(st, *x), tstream.init_state_fast(cfg, dev),
            (blks[i] for i in range(n)), sink=outs.append,
            samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
            device=dev)
        return runner.run().msps, outs, runner.state

    rates, served, states = {}, {}, {}
    for name, blks in (("device", blocks), ("pinned_host", host_blocks)):
        serve(blks, SERVE_WARMUP)
        rates[name], served[name], states[name] = serve(blks, SERVE_BLOCKS)
    torch.cuda.synchronize()
    serve_counts = {"qpsk_symbol_gemm_scalars":
                    QS.launches["qpsk_symbol_gemm_scalars"],
                    "qpsk_symbol_gemm": QS.launches["qpsk_symbol_gemm"],
                    "qpsk_panels": QS.launches["qpsk_panels"],
                    "qpsk_symbols": QS.launches["qpsk_symbols"],
                    "plain": plain_calls[0]}
    print(f"QPSK serving Msps ({SERVE_BLOCKS} blocks of {QPSK_N}, depth "
          f"{SERVE_DEPTH}, after {SERVE_WARMUP} warm-up blocks) on {card}:",
          json.dumps(rates), "launches:", json.dumps(serve_counts))
    n_served = 2 * (SERVE_WARMUP + SERVE_BLOCKS)
    if serve_counts != {"qpsk_symbol_gemm_scalars": n_served,
                        "qpsk_symbol_gemm": 0, "qpsk_panels": 0,
                        "qpsk_symbols": n_served, "plain": 0}:
        fail(f"serving launches {serve_counts}")
    for a, b in zip(served["device"], served["pinned_host"]):
        if not np.array_equal(a, b):
            fail("serving from device and from pinned host blocks differ")
    # block 0 of a run is the warm-up block; then one lag for all seams
    stream_sym = torch.from_numpy(np.concatenate(served["device"][1:],
                                                 axis=1)).to(dev)
    rot_v, lag_v, _ = qpsk_align(stream_sym, M, bits)
    ber_v = qpsk_bit_errors(stream_sym, M, bits, rot_v, lag_v)
    print(f"served stream: lag {lag_v} rot {rot_v}; {ber_v} bit errors over "
          f"{2 * stream_sym.shape[1]} bits (blocks 1-{SERVE_BLOCKS - 1})")
    if ber_v:
        fail(f"served stream: {ber_v} bit errors")
    del stream_sym

    fast = tstream.make_stream_fast_fn(cfg)
    st_f = tstream.init_state_fast(cfg, dev)
    e_fast = 0.0
    for b, (r, i) in enumerate(blocks):
        y, st_f = fast(st_f, r, i)
        w = torch.from_numpy(served["device"][b]).to(dev)
        e_fast = max(e_fast, rel_err(y, w))
    # the state as the JAX test holds it: |a - b| <= tol + tol * |b|
    e_state = max(float(((st_f[k].double() - states["device"][k].double())
                         .abs() / (1.0 + states["device"][k].double()
                                   .abs())).max()) for k in st_f)
    print(f"fast vs fused stream step: symbols {e_fast:.3g} relative, state "
          f"{e_state:.3g}")
    if e_fast > TOL_STREAM_SYM or e_state > TOL_STREAM_STATE:
        fail("fast and fused stream steps disagree")

    st = states["device"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    for r, i in blocks[:2]:
        y, st = step(st, r, i)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("fused stream step: 2 blocks under set_sync_debug_mode('error')")

    # ---- 10. times at the main paths' shapes
    cz = FK.planar_ctx_zero(dev)
    c257 = fir_cases["fir_257_complex"]
    timed = {
        "fir_planar": (
            lambda: FK.fir_planar(re, im, cfg.mf_taps, *cz),
            lambda: FK.fir_plain(re, im, cfg.mf_taps, *cz),
            "32 real taps"),
        "fir_planar_257c": (
            lambda: FK.fir_planar(re, im, *c257),
            lambda: FK.fir_plain(re, im, *c257),
            "257 complex taps, mid-stream context"),
        "qpsk_symbol_gemm": (
            lambda: QS.qpsk_symbol_gemm(re, im, fr, fi, ws, phase0, ctx_mid,
                                        panels_hw=hw),
            lambda: (QS.qpsk_symbol_plain(re, im, fr, fi, ws, phase0,
                                          ctx_mid),
                     QS.qpsk_panels_plain(re, im, hw)),
            f"traced taps, panels hw {hw}"),
        "qpsk_symbol_gemm_scalars": (
            lambda: QS.qpsk_symbol_gemm_scalars(
                re, im, cfg.mf_taps, w_est, lag, shift2, phase0=phase0,
                ctx=ctx_mid, panels_hw=hw),
            lambda: (QS.qpsk_symbol_plain(
                re, im, *trx.modulated_taps(cfg, w_est, lag, shift2), ws,
                phase0, ctx_mid), QS.qpsk_panels_plain(re, im, hw)),
            f"taps from the estimates, panels hw {hw} (the served call)"),
        "qpsk_panels": (
            lambda: QS.qpsk_panels(re, im, hw),
            lambda: QS.qpsk_panels_plain(re, im, hw), f"hw {hw}"),
        "panel_reductions": (
            lambda: PR.panel_reductions(p13, p24, hw),
            lambda: PR.panel_reductions_plain(p13, p24, hw),
            f"[256, 256] x 2, hw {hw}"),
    }
    times = {}
    for name, (kern, plain, what) in timed.items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        times[name] = (ms, plain_ms)
        print(f"{name} at N={QPSK_N} ({what}) on {card}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    floor_ms = cuda_ms(lambda: HR.launch_floor(False, 1))
    print(f"launch floor (the empty kernel, 16-byte parameters, one block) "
          f"on {card}: {floor_ms:.4f} ms, beside panel_reductions' "
          f"{times['panel_reductions'][0]:.4f}")
    sym_ms = cuda_ms(lambda: QS.qpsk_symbol_gemm(re, im, fr, fi, ws, phase0,
                                                 ctx_mid))
    sym_plain_ms = cuda_ms(lambda: QS.qpsk_symbol_plain(re, im, fr, fi, ws,
                                                        phase0, ctx_mid))
    print(f"qpsk_symbol_gemm symbols only at N={QPSK_N} on {card}: kernel "
          f"{sym_ms:.4f} ms, plain {sym_plain_ms:.4f} ms")
    sym_scalars_ms = cuda_ms(lambda: QS.qpsk_symbol_gemm_scalars(
        re, im, cfg.mf_taps, w_est, lag, shift2, phase0=phase0, ctx=ctx_mid))
    print(f"qpsk_symbol_gemm_scalars symbols only at N={QPSK_N} on {card}: "
          f"kernel {sym_scalars_ms:.4f} ms (the traced entry's "
          f"{sym_ms:.4f}, the partition (threads, tiles, blocks) "
          f"{QS.partition(QPSK_N)})")
    qpsk_profile(step, st, blocks[2], card)

    lib_panels = packed_matmul_ms(re, im, hw, qp)
    print(f"library (packed torch.matmul, TF32 off) on {card}: qpsk_panels "
          f"{lib_panels:.4f} ms")
    T = cfg.mf_taps.shape[0]
    lib_fir = conv1d_ms(
        torch.nn.functional.pad(torch.stack([re, im]), (T - 1, 0)),
        cfg.mf_taps, 1,
        want=torch.stack(FK.fir_planar(re, im, cfg.mf_taps, *cz)[:2]))
    lib_fir257 = conv1d_ms(
        torch.stack([torch.cat([c257[1].reshape(-1)[-256:], re]),
                     torch.cat([c257[2].reshape(-1)[-256:], im])]),
        c257[0], 1, want=torch.stack(FK.fir_planar(re, im, *c257)[:2]))
    print(f"library (F.conv1d) on {card}: fir_planar {lib_fir:.4f} ms, "
          f"257 complex taps {lib_fir257:.4f} ms")

    def worst(prefix):
        return max(v[0] for k, v in errs.items() if k.startswith(prefix))

    launches = {k: one_shot_counts[k] + serve_counts.get(k, 0)
                for k in ("fir_planar", "qpsk_symbol_gemm",
                          "qpsk_symbol_gemm_scalars", "qpsk_panels",
                          "qpsk_symbols", "panel_reductions")}
    # the 257-tap row is the same kernel as fir_planar: its count
    launches["fir_planar_257c"] = launches["fir_planar"]
    # Bytes and operations from the shapes: complex taps on complex
    # samples 8 flops a tap at the N/4 symbols (CUDA cores); the four
    # panels 4w multiply-adds a sample (w = 128 + 2hw), in 3xTF32 on the
    # tensor cores; the reductions' 12 flops per panel entry they read.
    # The symbol kernel alone (its row, qpsk_symbols): the traced entry
    # without panels, its launches those of both symbol entries.
    N, MD, w = QPSK_N, int(fr.shape[0]), 128 + 2 * hw
    sym = (8 * N + 8 * N // 4, 2 * MD * N)
    pan = (8 * N, 8 * w * N)
    sym_err = max(errs[k][0] for k in ("qpsk_symbol_gemm_zero_ctx",
                                       "qpsk_symbol_gemm_mid_stream_ctx",
                                       "qpsk_symbol_gemm_scalars"))
    times["qpsk_symbols"] = (sym_ms, sym_plain_ms)
    table = [
        ("fir_planar", "decim_fir.cu",
         "comms_tpu/kernels/fir_pallas.py:253", worst("fir_"), 16 * N,
         4 * T * N, 0, lib_fir),
        # the same entry at 257 complex taps: bound by its FMAs
        ("fir_planar_257c", "decim_fir.cu",
         "comms_tpu/kernels/fir_pallas.py:253", errs["fir_257_complex"][0],
         16 * N, 8 * 257 * N, 0, lib_fir257),
        ("qpsk_symbols", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:643", sym_err, sym[0],
         sym[1], 0, None),
        ("qpsk_symbol_gemm", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:643",
         worst("qpsk_symbol_gemm_"), sym[0], sym[1], pan[1], None),
        ("qpsk_symbol_gemm_scalars", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:501",
         worst("qpsk_symbol_gemm_scalars"), sym[0], sym[1], pan[1], None),
        ("qpsk_panels", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:553", worst("qpsk_panels"),
         pan[0], 0, pan[1], lib_panels),
        ("panel_reductions", "panel_reduce.cu",
         "comms_tpu/kernels/panel_reduce_pallas.py:125",
         worst("panel_reductions"), 2 * 256 * 256 * 4 + 16 * 128 * 4,
         12 * (2 * hw + 1) * 128, 0, None),
    ]
    return [kernel_row(name, f, rep, launches[name], err, times[name][0],
                       times[name][1], nbytes, flops, lib, tc)
            for name, f, rep, err, nbytes, flops, tc, lib in table]


def packed_panel_operands(re, im, hw: int):
    """The panels as one product ``V.T @ W``: V [R, 256] (the planes as
    rows of 128, side by side, zero at or past N - hw) and W [R, 2w] (the
    Wr and Wi windows side by side), each packed; C = V.T @ W holds P1 =
    C[:128, :w], P2 = -C[:128, w:], P3 = C[128:, :w], P4 = -C[128:, w:]."""
    import torch

    n = re.shape[0]
    K, w = n - hw, 128 + 2 * hw
    R = -(-K // 128)
    pad = torch.nn.functional.pad
    V = torch.cat([pad(p[:K], (0, 128 * R - K)).view(R, 128)
                   for p in (re, im)], 1)
    W = torch.cat([pad(p, (hw, 128 * R + w - n - hw)).unfold(0, w, 128)[:R]
                   for p in (re, im)], 1).contiguous()
    return V, W


def packed_matmul_ms(re, im, hw: int, want) -> float:
    """The library yardstick of the panels: one ``torch.matmul`` (cuBLAS,
    TF32 off) of the operands of :func:`packed_panel_operands`, packed
    beforehand.  Prints its difference from the kernel's panels
    ``want``."""
    V, W = packed_panel_operands(re, im, hw)
    C = V.T @ W
    w = W.shape[1] // 2
    got = (C[:128, :w], -C[:128, w:], C[128:, :w], -C[128:, w:])
    scale = max(float(p.abs().max()) for p in want[:4])
    diff = max(max_err(g, k) for g, k in zip(got, want[:4])) / scale
    print(f"packed torch.matmul vs the panel kernel: {diff:.3g} relative")
    return cuda_ms(lambda: V.T @ W)


def busy_ms(ops, lo: float, hi: float) -> float:
    """Time in ms inside [lo, hi] (us) that at least one of the profiler's
    device events ``ops`` covers: overlaps counted once."""
    iv = sorted((max(k.time_range.start, lo), min(k.time_range.end, hi))
                for k in ops
                if k.time_range.end > lo and k.time_range.start < hi)
    total, end = 0.0, lo
    for s, e in iv:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def qpsk_profile(step, state, block, card: str) -> None:
    """``torch.profiler`` over one served block.  Device time of the
    symbol kernel (its three CUDA kernels, by name), and per stage of the
    step (its ``qpsk_stream.*`` ranges as the trace's device-side marks
    show them): the stage's device span and the kernel time inside it.
    Then the device's busy and idle time between the block's first and
    last kernel, and the host's time to enqueue the step (with and
    without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *block)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *block)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e for e in on_dev if e.name.startswith("qpsk_stream.")]
    kernels = [e for e in on_dev if not e.name.startswith("qpsk_stream.")
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"profile of one served block on {card}: the trace holds no "
              f"device time (not measured)")
        return

    lo = min(k.time_range.start for k in kernels)
    hi = max(k.time_range.end for k in kernels)
    busy = busy_ms(kernels, lo, hi)
    k5 = sum(k.time_range.elapsed_us() for k in kernels
             if "qpsk_sym_kernel" in k.name or "qpsk_panel_" in k.name) / 1e3
    stages = {m.name: {"device_span_ms": m.time_range.elapsed_us() / 1e3,
                       "kernel_ms": busy_ms(kernels, m.time_range.start,
                                            m.time_range.end)}
              for m in marks}
    for e in prof.events():
        if (e.name in stages
                and e.device_type == torch.autograd.DeviceType.CPU):
            stages[e.name]["host_ms"] = e.cpu_time_total / 1e3
    print(f"profile of one served block on {card}: {len(kernels)} device "
          f"operations, busy {busy:.4f} ms of a {(hi - lo) / 1e3:.4f} ms "
          f"span (idle {(hi - lo) / 1e3 - busy:.4f} ms); symbol kernel "
          f"{k5:.4f} ms; host enqueue {host_ms:.4f} ms under the profiler, "
          f"{float(np.median(enqueue)):.4f} ms without (median of 5); by "
          f"stage: {json.dumps(stages)}")


def tone_capture(n: int, seed: int, dev):
    """complex64 [n] on the card: tones at the bins SP_TONES of an
    SP_NFFT-point FFT (amplitudes 1, 0.5, 0.25; phases from integer
    indices mod SP_NFFT, in float64) plus complex Gaussian noise of sigma
    SP_NOISE per component."""
    import torch

    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.complex128, device=dev)
    for k, a in zip(SP_TONES, (1.0, 0.5, 0.25)):
        ph = (2 * np.pi / SP_NFFT) * torch.remainder(k * t, SP_NFFT)
        x += a * torch.exp(1j * ph)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    noise = SP_NOISE * torch.randn(2, n, generator=g, dtype=torch.float64,
                                   device=dev)
    return (x + torch.complex(noise[0], noise[1])).to(torch.complex64)


def profile_served(run, card: str, what: str) -> None:
    """``torch.profiler`` over ``run()`` (a served block): the device's
    busy time (kernels and copies, overlaps counted once) against the
    wall time, and the device time by operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not ops:
        print(f"profile of {what} on {card}: no device time in the trace "
              f"(not measured)")
        return
    busy = busy_ms(ops, min(e.time_range.start for e in ops),
                   max(e.time_range.end for e in ops))
    by = {}
    for e in ops:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name[5:] if name.startswith("void ") else name
        key = name.split("(")[0].split("<")[0].strip()[:40] or "(unnamed)"
        by[key] = by.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"profile of {what} on {card}: {len(ops)} device operations, "
          f"busy {busy:.4f} ms of {wall_us / 1e3:.4f} ms wall "
          f"({1e5 * busy / wall_us:.1f}% busy); device ms by operation: "
          f"{json.dumps({k: round(v, 4) for k, v in by.items()})}")


def spectrum_phases(dev, card: str) -> list:
    """Phases 11-14: FFT and Welch spectrum monitoring (K6, K7's two
    entries, K10's three stages); returns their kernel table rows."""
    import torch

    from comms_tpu_torch.kernels import fft as SK
    from comms_tpu_torch.kernels import fft_big as BK
    from comms_tpu_torch.ops import fft as tfft
    from comms_tpu_torch.ops import spectrum as tspec
    from comms_tpu_torch.runtime import StreamRunner

    t0 = time.perf_counter()
    caps = [tone_capture(SP_N, 30 + b, dev) for b in range(3)]
    torch.cuda.synchronize()
    print(f"tone captures: 3 x {SP_N} samples in "
          f"{time.perf_counter() - t0:.1f} s")
    x0 = caps[0]
    re, im = x0.real.contiguous(), x0.imag.contiguous()
    # The kernels are held to their plain versions on white noise, where
    # every bin carries comparable power: on the tone capture a tone bin
    # outweighs a noise bin by ~1e6, so an error relative to the largest
    # magnitude would not see the noise floor.  The tone capture is for
    # the content check and the main path.
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    nr, ni = torch.randn(2, SP_N, generator=g, device=dev)
    xn = torch.complex(nr, ni)
    errs = {}

    def check(key, err, tol):
        errs[key] = err
        if not err <= tol:
            fail(f"{key}: {err} beyond {tol}")

    def c128(r, i):
        return torch.complex(r.double(), i.double())

    # ---- 11a. K6 at 16,777,216 samples per size, scale 1/sqrt(n), against
    # a float64 oracle on a subset of rows and against the plain version;
    # the plane-swap step twice is an exact bin reversal
    abs_err = {}
    for n in SP_SIZES:
        rows = SP_N // n
        r2, i2 = nr.view(rows, n), ni.view(rows, n)
        s = 1.0 / np.sqrt(n)
        yr, yi = SK.fft_planar(r2, i2, n, scale=s)
        pr, pi = SK.fft_plain(r2, i2, s)
        idx = torch.tensor([0, 1, rows // 2, rows - 1], device=dev)
        oracle = torch.fft.fft(c128(r2[idx], i2[idx]), dim=1) * s
        y = torch.complex(yr, yi)
        check(f"fft_{n}_vs_float64", rel_err(y[idx].to(oracle.dtype),
                                             oracle), TOL_FFT)
        check(f"fft_{n}_vs_plain", rel_err(y, torch.complex(pr, pi)),
              TOL_FFT)
        abs_err[n] = max_err(y, torch.complex(pr, pi))
        ur, ui = SK.fft_planar(i2, r2, n, scale=s)
        ur2, ui2 = SK.fft_planar(ur, ui, n, scale=s)
        rev = torch.remainder(-torch.arange(n, device=dev), n)
        check(f"fft_{n}_involution", rel_err(torch.complex(ui2, ur2),
                                             torch.complex(r2, i2)[:, rev]),
              TOL_INVOLUTION)
        if not torch.isfinite(y).all():
            fail(f"FFT n={n}: non-finite output")
    del y, yr, yi, pr, pi, ur, ui, ur2, ui2
    # the 256-point spectrogram of the noise, kernel against tensor route
    S_k = tspec.spectrogram(xn, nperseg=256)
    S_t = tspec.spectrogram(xn, nperseg=256, use_kernel=False)
    if S_k.shape != (2 * SP_N // 256 - 1, 256):
        fail(f"spectrogram shape {tuple(S_k.shape)}")
    check("spectrogram_vs_tensor_route", rel_err(S_k, S_t), TOL_WELCH)
    abs_err["spectrogram"] = max_err(S_k, S_t)
    del S_k, S_t

    # ---- 11b. K7: the stream entry and the row entry (the stream's unfold
    # view) at N = 16,777,216 and every size, on the noise and per bin
    # (each bin's error relative to that bin), against the plain version
    # and float64; the two entries bit for bit; the row entry through
    # welch_psd; then the tones stand out
    for n in SP_SIZES:
        w = tspec.hann(n)
        acc = SK.psd_stream_planar(nr, ni, w, n)
        segs = (nr.unfold(0, n, n // 2), ni.unfold(0, n, n // 2))
        acc_rows = SK.psd_planar(*segs, w, n)
        want = SK.psd_stream_plain(nr, ni, w, n)
        f64 = SK.psd_stream_plain(nr.double(), ni.double(), w, n)
        for key, got in (("stream", acc), ("rows", acc_rows)):
            check(f"psd_{key}_{n}_vs_plain", bin_err(got, want), TOL_PSD)
            check(f"psd_{key}_{n}_vs_float64", bin_err(got.double(), f64),
                  TOL_PSD)
            if n == SP_NFFT:
                abs_err[f"psd_{key}"] = max_err(got, want)
        if not (torch.equal(acc, acc_rows) and torch.isfinite(acc).all()):
            fail(f"K7 at n={n}: the two entries differ or are not finite")
        del acc, acc_rows, want, f64
    w = tspec.hann(SP_NFFT)
    segs = (nr.unfold(0, SP_NFFT, SP_NFFT // 2),
            ni.unfold(0, SP_NFFT, SP_NFFT // 2))
    _, p_k = tspec.welch_psd(xn, nperseg=SP_NFFT)
    _, p_t = tspec.welch_psd(xn, nperseg=SP_NFFT, use_kernel=False)
    _, p_s = tspec.welch_psd_planar(nr, ni, nperseg=SP_NFFT)
    check("welch_kernel_vs_tensor_route", bin_err(p_k, p_t), TOL_WELCH)
    check("welch_planar_vs_welch", bin_err(p_s, p_k), TOL_WELCH)
    del p_t
    _, p_k = tspec.welch_psd(x0, nperseg=SP_NFFT)
    _, p_s = tspec.welch_psd_planar(re, im, nperseg=SP_NFFT)
    med = float(p_s.median())
    peaks = {}
    for k in SP_TONES:
        local = p_s[k - 8:k + 9]
        peaks[k] = (int(local.argmax()) - 8, float(p_s[k]) / med)
        if abs(peaks[k][0]) > 1 or peaks[k][1] <= 100:
            fail(f"tone at bin {k}: peak offset {peaks[k][0]}, "
                 f"{peaks[k][1]:.3g} x the median")
    print("tones (peak offset from the bin, PSD over the median):",
          json.dumps(peaks))

    # ---- 11c. K10: the wideband PSD (welch_numerator at 2^20 x 32 in the
    # three layouts, with means and with sparse demean), stage A, and
    # fft_large at 2^20 x 32 and 2^22 x 8 (n1 = n2 = 2048)
    big = {}
    for F, B in BIG:
        n1, n2 = BK.factorize(F)
        g = torch.Generator(device=dev)
        g.manual_seed(F + B)
        xb = torch.randn(2, B, F, generator=g, device=dev) + 0.05
        rb, ib = xb[0], xb[1]
        wF = torch.from_numpy(tspec.hann(F).astype(np.float32)).to(dev)
        means = torch.stack([rb.mean(1), ib.mean(1)], -1)
        big[F] = (rb, ib, wF, means, n1, n2)
        tag = f"{F}x{B}"
        layouts = {
            "flat": (rb, ib),
            "3d": (rb.view(B, n1, n2), ib.view(B, n1, n2)),
            "blocked": tuple(p.view(B, n1, n2 // 128, 128).permute(
                0, 2, 1, 3).contiguous() for p in (rb, ib))}
        nums = {k: BK.welch_numerator(r, i, wF) for k, (r, i) in
                layouts.items()}
        for k in ("3d", "blocked"):
            check(f"welch_numerator_{tag}_{k}_vs_flat",
                  rel_err(nums[k], nums["flat"]), TOL_LAYOUT)
        want = BK.psd_big_plain(rb, ib, n1, n2, wF, means)
        check(f"psd_big_{tag}_vs_plain", rel_err(nums["flat"], want),
              TOL_PSD)
        oracle = BK.psd_big_plain(rb.double(), ib.double(), n1, n2, wF,
                                  means.double())
        check(f"psd_big_{tag}_vs_float64",
              rel_err(nums["flat"].double(), oracle), TOL_PSD)
        abs_err[f"psd_big_{tag}"] = max_err(nums["flat"], want)
        sp = BK.psd_big_planar(rb, ib, n1, n2, window=tspec.hann(F),
                               sparse_demean=True)
        check(f"psd_big_{tag}_sparse_vs_plain",
              rel_err(sp, BK.psd_big_plain(rb, ib, n1, n2, tspec.hann(F),
                                           sparse_demean=True)), TOL_PSD)
        check(f"psd_big_{tag}_sparse_vs_means", rel_err(sp, nums["flat"]),
              TOL_PSD)
        dr, di, _ = BK.stage_a(rb, ib, n1, n2, wF, means)
        d = torch.complex(dr, di)
        d_plain = BK.stage_a_plain(rb, ib, n1, n2, wF, means)
        check(f"stage_a_{tag}_vs_plain", rel_err(d, d_plain), TOL_FFT)
        abs_err[f"stage_a_{tag}"] = max_err(d, d_plain)
        del nums, layouts, dr, di, d, d_plain
        y = tfft.fft_large(torch.complex(rb, ib))
        idx = torch.tensor([0, B - 1], device=dev)
        oracle = torch.fft.fft(c128(rb[idx], ib[idx]), dim=1)
        check(f"fft_large_{tag}_vs_float64",
              rel_err(y[idx].to(oracle.dtype), oracle), TOL_FFT)
        yp = torch.complex(*BK.fft_big_plain(rb, ib, n1, n2))
        check(f"fft_large_{tag}_vs_plain", rel_err(y, yp), TOL_FFT)
        abs_err[f"fft_big_{tag}"] = max_err(y, yp)
        del y, yp, oracle, xb
    print("spectrum kernels (relative to the largest magnitude; K7 and "
          "the Welch routes per bin):",
          json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))

    # ---- 12. the spectrum main path: every count starts at 0 here
    SK.launches.update(fft=0, psd=0, psd_stream=0)
    BK.launches.update(stage_a=0, psd_stage_b=0, fft_stage_b=0)
    dev_blocks = [(c.real.contiguous(), c.imag.contiguous()) for c in caps]
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in dev_blocks]

    def step(state, x):
        _, psd = tspec.welch_psd_planar(x[0], x[1], nperseg=SP_NFFT)
        return psd, state

    def serve(blocks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(step, None, (blocks[i % 3] for i in range(n)),
                              sink=outs.append,
                              samples_of=lambda x: x[0].shape[0],
                              depth=SERVE_DEPTH, device=dev)
        return runner.run().msps, outs

    rates, served = {}, {}
    for name, blocks in (("device", dev_blocks),
                         ("pinned_host", host_blocks)):
        serve(blocks, SERVE_WARMUP)
        rates[name], served[name] = serve(blocks, SERVE_BLOCKS)
    print(f"Welch serving Msps ({SERVE_BLOCKS} blocks of {SP_N}, "
          f"{SP_NFFT} bins, depth {SERVE_DEPTH}, after {SERVE_WARMUP} "
          f"warm-up blocks) on {card}:", json.dumps(rates))
    for a, b in zip(served["device"], served["pinned_host"]):
        if not np.array_equal(a, b):
            fail("Welch serving from device and pinned host blocks differ")
    if not np.array_equal(served["device"][0], p_s.cpu().numpy()):
        fail("a served Welch block differs from welch_psd_planar's")
    _, p_main = tspec.welch_psd(x0, nperseg=SP_NFFT)
    S_main = tspec.spectrogram(x0, nperseg=256)
    rb, ib, wF, means, n1, n2 = big[BIG[0][0]]
    F, B = BIG[0]
    _, p_big = tspec.welch_psd(torch.complex(rb, ib).reshape(-1),
                               nperseg=F, noverlap=0)
    y_big = tfft.fft_large(torch.complex(rb, ib))
    rb2, ib2 = big[BIG[1][0]][:2]
    y_big2 = tfft.fft_large(torch.complex(rb2, ib2))
    torch.cuda.synchronize()
    main_counts = {"fft": SK.launches["fft"], "psd": SK.launches["psd"],
                   "psd_stream": SK.launches["psd_stream"],
                   "stage_a": BK.launches["stage_a"],
                   "psd_stage_b": BK.launches["psd_stage_b"],
                   "fft_stage_b": BK.launches["fft_stage_b"]}
    print("spectrum main path launches:", json.dumps(main_counts))
    # the Welch of p_big: one stage A and one PSD stage B (a fixed plan of
    # launches); fft_large twice: a stage A and an FFT stage B each
    want_counts = {"fft": 1, "psd": 1,
                   "psd_stream": 2 * (SERVE_WARMUP + SERVE_BLOCKS),
                   "stage_a": 1 + 2, "psd_stage_b": BK.PSD_STAGE_B_LAUNCHES,
                   "fft_stage_b": 2}
    if main_counts != want_counts:
        fail(f"spectrum main path launches {main_counts}, expected "
             f"{want_counts}")
    if not (torch.equal(p_main, p_k) and torch.isfinite(S_main).all()
            and torch.isfinite(y_big).all() and torch.isfinite(y_big2).all()):
        fail("spectrum main path outputs differ from the checked ones")
    scale = 1.0 / float(np.sum(tspec.hann(F) ** 2)) / B
    check("welch_big_vs_plain",
          rel_err(p_big, BK.psd_big_plain(rb, ib, n1, n2, wF, means) * scale),
          TOL_PSD)
    del y_big, y_big2, S_main
    for name, blocks in (("device-resident", dev_blocks),
                         ("pinned host", host_blocks)):
        profile_served(lambda: serve(blocks, 1), card,
                       f"one served Welch block ({name})")
        profile_served(lambda: serve(blocks, SERVE_BLOCKS), card,
                       f"{SERVE_BLOCKS} served Welch blocks ({name})")

    # ---- 13. times at the main path's shapes
    def lg(v):
        return float(np.log2(v))

    r1k, i1k = re.view(SP_N // SP_NFFT, SP_NFFT), im.view(-1, SP_NFFT)
    z1k = torch.complex(r1k, i1k)
    s1k = 1.0 / np.sqrt(SP_NFFT)
    zb = torch.complex(rb, ib)
    times = {
        "fft_planar": (lambda: SK.fft_planar(r1k, i1k, SP_NFFT, scale=s1k),
                       lambda: SK.fft_plain(r1k, i1k, s1k),
                       lambda: torch.fft.fft(z1k)),
        "psd_stream_planar": (
            lambda: SK.psd_stream_planar(re, im, w, SP_NFFT),
            lambda: SK.psd_stream_plain(re, im, w, SP_NFFT), None),
        "psd_planar": (lambda: SK.psd_planar(*segs, w, SP_NFFT),
                       lambda: SK.psd_plain(*segs, w), None),
        "fft_big_stage_a": (
            lambda: BK.stage_a(rb, ib, n1, n2, wF, means),
            lambda: BK.stage_a_plain(rb, ib, n1, n2, wF, means), None),
        "psd_big": (
            lambda: BK.psd_big_planar(rb, ib, n1, n2, wF, means),
            lambda: BK.psd_big_plain(rb, ib, n1, n2, wF, means), None),
        "fft_big": (lambda: BK.fft_big_planar(rb, ib, n1, n2),
                    lambda: BK.fft_big_plain(rb, ib, n1, n2),
                    lambda: torch.fft.fft(zb)),
    }
    ms = {}
    for name, (kern, plain, lib) in times.items():
        ms[name] = (cuda_ms(kern), cuda_ms(plain),
                    cuda_ms(lib) if lib is not None else None)
        print(f"{name} on {card}: kernel {ms[name][0]:.4f} ms, plain "
              f"{ms[name][1]:.4f} ms, library "
              f"{'-' if lib is None else f'{ms[name][2]:.4f} ms'}")
    # K6 at every size beside its plain version, torch.fft.fft of a complex
    # tensor packed beforehand (the FFT alone, the library yardstick),
    # unscaled, and its bound: 16 bytes a sample, 5 log2(n) flops
    k6 = {}
    for n in SP_SIZES:
        rr, ii = nr.view(-1, n), ni.view(-1, n)
        z = torch.complex(rr, ii)
        k_ms = cuda_ms(lambda: SK.fft_planar(rr, ii, n))
        l_ms = cuda_ms(lambda: torch.fft.fft(z))
        b_ms = bound(16 * SP_N, 5 * SP_N * lg(n))[0]
        k6[n] = {"kernel_ms": k_ms,
                 "plain_ms": cuda_ms(lambda: SK.fft_plain(rr, ii)),
                 "torch_fft_ms": l_ms, "bound_ms": b_ms,
                 "kernel_over_torch_fft": k_ms / l_ms,
                 "bound_over_kernel": b_ms / k_ms}
        del z
    print(f"K6 at {SP_N} samples by row size on {card}:", json.dumps(k6))
    # K7 at every size: both entries beside the plain version, the FFT
    # alone on the same segments packed beforehand (torch.fft.fft: the
    # same transforms without window, demean and sums; a yardstick, not a
    # library call of K7's function) and the bound: 8 bytes a sample, the
    # FFTs and ~10 flops a transformed point
    k7 = {}
    for n in SP_SIZES:
        wn = tspec.hann(n)
        ur, ui = nr.unfold(0, n, n // 2), ni.unfold(0, n, n // 2)
        z = torch.complex(ur, ui).contiguous()
        s_ms = cuda_ms(lambda: SK.psd_stream_planar(nr, ni, wn, n))
        f_ms = cuda_ms(lambda: torch.fft.fft(z, dim=1))
        b_ms = bound(8 * SP_N + 8 * n,
                     ur.shape[0] * n * (5 * lg(n) + 10))[0]
        k7[n] = {"stream_ms": s_ms,
                 "rows_ms": cuda_ms(lambda: SK.psd_planar(ur, ui, wn, n)),
                 "plain_ms": cuda_ms(
                     lambda: SK.psd_stream_plain(nr, ni, wn, n)),
                 "fft_alone_ms": f_ms, "bound_ms": b_ms,
                 "stream_over_fft_alone": s_ms / f_ms,
                 "bound_over_stream": b_ms / s_ms}
        del z
    print(f"K7 at {SP_N} samples by segment size on {card}:",
          json.dumps(k7))
    extra = {}
    extra["welch_numerator_2^20x32"] = (
        cuda_ms(lambda: BK.welch_numerator(rb, ib, wF)), None)
    for k, (r, i) in {"3d": (rb.view(B, n1, n2), ib.view(B, n1, n2)),
                      "blocked": tuple(p.view(B, n1, n2 // 128, 128)
                                       .permute(0, 2, 1, 3).contiguous()
                                       for p in (rb, ib))}.items():
        extra[f"psd_big_{k}"] = (
            cuda_ms(lambda: BK.psd_big_planar(r, i, n1, n2, wF, means)),
            None)
    F2 = BIG[1][0]
    n12, n22 = BK.factorize(F2)
    zb2 = torch.complex(rb2, ib2)
    extra["fft_big_2^22x8"] = (
        cuda_ms(lambda: BK.fft_big_planar(rb2, ib2, n12, n22)),
        cuda_ms(lambda: torch.fft.fft(zb2)))
    # each entry's stage B alone, on a D made beforehand ((re, im) pairs)
    d1 = torch.stack(BK.stage_a(rb, ib, n1, n2, wF, means)[:2], -1)
    extra["fft_stage_b_2^20x32"] = (
        cuda_ms(lambda: BK.fft_stage_b(d1, n1, n2)), None)
    extra["psd_stage_b_2^20x32"] = (
        cuda_ms(lambda: BK.psd_stage_b(d1, n1, n2)), None)
    d2 = torch.stack(BK.stage_a(rb2, ib2, n12, n22)[:2], -1)
    extra["fft_stage_b_2^22x8"] = (
        cuda_ms(lambda: BK.fft_stage_b(d2, n12, n22)), None)
    del d1, d2
    for tag, (f_ms, b_ms), lib_ms in (
            ("2^20 x 32", (ms["fft_big"][0],
                           extra["fft_stage_b_2^20x32"][0]), ms["fft_big"][2]),
            ("2^22 x 8", (extra["fft_big_2^22x8"][0],
                          extra["fft_stage_b_2^22x8"][0]),
             extra["fft_big_2^22x8"][1])):
        print(f"K10 FFT entry at {tag} on {card}: kernel {f_ms:.4f} ms "
              f"(stage B alone {b_ms:.4f} ms), torch.fft.fft {lib_ms:.4f} "
              f"ms, {f_ms / lib_ms:.2f}x")
    extra["spectrogram_256"] = (cuda_ms(lambda: tspec.spectrogram(
        x0, nperseg=256)), cuda_ms(lambda: tspec.spectrogram(
            x0, nperseg=256, use_kernel=False)))
    print(f"more spectrum times on {card} (kernel ms, library or tensor "
          f"route ms):", json.dumps(extra))
    for route, kern in (("kernel", True), ("tensor", False)):
        profile_served(lambda: tspec.spectrogram(x0, nperseg=256,
                                                 use_kernel=kern), card,
                       f"the 256-point spectrogram ({route} route)")

    # ---- 14. kernel table rows: bytes and operations from the shapes
    # (complex samples 8 bytes; an n-point FFT 5 n log2(n) flops; the
    # window, demean, |.|^2 and sums ~10 flops a sample)

    nseg = 2 * SP_N // SP_NFFT - 1
    welch_flops = nseg * SP_NFFT * (5 * lg(SP_NFFT) + 10)
    N = F * B
    rows = [
        ("fft_planar", "fft.cu", "comms_tpu/kernels/fft_pallas.py:373",
         main_counts["fft"], max(abs_err[n] for n in SP_SIZES),
         16 * SP_N, SP_N * (5 * lg(SP_NFFT) + 1)),
        ("psd_planar", "psd.cu", "comms_tpu/kernels/fft_pallas.py:528",
         main_counts["psd"], abs_err["psd_rows"], 8 * SP_N + 8 * SP_NFFT,
         welch_flops),
        ("psd_stream_planar", "psd.cu",
         "comms_tpu/kernels/fft_pallas.py:672", main_counts["psd_stream"],
         abs_err["psd_stream"], 8 * SP_N + 8 * SP_NFFT, welch_flops),
        ("fft_big_stage_a", "fft_big.cu",
         "comms_tpu/kernels/fft_big_pallas.py:390", main_counts["stage_a"],
         abs_err[f"stage_a_{F}x{B}"], 16 * N + 4 * F,
         N * (5 * lg(n1) + 10)),
        ("psd_big", "fft_big.cu", "comms_tpu/kernels/fft_big_pallas.py:529",
         main_counts["psd_stage_b"], abs_err[f"psd_big_{F}x{B}"],
         8 * N + 8 * F, N * (5 * lg(F) + 10)),
        ("fft_big", "fft_big.cu", "comms_tpu/kernels/fft_big_pallas.py:606",
         main_counts["fft_stage_b"], abs_err[f"fft_big_{F}x{B}"], 16 * N,
         N * 5 * lg(F)),
    ]
    return [kernel_row(name, f, rep, n, err, ms[name][0], ms[name][1],
                       nbytes, flops, ms[name][2])
            for name, f, rep, n, err, nbytes, flops in rows]


def fm_u8_planes(n: int, seed: int, dev):
    """u8 planes [n] on the card of the FM capture of ``synth_capture``
    (the same modulating tones, amplitude 100 around 127.5, Gaussian noise
    of sigma 2), made with torch on the card from float64 phases: numpy
    takes seconds per capture of this size."""
    import torch

    t = torch.arange(n, dtype=torch.float64, device=dev)
    ph = torch.cumsum(fm_tones(t, torch.sin), 0)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    noise = torch.randn(2, n, generator=g, dtype=torch.float64, device=dev)
    re = torch.clamp(torch.round(100 * torch.cos(ph) + 127.5 + 2 * noise[0]),
                     0, 255).to(torch.uint8)
    im = torch.clamp(torch.round(100 * torch.sin(ph) + 127.5 + 2 * noise[1]),
                     0, 255).to(torch.uint8)
    return re, im


K12_SWEEP_LENGTHS = (1, 15, 16, 17, 4095, 25669, 1 << 20)


def k12_offset_sweep(HR, dev, gen) -> int:
    """K12 against its plain version byte for byte over a sweep: u8,
    float32 and complex64; every source byte offset 0..15 that the
    dtype's size allows; lengths of ``K12_SWEEP_LENGTHS`` elements (the
    last in bytes, 1 MiB); 2 rings of 4 shards whose tails start at
    offsets off, off + 5 es, ... (mod 16), each shard 16 bytes and its
    tail cut from a fresh byte buffer; wrapped and with contexts.
    Returns the number of calls."""
    import torch

    calls = 0
    for dtype in (torch.uint8, torch.float32, torch.complex64):
        es = torch.empty(0, dtype=dtype).element_size()
        for n in K12_SWEEP_LENGTHS:
            length = n if n < (1 << 20) else n // es
            for off in range(0, 16, es):
                def shard(o):
                    buf = torch.randint(0, 256, (32 + length * es,),
                                        generator=gen, device=dev,
                                        dtype=torch.uint8)
                    return buf[o:o + 16 + length * es].view(dtype)
                rings = [[shard((off + 5 * i * es) % 16) for i in range(4)]
                         for _ in range(2)]
                ctxs = [shard(0)[-length:] for _ in rings]
                for c in (None, ctxs):
                    got = HR.exchange(rings, length, c)
                    want = HR.exchange_plain(rings, length, c)
                    torch.cuda.synchronize()
                    calls += 1
                    for ga, wa in zip(got, want):
                        for a, b in zip(ga, wa):
                            if not torch.equal(a.view(torch.uint8),
                                               b.view(torch.uint8)):
                                fail(f"K12 sweep: {dtype} length {length} "
                                     f"offset {off}: kernel and plain "
                                     f"differ")
    return calls


def k12_host_us(HR, rings, halo: int, calls: int = 100) -> float:
    """The host's µs per call of K12's wrapper: ``time.perf_counter`` over
    ``calls`` unsynchronised calls after 20 warm-up calls."""
    import torch

    for _ in range(20):
        HR.exchange(rings, halo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        HR.exchange(rings, halo)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def sharded_phases(dev, card: str) -> list:
    """Phases 15-17: the sharded layer on an 8-shard mesh of the card; the
    kernel table row of K12."""
    import torch

    from comms_tpu_torch.kernels import band_monitor as BM
    from comms_tpu_torch.kernels import channelizer as CK
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.kernels import fft_big as BK
    from comms_tpu_torch.kernels import fm_chain as FK
    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.kernels import qpsk_sym as QS
    from comms_tpu_torch.models import fm_band_monitor as bm
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.ops import spectrum as tspec
    from comms_tpu_torch.parallel import dryrun
    from comms_tpu_torch.parallel import fused_wideband as fw
    from comms_tpu_torch.parallel import qpsk_rx_sharded as qs
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband as wb
    from comms_tpu_torch.parallel import wideband2d as w2
    from comms_tpu_torch.runtime import StreamRunner

    mesh = sh.time_mesh(SH_SHARDS, device=dev)
    mesh1 = sh.time_mesh(1, device=dev)
    per = BLOCK // SH_SHARDS
    g = torch.Generator(device=dev)
    g.manual_seed(41)

    # ---- 15. K12 against its plain version, bit for bit: the wrapped and
    # the ctx forms at the main paths' halos (complex64, float32, u8), the
    # 2-D column rings, several planes in one launch, a 1 MiB-per-shard
    # ring.  The inputs stand in for the paths' tails at their lengths.
    def ring(n, length, trailing=(), dtype=torch.float32, rings=1):
        shape = (length,) + tuple(trailing)
        if dtype == torch.uint8:
            return [[torch.randint(0, 256, shape, generator=g, device=dev,
                                   dtype=dtype) for _ in range(n)]
                    for _ in range(rings)]
        return [[torch.randn(shape, generator=g, device=dev).to(dtype)
                 for _ in range(n)] for _ in range(rings)]

    T = len(fm.FM_LPF_TAPS)
    cases = {
        # name: (rings, halo, ctx per ring or None)
        "iq_halo_c64": (ring(8, per, dtype=torch.complex64), T - 1, True),
        "yprev_c64": (ring(8, per, dtype=torch.complex64), 1, True),
        "fm_prev_c64": (ring(8, per // 5, dtype=torch.complex64), 1, True),
        "audio_halo_f32": (ring(8, per // 5), T - 1, True),
        "fused_raw_tails_u8": (ring(8, per, dtype=torch.uint8, rings=2),
                               fm.FUSED_TAIL_SAMPLES, False),
        "qpsk_ctx_f32": (ring(8, QPSK_N // 8, rings=2),
                         trx.fused_gemm_ctx_len(trx.QpskRxConfig()), True),
        "2d_chan_halo_f32": (ring(8, BM_BLOCK // 8, rings=2),
                             BM_K * 8 - 1, True),
        "2d_demod_rows_f32": (ring(2, BM_BLOCK // 2 // BM_K, (BM_K // 4,),
                                   rings=8), 1, True),
        "2d_audio_rows_f32": (ring(2, BM_BLOCK // 2 // BM_K, (BM_K // 4,),
                                   rings=4), 31, True),
        "ring_1MiB_f32": (ring(8, SH_RING_MIB // 4), SH_RING_MIB // 4,
                          False),
    }
    L0 = HR.launches
    k12_err = 0.0
    offsets = {}
    for name, (rings, halo, with_ctx) in cases.items():
        ctxs = ([torch.zeros_like(r[0][:halo]) + 0.5 for r in rings]
                if with_ctx else None)
        if with_ctx and rings[0][0].dtype == torch.uint8:
            ctxs = [c.to(torch.uint8) for c in ctxs]
        got = HR.exchange(rings, halo, ctxs)
        want = HR.exchange_plain(rings, halo, ctxs)
        torch.cuda.synchronize()
        offsets[name] = sorted({HR.source_offset(x[-halo:].data_ptr())
                                for r in rings for x in r})
        for ga, wa in zip(got, want):
            for a, b in zip(ga, wa):
                if not torch.equal(a, b):
                    fail(f"K12 {name}: kernel and plain differ")
                if a.is_floating_point() or a.is_complex():
                    k12_err = max(k12_err, max_err(a, b))
    if HR.launches - L0 != len(cases):
        fail(f"K12 checks: {HR.launches - L0} launches for {len(cases)} "
             f"calls")
    print(f"K12 kernel == plain bit for bit on {len(cases)} forms; the "
          f"sources' byte offsets in their 16-byte words: "
          f"{json.dumps(offsets)}")
    L0 = HR.launches
    n_sweep = k12_offset_sweep(HR, dev, g)
    if HR.launches - L0 != n_sweep:
        fail(f"K12 sweep: {HR.launches - L0} launches for {n_sweep} calls")
    print(f"K12 kernel == plain byte for byte over the sweep: {n_sweep} "
          f"calls (u8, float32, complex64; source offsets 0..15 by the "
          f"dtype's size; lengths {K12_SWEEP_LENGTHS[:-1]} elements and "
          f"1 MiB; wrapped and with contexts)")

    # ---- 16a. the sharded wideband chain at BLOCK (per shard BLOCK / 8):
    # within 1e-4 of the same chain on one shard, the rdma_halo build bit
    # for bit the default one, two blocks streamed.  Counts start here.
    counts = {}
    re_u8, im_u8 = fm_u8_planes(2 * BLOCK, 43, dev)
    pairs = torch.stack([re_u8, im_u8], -1).float().sub_(127.5).div_(127.5)
    cfg = wb.WidebandConfig(fm.FM_LPF_TAPS, block=BLOCK, dec1=5, dec2=5)
    steps = {"sharded": wb.make_sharded_step(cfg, mesh),
             "rdma_halo": wb.make_sharded_step(cfg, mesh, rdma_halo=True),
             "one_shard": wb.make_sharded_step(cfg, mesh1)}
    outs = {}
    HR.launches = 0
    for name, step in steps.items():
        st = wb.init_state(cfg, dev)
        res = []
        for b in range(2):
            (audio, freq), st = step(st, pairs[b * BLOCK:(b + 1) * BLOCK])
            res.append((audio, freq))
        outs[name] = (res, st)
    torch.cuda.synchronize()
    counts["wideband_chain"] = HR.launches
    if HR.launches != 2 * 2 * 4:
        fail(f"wideband chain: {HR.launches} K12 launches, expected 16 "
             f"(two sharded builds x two blocks x four rings)")
    e_chain, e_freq = 0.0, 0.0
    for (a, f), (a1, f1), (ar, fr) in zip(outs["sharded"][0],
                                          outs["one_shard"][0],
                                          outs["rdma_halo"][0]):
        if a.shape != (BLOCK // 25,) or not torch.isfinite(a).all():
            fail("wideband chain: audio shape or non-finite values")
        if not (torch.equal(a, ar) and torch.equal(f, fr)):
            fail("wideband chain: rdma_halo differs from the default")
        e_chain = max(e_chain, max_err(a, a1))
        e_freq = max(e_freq, abs(float(f) - float(f1)))
    e_state = max(max_err(x, y) for x, y in zip(outs["sharded"][1],
                                                 outs["one_shard"][1]))
    corr = demod_matches_tones(outs["sharded"][0][0][0].cpu().numpy(),
                               fm_tones(np.arange(BLOCK, dtype=np.float64)))
    print(f"wideband chain ({SH_SHARDS} x {per}, 2 blocks): vs one shard "
          f"audio {e_chain:.3g}, freq {e_freq:.3g}, state {e_state:.3g}; "
          f"rdma_halo bit-equal; tone correlation {corr:.5f}")
    if max(e_chain, e_freq, e_state) > TOL_SH_CHAIN or corr < 0.99:
        fail("the sharded wideband chain disagrees with one shard")
    del outs, pairs

    # ---- 16b. the sharded fused FM step at BLOCK: bit for bit a
    # sequential run of make_fused_block_fn over the 8 per-shard blocks;
    # served through StreamRunner beside the unsharded fused step.
    fstep = fw.make_sharded_fused_step(mesh, block=BLOCK)
    seq = fm.make_fused_block_fn(fm.FmReceiverConfig(block=per))
    FK.launches = HR.launches = 0
    a_sh, st_sh = fstep(fm.fused_init_state(dev), re_u8[:BLOCK],
                        im_u8[:BLOCK])
    a2_sh, st_sh = fstep(st_sh, re_u8[BLOCK:], im_u8[BLOCK:])
    torch.cuda.synchronize()
    step_counts = (FK.launches, HR.launches)
    st = fm.fused_init_state(dev)
    ref = []
    for b in range(2 * SH_SHARDS):
        a, st = seq(st, re_u8[b * per:(b + 1) * per],
                    im_u8[b * per:(b + 1) * per])
        ref.append(a)
    ref = torch.cat(ref)
    got = torch.cat([a_sh, a2_sh])
    n_diff = int((got != ref).sum())
    print(f"sharded fused FM (2 x {BLOCK}): {n_diff} of {got.numel()} audio "
          f"samples differ from the sequential per-shard blocks (max "
          f"{max_err(got, ref):.3g}); K1, K12 launches {step_counts}")
    if n_diff or not all(torch.equal(st_sh[k], st[k]) for k in st):
        fail("the sharded fused FM step is not bit-equal to the sequential "
             "blocks")
    if step_counts != (2 * SH_SHARDS, 2):
        fail(f"sharded fused FM: (K1, K12) launches {step_counts}")
    blocks = [(re_u8[:BLOCK], im_u8[:BLOCK]), (re_u8[BLOCK:], im_u8[BLOCK:])]
    unsharded = fm.make_fused_block_fn(fm.FmReceiverConfig(block=BLOCK))

    def serve(fn, n):
        sink = []
        torch.cuda.synchronize()
        runner = StreamRunner(lambda s, x: fn(s, *x), fm.fused_init_state(dev),
                              (blocks[i % 2] for i in range(n)),
                              sink=sink.append,
                              samples_of=lambda x: x[0].shape[0],
                              depth=SERVE_DEPTH, device=dev)
        return runner.run().msps, sink

    FK.launches = HR.launches = 0
    rates = {}
    for name, fn in (("sharded", fstep), ("unsharded", unsharded),
                     ("sharded_again", fstep)):
        serve(fn, SERVE_WARMUP)
        rates[name], served = serve(fn, SERVE_BLOCKS)
        if name == "sharded" and not np.array_equal(
                served[1], a2_sh.cpu().numpy()):
            fail("served sharded block differs from the step's")
    torch.cuda.synchronize()
    n_blk = SERVE_WARMUP + SERVE_BLOCKS
    serve_counts = (FK.launches, HR.launches)
    print(f"fused FM serving Msps ({SERVE_BLOCKS} blocks of {BLOCK}, depth "
          f"{SERVE_DEPTH}, after {SERVE_WARMUP} warm-up blocks) on {card}: "
          f"{json.dumps(rates)}; (K1, K12) launches {serve_counts}")
    if serve_counts != (2 * n_blk * SH_SHARDS + n_blk, 2 * n_blk):
        fail(f"fused FM serving: (K1, K12) launches {serve_counts}")
    counts["fused_fm"] = step_counts[1] + serve_counts[1]
    # where a sharded block's time goes: the host's enqueue of one step
    # and the device's busy share of one served block, beside unsharded
    enqueue = {}
    for name, fn in (("sharded", fstep), ("unsharded", unsharded)):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(fm.fused_init_state(dev), *blocks[0])
            ts.append((time.perf_counter() - t0) * 1e3)
        enqueue[name] = statistics.median(ts)
        profile_served(lambda: serve(fn, 1), card,
                       f"one served {name} fused FM block")
    print(f"host enqueue of one fused FM step (ms, median of 5) on {card}:",
          json.dumps(enqueue))
    del blocks, ref, got, re_u8, im_u8

    # ---- 16c. the band monitor at BM_BLOCK, K=16: the fused step per
    # shard (K9) against the one-device fused step, the 2-D (2 x 4) mesh
    # (K8 + K2 per shard) against the one-device staged step, two blocks
    re16, im16, _ = station_capture(2 * BM_BLOCK, BM_K, 44, dev)
    bcfg = bm.BandMonitorConfig(num_channels=BM_K, block=BM_BLOCK)
    bblocks = [(re16[b * BM_BLOCK:(b + 1) * BM_BLOCK],
                im16[b * BM_BLOCK:(b + 1) * BM_BLOCK]) for b in range(2)]
    one_f = bm.make_fused_block_fn(bcfg)
    one_s = bm.make_planar_block_fn(bcfg)
    st_f, st_s = bm.init_state_fused(bcfg, dev), bm.init_state(bcfg, dev)
    want_f, want_s = [], []
    for r, i in bblocks:
        a, st_f = one_f(st_f, r, i)
        want_f.append(a)
        a, st_s = one_s(st_s, r, i)
        want_s.append(a)
    torch.cuda.synchronize()
    bstep = fw.make_sharded_band_monitor_step(bcfg, mesh, block=BM_BLOCK)
    step2d = w2.make_sharded_band_monitor_2d(bcfg,
                                             w2.mesh_2d(2, 4, device=dev))
    pairs16 = torch.stack([re16, im16], -1)
    BM.launches = CK.launches = DF.launches = HR.launches = 0
    st_b = bm.init_state_fused(bcfg, dev)
    got_f = []
    for r, i in bblocks:
        a, st_b = bstep(st_b, r, i)
        got_f.append(a)
    torch.cuda.synchronize()
    fused_counts = (BM.launches, HR.launches)
    st2 = bm.init_state(bcfg, dev)
    got_2d = []
    BM.launches = CK.launches = DF.launches = HR.launches = 0
    for b in range(2):
        (a, power), st2 = step2d(st2, pairs16[b * BM_BLOCK:
                                             (b + 1) * BM_BLOCK])
        got_2d.append(a)
    torch.cuda.synchronize()
    counts_2d = (CK.launches, DF.launches, BM.launches, HR.launches)
    e_f = max(rel_err(g_, w_) for g_, w_ in zip(got_f, want_f))
    e_2d = max(max_err(g_, w_) for g_, w_ in zip(got_2d, want_s))
    e_2d_state = max(max_err(x, y) for x, y in zip(st2, st_s))
    print(f"band monitor K={BM_K}, 2 x {BM_BLOCK}: fused per shard vs one "
          f"device {e_f:.3g} relative, (K9, K12) launches {fused_counts}; "
          f"2-D 2x4 vs one-device staged {e_2d:.3g} (state "
          f"{e_2d_state:.3g}), (K8, K2, K9, K12) launches {counts_2d}")
    if not e_f <= TOL_BM or not max(e_2d, e_2d_state) <= TOL_SH_2D:
        fail("a sharded band monitor disagrees with the one-device path")
    if fused_counts != (2 * SH_SHARDS, 2):
        fail(f"sharded fused band monitor: (K9, K12) {fused_counts}")
    if counts_2d != (2 * SH_SHARDS, 2 * SH_SHARDS, 0, 2 * 3):
        fail(f"2-D band monitor: (K8, K2, K9, K12) launches {counts_2d}")
    if not torch.isfinite(power).all() or power.shape != (BM_K,):
        fail("2-D band monitor: power map")
    counts["band_monitor_fused"] = fused_counts[1]
    counts["band_monitor_2d"] = counts_2d[3]
    del re16, im16, pairs16, bblocks, want_f, want_s, got_f, got_2d

    # ---- 16d. the sharded QPSK receiver on the 2^25-sample capture: zero
    # bit errors, K5's panel and symbol entries per shard
    re, im, bits = qpsk_capture(dev, seed=7)
    qcfg = trx.QpskRxConfig()
    rx = qs.make_sharded_rx_step(qcfg, mesh)
    for k in QS.launches:
        QS.launches[k] = 0
    HR.launches = 0
    sym, diag = rx(re, im)
    torch.cuda.synchronize()
    q_counts = (QS.launches["qpsk_panels"],
                QS.launches["qpsk_symbol_gemm_scalars"],
                QS.launches["qpsk_symbols"], HR.launches)
    M = QPSK_N // 4
    rot, lag0, head_errs = qpsk_align(sym, 0, bits)
    lo, hi = lag0 + QPSK_MARGIN, M - QPSK_MARGIN
    ber = qpsk_bit_errors(sym[:, lo:hi], lo, bits, rot, lag0)
    d = {k: float(v) for k, v in diag.items()}
    print(f"sharded QPSK receiver ({SH_SHARDS} x {QPSK_N // SH_SHARDS}): "
          f"{json.dumps(d)}; lag {lag0} rot {rot}; {ber} bit errors over "
          f"{2 * (hi - lo)} bits; (K5 panels, K5 symbol entry, K5 symbol "
          f"kernel, K12) launches {q_counts}")
    if ber or head_errs or sym.shape != (2, M):
        fail(f"sharded QPSK receiver: {ber} bit errors")
    if abs(d["freq"] - QPSK_CFO) >= 0.01:
        fail(f"sharded QPSK frequency estimate {d['freq']}")
    if q_counts != (SH_SHARDS, SH_SHARDS, SH_SHARDS, 1):
        fail(f"sharded QPSK: (K5 panels, K5 symbol entry, K5 symbol "
             f"kernel, K12) {q_counts}")
    counts["qpsk_rx"] = q_counts[3]
    del re, im, sym

    # ---- 16e. the sharded PSDs at 2^20 x 32: frequency-sharded through
    # the dfft, segment-sharded through K10 per shard; per bin against
    # welch_psd
    F, B = BIG[0]
    xb = torch.randn(2, B, F, generator=g, device=dev) + 0.05
    x = torch.complex(xb[0], xb[1])
    _, want = tspec.welch_psd(x.reshape(-1), nperseg=F, noverlap=0)
    pairs_b = xb.permute(1, 2, 0).contiguous()            # [B, F, 2]
    BK.launches.update(stage_a=0, psd_stage_b=0, fft_stage_b=0)
    HR.launches = 0
    p_freq = wb.make_sharded_psd(F, mesh)(pairs_b)
    dfft_counts = dict(BK.launches)
    p_seg = wb.make_sharded_psd_segments(F, mesh)(pairs_b)
    torch.cuda.synchronize()
    seg_counts = {k: v - dfft_counts[k] for k, v in BK.launches.items()}
    e_psd = {"frequency_sharded_dfft": bin_err(p_freq, want),
             "segment_sharded_k10": bin_err(p_seg, want)}
    print(f"sharded PSDs at {F} x {B} vs welch_psd per bin: "
          f"{json.dumps(e_psd)}; K10 launches (dfft route, segment route) "
          f"{dfft_counts}, {seg_counts}; K12 {HR.launches}")
    if max(e_psd.values()) > TOL_PSD:
        fail(f"sharded PSDs beyond {TOL_PSD} per bin: {e_psd}")
    if (dfft_counts != {"stage_a": 0, "psd_stage_b": 0, "fft_stage_b": 0}
            or seg_counts != {"stage_a": SH_SHARDS,
                              "psd_stage_b": SH_SHARDS *
                              BK.PSD_STAGE_B_LAUNCHES, "fft_stage_b": 0}
            or HR.launches):
        fail("sharded PSDs: launch counts")
    del xb, x, pairs_b

    # ---- 17. the dry run of every sharded configuration, then K12's times
    HR.launches = 0
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(SH_SHARDS, device=dev)
    torch.cuda.synchronize()
    counts["dryrun"] = HR.launches
    print(f"dryrun_multichip({SH_SHARDS}) on {card}: OK in "
          f"{time.perf_counter() - t0:.1f} s, {HR.launches} K12 launches")
    # configs 1 (4 rings x 3 steps), 2 (2), 3 (the pulse shaper's halo,
    # 2 steps), 4 (1), 5 (2), 6 (2), 7 (1), 8 (4 rings x 2 steps: the pod
    # mesh in one process and the time mesh) and 9 (3 rings x 2 steps on
    # the 2 x 4 mesh)
    if HR.launches != 12 + 2 + 2 + 1 + 2 + 2 + 1 + 8 + 6:
        fail(f"dry run: {HR.launches} K12 launches, expected 36")
    print("K12 launches per sharded main path:", json.dumps(counts))

    times = {}
    lib = hasattr(torch, "_foreach_copy_")
    for name in ("fused_raw_tails_u8", "iq_halo_c64", "audio_halo_f32",
                 "2d_demod_rows_f32", "ring_1MiB_f32"):
        rings, halo, with_ctx = cases[name]
        srcs = [r[(i - 1) % len(r)][-halo:] for r in rings
                for i in range(len(r))]
        dsts = [torch.empty_like(s) for s in srcs]
        pairs_n = len(srcs)
        nbytes = srcs[0].numel() * srcs[0].element_size()
        times[name] = {
            "pairs": pairs_n, "bytes_each": nbytes,
            "ms": cuda_ms(lambda: HR.exchange(rings, halo)),
            "plain_ms": cuda_ms(lambda: HR.exchange_plain(rings, halo)),
            "library_ms": (cuda_ms(lambda: torch._foreach_copy_(dsts, srcs))
                           if lib else None),
            "bound_ms": bound(2 * pairs_n * nbytes, 0)[0]}
    print(f"K12 times on {card} (wrapped form):", json.dumps(times))
    # the launch floor: the empty kernel of csrc/halo_ring.cu with K12's
    # 2 KB parameter block and with a 16-byte one, at one block and at the
    # fused tails' grid (4 blocks a pair, 16 pairs)
    floor = {f"{'2KB' if big else '16B'}_{blocks}": cuda_ms(
        lambda: HR.launch_floor(big, blocks))
        for big in (True, False) for blocks in (1, 64)}
    print(f"launch floor on {card}, ms:", json.dumps(floor))
    rings_u8 = cases["fused_raw_tails_u8"][0]
    host = {"fused_raw_tails_u8 (16 pairs)": k12_host_us(
                HR, rings_u8, fm.FUSED_TAIL_SAMPLES),
            "iq_halo_c64 (8 pairs)": k12_host_us(
                HR, cases["iq_halo_c64"][0], T - 1)}
    print("K12 host us per call (100 unsynchronised calls):",
          json.dumps(host))
    row = times["fused_raw_tails_u8"]
    return [kernel_row("ring_halo_exchange", "halo_ring.cu",
                       "comms_tpu/kernels/halo_rdma.py:84",
                       sum(counts.values()), k12_err, row["ms"],
                       row["plain_ms"], 2 * row["pairs"] * row["bytes_each"],
                       0, row["library_ms"])]


def tx_oracle_card(bits, qpsk: bool, dphase: float = 0.0,
                   phase0: float = 0.0):
    """int16 pairs [N, 2] on the card: the reference transmit chain in
    float64 from ``bits`` (a tensor on the card): the symbol map (2b - 1;
    QPSK from consecutive bit pairs), zero-stuffing x4, the 32 RRC taps
    (sps 4, beta 0.25) as 32 shifted multiply-adds from a zero state, the
    mixer exp(j*(phase0 + n*dphase)), *8192, truncate and saturate."""
    import torch

    from comms_tpu_torch.ops import taps as ttaps

    b = bits.to(torch.float64)
    syms = (2 * b[0::2] - 1, 2 * b[1::2] - 1) if qpsk else (2 * b - 1,)
    n = 4 * syms[0].shape[0]
    h = np.real(ttaps.rrc_taps(32, 4.0, 0.25))
    ys = []
    for sym in syms:
        up = torch.zeros(n, dtype=torch.float64, device=b.device)
        up[::4] = sym
        y = torch.zeros_like(up)
        for k, hk in enumerate(h):
            y[k:] += float(hk) * up[:n - k]
        ys.append(y)
    yr = ys[0]
    yi = ys[1] if qpsk else torch.zeros_like(yr)
    if dphase:
        ph = phase0 + dphase * torch.arange(n, dtype=torch.float64,
                                            device=b.device)
        c, s_ = torch.cos(ph), torch.sin(ph)
        yr, yi = yr * c - yi * s_, yr * s_ + yi * c
    q = torch.stack([yr, yi], dim=-1) * 8192.0
    return torch.clamp(torch.trunc(q), -32768, 32767).to(torch.int16)


def tx_pairs(out):
    """int16 pairs [N, 2] of a transmit block's output on its device: the
    pair path's rows, or the fast path's int32 words viewed as two int16
    (little-endian: re in the low half)."""
    import torch

    if out.dtype == torch.int32:
        return out.view(torch.int16).reshape(-1, 2)
    return out


def lsb_diff_card(got, want):
    """(largest i16 difference, share of samples that differ)."""
    import torch

    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    return int(d.max()), float((d.amax(1) > 0).double().mean())


def transmit_phases(dev, card: str) -> None:
    """Phase 18: the BPSK and QPSK transmitters, both block paths."""
    import torch

    from comms_tpu_torch.kernels import fir as FK
    from comms_tpu_torch.kernels import panel_reduce as PR
    from comms_tpu_torch.kernels import qpsk_sym as QS
    from comms_tpu_torch.models import bpsk_tx as tb
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.models import qpsk_tx as tq
    from comms_tpu_torch.ops import random as trand
    from comms_tpu_torch.runtime import StreamRunner

    paths = {
        "bpsk_fast": (tb, tb.BpskTxConfig(syms_per_block=TX_BPSK_SYMS),
                      True, TX_BPSK_SYMS),
        "qpsk_fast": (tq, tq.QpskTxConfig(bits_per_block=TX_QPSK_BITS,
                                          dphase=TX_DPHASE,
                                          phase0=TX_PHASE0),
                      True, TX_QPSK_BITS),
        "bpsk_pair": (tb, tb.BpskTxConfig(syms_per_block=TX_PAIR), False,
                      TX_PAIR),
        "qpsk_pair": (tq, tq.QpskTxConfig(bits_per_block=TX_PAIR,
                                          dphase=TX_DPHASE,
                                          phase0=TX_PHASE0),
                      False, TX_PAIR),
    }

    def fns(mod, cfg, fast):
        if fast:
            return mod.make_block_fn_fast(cfg), mod.init_state_fast
        return mod.make_block_fn(cfg), mod.init_state

    def drawn(fast, n, blocks, d):
        """The bits the port's PRNG drew for ``blocks`` blocks from
        TX_SEED on ``d``."""
        draw = (trand.random_bits_packed_block if fast
                else trand.random_bits_block)
        key, out = trand.source_init(TX_SEED, d), []
        for _ in range(blocks):
            b, key = draw(key, n)
            out.append(b)
        return torch.cat(out)

    # ---- 18a. the card against the CPU, one block at each size
    same = {}
    for name, (mod, cfg, fast, n) in paths.items():
        fn, init = fns(mod, cfg, fast)
        out_d, st_d = fn(init(cfg, TX_SEED, dev))
        out_c, st_c = fn(init(cfg, TX_SEED, "cpu"))
        bits_eq = torch.equal(drawn(fast, n, 1, dev).cpu(),
                              drawn(fast, n, 1, "cpu"))
        keys_eq = torch.equal(st_d[0].cpu(), st_c[0])
        if fast:
            words_eq = (torch.equal(out_d.cpu(), out_c)
                        and torch.equal(st_d[1].cpu(), st_c[1])
                        and st_d[2:] == st_c[2:])
            same[name] = {"bits": bits_eq, "key": keys_eq,
                          "words_and_state": words_eq}
            ok = bits_eq and keys_eq and words_eq
        else:
            mx, share = lsb_diff_card(out_d.cpu(), out_c)
            same[name] = {"bits": bits_eq, "key": keys_eq,
                          "max_lsb": mx, "share": share}
            ok = bits_eq and keys_eq and mx <= 1 and share < TX_LSB_SHARE
        if not ok:
            fail(f"transmit {name}: the card differs from the CPU: "
                 f"{same[name]}")
    loop_bits_eq = torch.equal(drawn(True, TX_LOOP_BITS, 1, dev).cpu(),
                               drawn(True, TX_LOOP_BITS, 1, "cpu"))
    print("transmit, card vs CPU (one block each; fast paths bit for bit):",
          json.dumps(same), f"loopback block's bits equal: {loop_bits_eq}")
    if not loop_bits_eq:
        fail("the loopback block's bits differ between the card and the CPU")

    # ---- 18b. TX_CHAIN chained blocks against the float64 oracle
    oracle = {}
    for name, (mod, cfg, fast, n) in paths.items():
        fn, init = fns(mod, cfg, fast)
        st = init(cfg, TX_SEED, dev)
        outs = []
        for _ in range(TX_CHAIN):
            out, st = fn(st)
            outs.append(tx_pairs(out))
        got = torch.cat(outs)
        qpsk = mod is tq
        want = tx_oracle_card(drawn(fast, n, TX_CHAIN, dev), qpsk,
                              cfg.dphase if qpsk else 0.0,
                              cfg.phase0 if qpsk else 0.0)
        if got.shape != (TX_CHAIN * cfg.samples_per_block, 2):
            fail(f"transmit {name}: shape {tuple(got.shape)}")
        mx, share = lsb_diff_card(got, want)
        oracle[name] = {"samples": got.shape[0], "max_lsb": mx,
                        "share": share}
        if mx > 1 or share >= TX_LSB_SHARE:
            fail(f"transmit {name} vs the float64 oracle: {oracle[name]}")
        del got, want, outs
    print(f"transmit vs the float64 oracle ({TX_CHAIN} chained blocks; "
          f"bound 1 LSB, share < {TX_LSB_SHARE}):", json.dumps(oracle))

    # ---- 18c. loopback: QPSK fast tx at 2^24 bits -> the QPSK receiver
    lcfg = tq.QpskTxConfig(bits_per_block=TX_LOOP_BITS, dphase=QPSK_CFO,
                           phase0=QPSK_PHASE)
    t0 = time.perf_counter()
    packed, _ = tq.make_block_fn_fast(lcfg)(
        tq.init_state_fast(lcfg, TX_SEED, dev))
    pairs = tx_pairs(packed).to(torch.float32) / lcfg.scale
    g = torch.Generator(device=dev)
    g.manual_seed(TX_SEED)
    noise = QPSK_NOISE * torch.randn(2, pairs.shape[0], generator=g,
                                     device=dev)
    re = (pairs[:, 0] + noise[0]).contiguous()
    im = (pairs[:, 1] + noise[1]).contiguous()
    del pairs, noise, packed
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    bits = drawn(True, TX_LOOP_BITS, 1, dev).cpu().numpy().astype(np.uint8)
    if re.shape != (QPSK_N,):
        fail(f"loopback: {re.shape[0]} samples, want {QPSK_N}")
    rcfg = trx.QpskRxConfig()
    hw = rcfg.panel_hw
    qp = QS.qpsk_panels(re, im, hw)
    width = qp[4]["width"]
    p13 = torch.zeros((256, 256), device=dev)
    p24 = torch.zeros((256, 256), device=dev)
    p13[:128, :width], p13[128:, :width] = qp[0], qp[2]
    p24[:128, :width], p24[128:, :width] = -qp[1], -qp[3]
    plain_calls = [0]
    kept = {}

    def counting(mod, attr):
        fn = getattr(mod, attr)
        kept[(mod, attr)] = fn

        def wrapped(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        setattr(mod, attr, wrapped)

    for mod, attr in ((QS, "qpsk_symbol_plain"), (QS, "qpsk_panels_plain"),
                      (FK, "fir_plain"), (PR, "panel_reductions_plain")):
        counting(mod, attr)

    def counts():
        return {"qpsk_panels": QS.launches["qpsk_panels"],
                "qpsk_symbol_gemm": QS.launches["qpsk_symbol_gemm"],
                "qpsk_symbol_gemm_scalars":
                    QS.launches["qpsk_symbol_gemm_scalars"],
                "qpsk_symbols": QS.launches["qpsk_symbols"],
                "fir_planar": FK.launches, "panel_reductions": PR.launches,
                "plain": plain_calls[0]}

    # counts start at 0 here: the fused receiver, the staged core and K11
    # on the loopback's panels, as in the one-shot phase (9a)
    FK.launches = PR.launches = 0
    for k in QS.launches:
        QS.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sym, diag = trx.make_rx_fn_planar(rcfg)(re, im)
    torch.cuda.synchronize()
    rx_s = time.perf_counter() - t0
    fused_counts = counts()
    sym_s, diag_s = trx._rx_core_staged(rcfg, re, im)
    red = PR.panel_reductions(p13, p24, hw)
    torch.cuda.synchronize()
    loop_counts = counts()
    for (mod, attr), fn in kept.items():
        setattr(mod, attr, fn)
    M = QPSK_N // 4
    rot, lag0, head_errs = qpsk_align(sym, 0, bits)
    lo, hi = lag0 + QPSK_MARGIN, M - QPSK_MARGIN
    ber = qpsk_bit_errors(sym[:, lo:hi], lo, bits, rot, lag0)
    rot_s, lag_s, head_s = qpsk_align(sym_s, 0, bits)
    ber_s = qpsk_bit_errors(sym_s[:, lo:hi], lo, bits, rot_s, lag_s)
    V = 2 * hw + 1
    t_k11 = float(rcfg.timing.estimate_from_lag_sums(
        red[0, :V], red[1, :V], weights=rcfg.wq2, lag_rot=diag["freq"]))
    est = {k: float(v) for k, v in diag.items()}
    print(f"transmit loopback on {card}: QPSK fast tx {TX_LOOP_BITS} bits "
          f"-> {QPSK_N} samples (dphase {QPSK_CFO}, phase0 {QPSK_PHASE}, "
          f"noise {QPSK_NOISE}) in {tx_s:.3f} s; one-shot receiver "
          f"{rx_s:.3f} s: {json.dumps(est)}; lag {lag0} rot {rot}; "
          f"{ber} bit errors (staged core {ber_s}) over {2 * (hi - lo)} "
          f"bits; timing from the panel reductions {t_k11:.6f}")
    print("transmit loopback launches: fused receiver alone",
          json.dumps(fused_counts), "with the staged core and K11",
          json.dumps(loop_counts))
    if ber or ber_s or head_errs or head_s:
        fail(f"loopback bit errors: one-shot {ber}, staged {ber_s}")
    if abs(est["freq"] - QPSK_CFO) >= 0.01:
        fail(f"loopback frequency estimate {est['freq']}")
    if abs(t_k11 - est["timing"]) > 1e-4:
        fail(f"loopback timing from the panel reductions {t_k11}")
    if loop_counts != QPSK_ONE_SHOT_LAUNCHES:
        fail(f"loopback launches {loop_counts}, expected "
             f"{QPSK_ONE_SHOT_LAUNCHES}")
    del re, im, sym, sym_s, qp

    # ---- 18d. the fast paths served through StreamRunner, a profile each
    placeholder = torch.zeros(1, device=dev)
    for name in ("bpsk_fast", "qpsk_fast"):
        mod, cfg, _, _ = paths[name]
        fn = mod.make_block_fn_fast(cfg)
        spb = cfg.samples_per_block

        def serve(n, sink):
            torch.cuda.synchronize()
            runner = StreamRunner(
                lambda st, _x: fn(st), mod.init_state_fast(cfg, TX_SEED, dev),
                (placeholder for _ in range(n)), sink=sink,
                samples_of=lambda _x: spb, depth=SERVE_DEPTH, device=dev)
            return runner.run().msps

        first = []
        rates = {}
        for sink_name, sink in (("no_sink", None),
                                ("copying_sink",
                                 lambda y: first.append(y) if not first
                                 else None)):
            serve(SERVE_WARMUP, sink)
            first.clear()
            rates[sink_name] = serve(SERVE_BLOCKS, sink)
        st0 = mod.init_state_fast(cfg, TX_SEED, dev)
        want0, _ = fn(st0)
        if not np.array_equal(first[0], want0.cpu().numpy()):
            fail(f"served {name}: the first block differs from the block "
                 f"step's")
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(st0)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        dev_ms = cuda_ms(lambda: fn(st0))
        floor = bound(4 * spb, 0)[0]
        print(f"transmit {name} served on {card} ({SERVE_BLOCKS} blocks of "
              f"{spb} samples, depth {SERVE_DEPTH}, after {SERVE_WARMUP} "
              f"warm-up blocks; source a device placeholder): Msps "
              f"{json.dumps(rates)}; host enqueue "
              f"{float(np.median(enqueue)):.4f} ms a block (median of 5); "
              f"device {dev_ms:.4f} ms a block; floor {floor:.4f} ms (the "
              f"packed words written once)")
        profile_served(lambda: fn(st0), card, f"one {name} transmit block")
        profile_served(lambda: serve(SERVE_BLOCKS, None), card,
                       f"{SERVE_BLOCKS} served {name} transmit blocks, "
                       f"no sink")


def runtime_phases(dev, card: str) -> list:
    """Phase 19: the composable runtime on the card; its kernel rows."""
    import torch

    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.kernels import fir as FP
    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.models import bpsk_tx as tb
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.models import qpsk_tx as tq
    from comms_tpu_torch.ops import fir as tfir
    from comms_tpu_torch.parallel import dryrun
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.runtime import (BatchedStreamRunner, Fir,
                                         FirDecimate, Graph, StreamRunner)
    from comms_tpu_torch.runtime import checkpoint as ck

    def zero_counts():
        DF.launches = FP.launches = HR.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {"K2": DF.launches, "K4": FP.launches, "K12": HR.launches}

    # ---- 19a. the FM pipeline: 3 blocks chained, against make_block_fn
    cfg = fm.FmReceiverConfig(block=BLOCK)
    pipe, blk = fm.make_pipeline(cfg), fm.make_block_fn(cfg)
    iq, w = synth_capture(3 * BLOCK, seed=0)
    x = torch.from_numpy(iq).to(dev)
    blocks = [x[b * BLOCK:(b + 1) * BLOCK] for b in range(3)]
    # each stage's K2 launches, read around its op's apply
    stages = [op for op in pipe.ops if isinstance(op, FirDecimate)]
    stage_launches = [0] * len(stages)

    def counted(k, apply):
        def run(state, xb):
            before = DF.launches
            out = apply(state, xb)
            stage_launches[k] += DF.launches - before
            return out
        return run

    for k, op in enumerate(stages):
        object.__setattr__(op, "apply", counted(k, op.apply))
    zero_counts()
    s = pipe.init_state(dev)
    outs = []
    for xb in blocks:
        y, s = pipe.step(s, xb)
        outs.append(y)
    fm_counts = counts()
    for op in stages:
        object.__delattr__(op, "apply")
    sb, err = fm.init_state(cfg, dev), 0.0
    for xb, y in zip(blocks, outs):
        a, sb = blk(sb, xb)
        err = max(err, max_err(y, a))
    audio = torch.cat(outs).cpu().numpy()
    corr = demod_matches_tones(audio, w)
    print(f"FM make_pipeline at {BLOCK}, 3 blocks on {card}: vs "
          f"make_block_fn {err:.3g} (bound {TOL_RT_FM}); tone correlation "
          f"{corr:.5f}; launches {json.dumps(fm_counts)}, K2 by stage "
          f"{stage_launches}")
    if err > TOL_RT_FM or not np.isfinite(audio).all():
        fail(f"FM pipeline vs make_block_fn {err}")
    if corr < 0.99:
        fail(f"FM pipeline audio does not follow the tones: {corr}")
    if fm_counts != {"K2": 6, "K4": 0, "K12": 0} or stage_launches != [3, 3]:
        fail(f"FM pipeline launches {fm_counts}, by stage {stage_launches}: "
             f"expected K2 once a stage and block")

    def serve(n, sink=None):
        torch.cuda.synchronize()
        runner = StreamRunner(pipe.step, pipe.init_state(dev),
                              (blocks[i % 3] for i in range(n)), sink=sink,
                              depth=SERVE_DEPTH, device=dev)
        return runner.run().msps

    # no sink, and the FM phase's copying sink (its fused step's rate
    # is measured with one)
    rates, kept = {}, []
    for name, sink in (("no_sink", None), ("copying_sink", kept.append)):
        serve(SERVE_WARMUP, sink)
        kept.clear()
        zero_counts()
        rates[name] = serve(SERVE_BLOCKS, sink)
        served = counts()
        if served["K2"] != 2 * SERVE_BLOCKS:
            fail(f"served FM pipeline launched K2 {served['K2']} times")
    print(f"FM make_pipeline served on {card} ({SERVE_BLOCKS} blocks of "
          f"{BLOCK}, depth {SERVE_DEPTH}, after {SERVE_WARMUP} warm-up "
          f"blocks, device-resident): Msps {json.dumps(rates)}; launches "
          f"{json.dumps(served)}")
    head = np.concatenate(kept[:3])
    if not np.array_equal(head, audio[:head.shape[0]]):
        fail("served FM pipeline blocks differ from the stepped blocks")
    profile_served(lambda: serve(SERVE_BLOCKS), card,
                   f"{SERVE_BLOCKS} served FM make_pipeline blocks")

    # ---- 19b. checkpoint mid-stream on the card, resumed bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        s1 = pipe.step(pipe.init_state(dev), blocks[0])[1]
        ck.save_state(Path(tmp) / "fm", s1, meta={"blocks_done": 1})
        y_cont, _ = pipe.step(s1, blocks[1])
        y_res, _ = pipe.step(ck.load_state(Path(tmp) / "fm",
                                           pipe.init_state(dev)), blocks[1])
    if not torch.equal(y_cont, y_res):
        fail("FM pipeline resumed from a checkpoint differs")
    print("checkpoint of the FM pipeline mid-stream: resumed bit for bit")

    # ---- 19c. BatchedStreamRunner: 3 FM streams against separate runs
    srcs = [[blocks[(b + k) % 3] for k in range(2)]
            for b in range(RT_STREAMS)]
    want = []
    for src in srcs:
        st, got = pipe.init_state(dev), []
        for xb in src:
            y, st = pipe.step(st, xb)
            got.append(y)
        want.append(torch.stack(got))
    got = [[] for _ in range(RT_STREAMS)]
    batched = [torch.stack([srcs[b][k] for b in range(RT_STREAMS)])
               for k in range(2)]
    t0 = time.perf_counter()
    meter = BatchedStreamRunner(
        pipe.step, [pipe.init_state(dev) for _ in range(RT_STREAMS)],
        batched_source=batched, sinks=[g.append for g in got],
        depth=SERVE_DEPTH, device=dev).run()
    for b in range(RT_STREAMS):
        if not np.array_equal(np.stack(got[b]), want[b].cpu().numpy()):
            fail(f"batched FM stream {b} differs from its separate run")
    print(f"BatchedStreamRunner, {RT_STREAMS} FM streams x 2 blocks of "
          f"{BLOCK}: equal to separate runs bit for bit "
          f"({meter.msps:.1f} Msps with a copying sink, "
          f"{time.perf_counter() - t0:.2f} s)")
    del srcs, want, got, batched

    # ---- 19d. the sharded FM pipeline against the unsharded one
    mesh = sh.time_mesh(SH_SHARDS, device=dev)
    sstep = pipe.make_sharded_step(mesh, block=BLOCK)
    s_ref, s_sh = pipe.init_state(dev), pipe.init_state(dev)
    zero_counts()
    for xb in blocks[:2]:
        y_sh, s_sh = sstep(s_sh, xb)
        y_ref, s_ref = pipe.step(s_ref, xb)
        if not torch.equal(y_sh, y_ref):
            fail(f"sharded FM pipeline differs: {max_err(y_sh, y_ref)}")
    sh_counts = counts()
    print(f"sharded FM pipeline, {SH_SHARDS} shards x {BLOCK // SH_SHARDS}"
          f", 2 blocks: equal to the unsharded pipeline bit for bit; "
          f"launches (with the unsharded steps' K2) {json.dumps(sh_counts)}")
    if sh_counts != {"K2": 2 * (2 * SH_SHARDS + 2), "K4": 0, "K12": 2 * 3}:
        fail(f"sharded FM pipeline launches {sh_counts}")
    k12_sharded = sh_counts["K12"]
    dryrun._dryrun_pipeline(SH_SHARDS, mesh, dev)
    g = Graph()
    g.add_node("double", lambda prev: prev * 2, ["double"],
               feedback_from={"double": torch.ones(1, device=dev)})
    g.set_outputs(["double"])
    gstep, gs = g.compile(), g.init_state(device=dev)
    seen = []
    for _ in range(10):
        (out,), gs = gstep(gs, {})
        seen.append(float(out[0]))
    if seen != [2.0 ** k for k in range(1, 11)]:
        fail(f"Graph feedback doubler: {seen}")
    print(f"dry-run config 3 on {SH_SHARDS} shards: OK; Graph feedback "
          f"doubler: {seen[-1]} after 10 steps")

    # ---- 19e. the transmit pipelines, bit-equal to make_block_fn
    for name, mod, tcfg in (
            ("bpsk", tb, tb.BpskTxConfig(syms_per_block=TX_BPSK_SYMS)),
            ("qpsk", tq, tq.QpskTxConfig(bits_per_block=TX_QPSK_BITS,
                                         dphase=TX_DPHASE,
                                         phase0=TX_PHASE0))):
        tp, tblk = mod.make_pipeline(tcfg, seed=TX_SEED), mod.make_block_fn(
            tcfg)
        sp, st = tp.init_state(dev), mod.init_state(tcfg, TX_SEED, dev)
        for b in range(TX_CHAIN):
            yp, sp = tp.step(sp)
            yb, st = tblk(st)
            if not torch.equal(yp, yb):
                fail(f"{name} make_pipeline block {b} differs from "
                     f"make_block_fn")
        print(f"{name} make_pipeline: {TX_CHAIN} blocks of "
              f"{tcfg.samples_per_block} samples bit-equal to "
              f"make_block_fn on the card")

    # ---- 19f. the FIR ops on the kernels against the GEMM op
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    taps = np.hamming(RT_TAPS).astype(np.float32)
    taps /= taps.sum()
    ops = {}
    for name, op, n, dec, mod in (
            ("fir_op", Fir.make(taps), RT_FIR_N, 1, FP),
            ("fir_decimate_op", FirDecimate.make(taps, RT_DEC), RT_DEC_N,
             RT_DEC, DF)):
        xr = torch.randn(2, n, generator=gen, device=dev)
        xc = torch.complex(xr[0], xr[1])
        ctx = torch.complex(*torch.randn(2, op.halo, generator=gen,
                                         device=dev))
        zero_counts()
        y, s_new = op.apply(ctx, xc)
        c = counts()
        if dec > 1:
            ref, s_ref = tfir.fir_decimate_poly(
                xc, tfir.decimating_branch_taps(taps, dec), ctx)
        else:
            ref, s_ref = tfir.fir_block(xc, taps, ctx)
        e = rel_err(y, ref)
        print(f"{name} ({n} complex64 samples, {RT_TAPS} real taps, dec "
              f"{dec}): kernel route vs the GEMM op {e:.3g}; launches "
              f"{json.dumps(c)}")
        if e > TOL_FIR or not torch.equal(s_new, s_ref):
            fail(f"{name} disagrees with the GEMM op: {e}")
        if c[{1: "K4"}.get(dec, "K2")] != 1:
            fail(f"{name} launches {c}")
        ops[name] = (xr, ctx, c)

    # ---- 19g. kernel rows: K2 at the FM pipeline's two stages, K4 and K2
    # under the ops, K12 at the pipeline's halos
    rows = []
    D, T = cfg.dec1, len(fm.FM_LPF_TAPS)
    h = fm.FM_LPF_TAPS.astype(np.float32)
    W = D * 128
    MD = D * -(-T // D)
    xf = (x[:BLOCK].to(torch.float32) - 127.5) / 127.5
    p1 = (xf[:, 0].contiguous(), xf[:, 1].contiguous())
    mid = torch.randn(2, BLOCK // D, generator=gen, device=dev)
    p2 = (mid[0].contiguous(), torch.zeros_like(mid[0]))
    # stage 1: complex planes, 8 bytes a sample each way and 2T FMAs an
    # output; stage 2 a real stream through real taps: 4 bytes and T
    # FMAs (the kernel's zero imaginary plane is not the function's work)
    for k, (name, (pr, pi), n, width, fmas) in enumerate((
            ("fir_decimate_fm_stage1", p1, BLOCK, 8, 2),
            ("fir_decimate_fm_stage2", p2, BLOCK // D, 4, 1))):
        cr = torch.randn(1, W, generator=gen, device=dev)
        ci = (torch.randn(1, W, generator=gen, device=dev)
              if name.endswith("1") else torch.zeros(1, W, device=dev))
        yk = DF.fir_decimate_planar(pr, pi, h, D, cr, ci, tile_rows=8)
        yp = DF.fir_decimate_plain(pr, pi, h, D, cr, ci)
        e = rel_err(torch.stack(yk[:2]), torch.stack(yp))
        if e > TOL_FIR:
            fail(f"{name}: kernel vs plain {e}")
        ms = cuda_ms(lambda: DF.fir_decimate_planar(pr, pi, h, D, cr, ci,
                                                    tile_rows=8))
        plain_ms = cuda_ms(lambda: DF.fir_decimate_plain(pr, pi, h, D, cr,
                                                         ci))
        lib = conv1d_ms(torch.stack([torch.cat([cr[0, W - T + 1:], pr]),
                                     torch.cat([ci[0, W - T + 1:], pi])]),
                        h, D, want=torch.stack(yk[:2]))
        print(f"{name} on {card} (N {n}, dec {D}, {T} taps): kernel vs "
              f"plain {e:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.conv1d {lib:.4f} ms")
        rows.append(kernel_row(name, "decim_fir.cu",
                               "comms_tpu/kernels/decim_fir_pallas.py:262",
                               stage_launches[k], e, ms, plain_ms,
                               width * (n + n // D), 2 * fmas * T * n // D,
                               lib))
    for name, f, rep, dec in (("fir_op", "decim_fir.cu",
                               "comms_tpu/kernels/fir_pallas.py:253", 1),
                              ("fir_decimate_op", "decim_fir.cu",
                               "comms_tpu/kernels/decim_fir_pallas.py:262",
                               RT_DEC)):
        xr, ctx, c = ops[name]
        n = xr.shape[1]
        W = FP.MAX_TAPS - 1 if dec == 1 else dec * 128
        xc = torch.complex(xr[0], xr[1])
        pr, pi, cr, ci = DF._block_planes(xc, ctx, W)
        if dec == 1:
            run = (lambda: FP.fir_planar(pr, pi, taps, cr, ci, tile_rows=8))
            plain = (lambda: FP.fir_plain(pr, pi, taps, cr, ci))
            launches = c["K4"]
        else:
            run = (lambda: DF.fir_decimate_planar(pr, pi, taps, dec, cr, ci,
                                                  tile_rows=8))
            plain = (lambda: DF.fir_decimate_plain(pr, pi, taps, dec, cr,
                                                   ci))
            launches = c["K2"]
        ctx_l = (cr[W - RT_TAPS + 1:], ci[W - RT_TAPS + 1:])
        yk, yp = run(), plain()
        e = rel_err(torch.stack(yk[:2]), torch.stack(yp))
        if e > TOL_FIR:
            fail(f"{name}: kernel vs plain {e}")
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        lib = conv1d_ms(torch.stack([torch.cat([ctx_l[0], pr]),
                                     torch.cat([ctx_l[1], pi])]),
                        taps, dec, want=torch.stack(yk[:2]))
        print(f"{name} on {card} (N {n}, dec {dec}, {RT_TAPS} taps): kernel "
              f"vs plain {e:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, F.conv1d {lib:.4f} ms")
        rows.append(kernel_row(name, f, rep, launches, e, ms, plain_ms,
                               8 * n + 8 * n // dec,
                               4 * RT_TAPS * n // dec, lib))
    # K12 at the sharded pipeline's first halo: 8 complex64 tails of MD-1
    xs = sh.shard(torch.complex(p1[0], p1[1]), mesh, ("time",))
    rings = [xs]
    halo = MD - 1
    ctx0 = [torch.zeros(halo, dtype=torch.complex64, device=dev)]
    got = HR.exchange(rings, halo, ctx0)
    ref = HR.exchange_plain(rings, halo, ctx0)
    if not all(torch.equal(a, b) for a, b in zip(got[0], ref[0])):
        fail("K12 at the pipeline's halos differs from its plain version")
    srcs = [ctx0[0]] + [t[-halo:] for t in xs[:-1]]
    dsts = [torch.empty_like(t) for t in srcs]
    ms = cuda_ms(lambda: HR.exchange(rings, halo, ctx0))
    plain_ms = cuda_ms(lambda: HR.exchange_plain(rings, halo, ctx0))
    lib = (cuda_ms(lambda: torch._foreach_copy_(dsts, srcs))
           if hasattr(torch, "_foreach_copy_") else None)
    nbytes = 2 * SH_SHARDS * halo * 8
    print(f"K12 at the FM pipeline's first halo on {card} ({SH_SHARDS} "
          f"tails of {halo} complex64): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib} ms")
    rows.append(kernel_row("ring_halo_exchange_pipeline", "halo_ring.cu",
                           "comms_tpu/kernels/halo_rdma.py:84", k12_sharded,
                           0.0, ms, plain_ms, nbytes, 0, lib))
    return rows


# ---- phase 20: the QPSK link
# The Costas receiver's block (examples/qpsk_receiver.py) and the JAX
# test's channel (tests/test_qpsk_rx_stream.py:56-95); the network
# loopback's transmitter (4096 bits a block, 8192 samples: one receiver
# block); the recurrence kernels' comparison and timing sizes.
LINK_BLOCK = 8192
LINK_BLOCKS = 34
LINK_SEED = 11
LINK_DELAY, LINK_PHASE = 1.7, 0.9
LINK_W1, LINK_W2, LINK_STEP_BLOCK = 0.01, 0.012, 17
LINK_SKIP = 3            # acquisition blocks of the Costas receiver
NET_BLOCKS = 128         # 128 x 8192 = 1,048,576 samples
NET_BITS = 4096
NET_SEED = 5
COSTAS_CHECK = (2048, 16384)
COSTAS_LONG = 1 << 20
AGC_CHECK = 4096
AGC_LONG = 262_144       # the rtl-sdr read
VMAP_STREAMS = 3
TOL_REC = 1e-5           # recurrence kernels against plain (O(1) values)
TOL_SPLIT = 1e-5         # split vs fast (tests/test_qpsk_rx_stream.py:213)
# The vmapped Costas receiver against unroll, a block (phase 20g): the
# step's batched frequency-estimate sum and matched-filter GEMM round
# otherwise than one stream's (tools/costas_vmap_rounding.py), and the
# Costas detector's +-pi branch carries it.  Measured over 34 blocks of
# 8 and 64 streams: symbols 5.2e-4 apart, states 1.5e-2 (the
# interpolator's carried samples; theta and tau compared modulo their
# periods); limits 4x that.
TOL_VMAP_SYM = 2e-3
TOL_VMAP_STATE = 6e-2
# The batched recurrence kernels' stream counts: one, the served
# receiver's 8, a warp, the served 64, 4 blocks of 128, and one warp on
# each of the card's 528 schedulers; the served Costas receiver's stream
# counts.
BATCH_STREAMS = (1, 8, 32, 64, 512, 16_896)
SERVE_STREAMS = (8, 64)
# The recurrence probe (tools/recurrence_floor.start_probe), started in
# phase 2 beside the package's build.
RECURRENCE_PROBE = []


def link_channel(n_blocks: int, block: int, seed: int):
    """The JAX Costas test's channel (numpy): random bits, qpsk_tx's RRC
    (unit energy), a fractional delay, a carrier 0.01 -> 0.012 rad/sample
    from block LINK_STEP_BLOCK, phase LINK_PHASE.  Returns the bits and
    float32 pairs [n_blocks * block, 2]."""
    from comms_tpu_torch.ops import taps as ttaps

    n_sym = n_blocks * block // 4 + 64
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    rrc = np.asarray(ttaps.rrc_taps(32, 4.0, 0.25))
    rrc = rrc / np.sqrt(np.sum(np.abs(rrc) ** 2))
    p = bits.reshape(-1, 2)
    up = np.zeros(4 * n_sym, np.complex64)
    up[::4] = ((2.0 * p[:, 0] - 1) + 1j * (2.0 * p[:, 1] - 1))
    s = np.convolve(up, rrc.astype(np.complex64))[:len(up)]
    X = np.fft.fft(np.concatenate([s, np.zeros(256, s.dtype)]))
    k = np.fft.fftfreq(len(X))
    s = np.fft.ifft(X * np.exp(-2j * np.pi * k * LINK_DELAY))[:len(s)]
    n = np.arange(len(s))
    dph = np.where(n < LINK_STEP_BLOCK * block, LINK_W1, LINK_W2)
    r = s.astype(np.complex64) * np.exp(
        1j * (LINK_PHASE + np.cumsum(dph))).astype(np.complex64)
    r = r[:n_blocks * block]
    return bits, np.stack([r.real, r.imag], -1).astype(np.float32)


def best_align(sym: np.ndarray, bits: np.ndarray, start_sym: int,
               max_lag: int = 24):
    """``(errors, compared, rot, lag)``: the best of the 4 rotations x
    symbol lags in [-max_lag, max_lag] of the complex symbols ``sym``
    (stream symbol ``start_sym`` first) against ``bits``, compared over
    the whole overlap (the JAX test's ``_best_align``)."""
    from comms_tpu_torch.models import qpsk_rx as trx

    best = None
    for rot in range(4):
        cand = trx.decide_bits(sym * np.exp(1j * np.pi / 2 * rot))
        for lag in range(-max_lag, max_lag + 1):
            start = 2 * (start_sym + lag)
            if start < 0:
                continue
            ref = bits[start:]
            m = min(len(cand), len(ref))
            errs = int(np.count_nonzero(cand[:m] != ref[:m]))
            if best is None or errs < best[0]:
                best = (errs, m, rot, lag)
    return best


def locked_symbols(n: int, seed: int, dev):
    """QPSK symbols at the receiver's level turned by 0.05 rad plus 1e-3
    rad a symbol, with noise of sigma 0.02: the Costas loop is locked from
    the first symbol."""
    import torch

    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, size=(2, n))
    s = ((2 * b[0] - 1) + 1j * (2 * b[1] - 1)) * np.exp(
        1j * (0.05 + 1e-3 * np.arange(n)))
    s = s + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return torch.from_numpy(s.astype(np.complex64)).to(dev)


def locked_symbols_card(B: int, n: int, seed: int, dev):
    """[B, n] complex64 on the card: :func:`locked_symbols`' streams (0.05
    rad plus 1e-3 rad a symbol, noise of sigma 0.02), made there from a
    seeded generator, each stream its own bits and noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randint(0, 2, (2, B, n), generator=g, device=dev) * 2.0 - 1
    ph = 0.05 + 1e-3 * torch.arange(n, device=dev, dtype=torch.float32)
    s = torch.complex(b[0], b[1]) * torch.polar(torch.ones_like(ph), ph)
    noise = torch.randn((2, B, n), generator=g, device=dev) * 0.02
    return s + torch.complex(noise[0], noise[1])


def agc_samples_card(B: int, n: int, seed: int, dev):
    """[B, n] complex64 on the card: phase 20c's AGC input (a step from
    0.1 to 2.0 halfway, a tone of 0.3 rad a sample, noise of sigma 0.01),
    each stream its own tone phase and noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.arange(n, device=dev, dtype=torch.float32)
    amp = torch.where(k < n // 2, 0.1, 2.0)
    ph = 0.3 * k + 6.0 * torch.rand((B, 1), generator=g, device=dev)
    noise = torch.randn((2, B, n), generator=g, device=dev) * 0.01
    return (torch.polar(amp.expand(B, n), ph)
            + torch.complex(noise[0], noise[1]))


def recurrence_tools():
    """``tools/recurrence_floor`` (the recurrence kernels' floor and
    bound), imported from this checkout's ``tools``."""
    if str(REPO / "tools") not in sys.path:
        sys.path.insert(0, str(REPO / "tools"))
    import recurrence_floor

    return recurrence_floor


def recurrence_floor(dev, card: str) -> dict:
    """The recurrence kernels' measured floors
    (``recurrence_floor.chain_floor`` on phase 2's probe), printed."""
    rf = recurrence_tools()
    floor = rf.chain_floor(dev, RECURRENCE_PROBE[0])
    for line in floor["ptxas"]:
        print(f"ptxas recurrence probe {line}")
    for k in ("costas", "agc"):
        f = floor[k]
        print(f"{k} dependent chain on {card} (measured: the step on "
              f"register-resident data, one warp): {f['cycles_a_step']:.1f} "
              f"cycles, {f['ns_a_step']:.2f} ns a step at {f['ghz']:.3f} "
              f"GHz; the chain-only loop's SASS a step: "
              f"{f['sass_a_step']:.2f} in its span, "
              f"{f['sass_fewest_a_step']:.2f} the fewest an iteration "
              f"issues -> issue term {f['issue_ns_a_stream_step']:.5f} ns "
              f"a stream-step; clock64 split (cycles) "
              f"{json.dumps({p: round(v, 1) for p, v in f['split_cycles'].items()})}")
    return floor


def batched_rows(name: str, call, plain, make, states, n: int, floor: dict,
                 card: str) -> list:
    """The batched kernel ``call(xr, xi, *states(B))`` against ``plain``
    bit for bit and timed at each of BATCH_STREAMS streams of ``n`` steps
    (``make(B, n, seed)``: complex [B, n] on the card), beside the bound
    (``recurrence_floor.bound_ms``).  Returns the timings."""
    import torch

    rf = recurrence_tools()
    out = []
    for B in BATCH_STREAMS:
        x = make(B, n, 100 + B)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        st = states(B)
        got = call(xr, xi, *st)
        want = plain(xr, xi, *st)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            err = max(max_err(g, w) for g, w in zip(got, want))
            fail(f"{name} batched at {B} x {n}: not bit-equal to the "
                 f"batched plain version (max {err:.3g})")
        ms = cuda_ms(lambda: call(xr, xi, *st))
        b = rf.bound_ms(floor, B, n)
        out.append({"B": B, "n": n, "ms": ms, **b})
        print(f"{name} batched, {B} streams x {n} on {card}: bit for bit "
              f"with the batched plain version; {ms:.4f} ms, "
              f"{1e6 * ms / n:.1f} ns a step a stream, "
              f"{B * n / ms / 1e3:.1f} M steps/s; bound {b['bound_ms']:.4f}"
              f" ms ({b['bound_by']}: chain {b['chain_ms']:.4f}, bytes "
              f"{b['bytes_ms']:.4f}, issue {b['issue_ms']:.4f}; bytes pass "
              f"the chain from B = {b['bytes_from_B']:.0f}, issue from "
              f"{b['issue_from_B']:.0f})")
        del x, xr, xi, got, want
    return out


def qpsk_link_phases(dev, card: str) -> list:
    """Phase 20: the QPSK link; returns the recurrence kernels' rows."""
    import threading

    import torch

    from comms_tpu_torch.kernels import qpsk_sym as QS
    from comms_tpu_torch.kernels import recurrence as R
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.models import qpsk_rx_stream as tstream
    from comms_tpu_torch.models import qpsk_stream
    from comms_tpu_torch.models import qpsk_tx as tq
    from comms_tpu_torch.ops import agc
    from comms_tpu_torch.ops import random as trand
    from comms_tpu_torch.runtime import BatchedStreamRunner, StreamRunner

    def zero_counts():
        torch.cuda.synchronize()
        for k in QS.launches:
            QS.launches[k] = 0
        for k in R.launches:
            R.launches[k] = 0

    def counts():
        torch.cuda.synchronize()
        return {**{k: QS.launches[k] for k in ("qpsk_symbol_gemm_scalars",
                                               "qpsk_panels",
                                               "qpsk_symbols")},
                **R.launches}

    # ---- 20a. vmap: 3 fused QPSK streams of IN_PER_STEP samples, two
    # rounds, against unroll; the vmapped step runs once a stream, so
    # K5's launches are counted once a stream
    B = QS.IN_PER_STEP
    re, im, bits = qpsk_capture(dev, seed=13)
    rcfg = trx.QpskRxConfig()
    fused = tstream.make_stream_fused_fn(rcfg)
    rounds = [tuple(torch.stack([p[(2 * s + k) * B:(2 * s + k + 1) * B]
                                 for s in range(VMAP_STREAMS)])
                    for p in (re, im)) for k in range(2)]
    lifted = {}
    for mode in ("unroll", "vmap"):
        got = [[] for _ in range(VMAP_STREAMS)]
        zero_counts()
        r = BatchedStreamRunner(
            lambda st, x: fused(st, *x),
            [tstream.init_state_fast(rcfg, dev)
             for _ in range(VMAP_STREAMS)],
            batched_source=rounds, sinks=[g.append for g in got],
            depth=2, mode=mode, device=dev)
        r.run()
        lifted[mode] = (got, r.stream_states(), counts())
    print(f"batched fused QPSK step, {VMAP_STREAMS} streams x 2 rounds of "
          f"{B} samples on {card}: launches unroll "
          f"{json.dumps(lifted['unroll'][2])}, vmap "
          f"{json.dumps(lifted['vmap'][2])}")
    want_k5 = 2 * VMAP_STREAMS
    for mode, (_, _, c) in lifted.items():
        if (c["qpsk_symbol_gemm_scalars"] != want_k5
                or c["qpsk_symbols"] != want_k5):
            fail(f"batched fused step ({mode}): K5 launches {c}")
    for s in range(VMAP_STREAMS):
        for k in range(2):
            if not np.array_equal(lifted["vmap"][0][s][k],
                                  lifted["unroll"][0][s][k]):
                d = np.abs(lifted["vmap"][0][s][k]
                           - lifted["unroll"][0][s][k]).max()
                fail(f"vmap differs from unroll: stream {s} round {k}, "
                     f"max {d:.3g}")
        for key, v in lifted["unroll"][1][s].items():
            if not torch.equal(lifted["vmap"][1][s][key], v):
                fail(f"vmap state {key} of stream {s} differs from unroll")
    print("vmap equals unroll bit for bit (symbols and states)")
    del rounds, lifted

    # ---- 20b. the Costas kernel against its plain version, then times;
    # the batched kernel against the batched plain version
    floor = recurrence_floor(dev, card)
    rows = []
    errs = {}
    for n in COSTAS_CHECK:
        x = locked_symbols(n, n, dev)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        ph0 = torch.tensor(0.01, device=dev)
        fr0 = torch.tensor(-2e-4, device=dev)
        got = R.costas_loop(xr, xi, ph0, fr0, 0.1, 0.005)
        want = R.costas_loop_plain(xr, xi, ph0, fr0, 0.1, 0.005)
        errs[n] = max(max_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"costas_loop at {n} symbols on {card}: kernel vs plain max "
              f"{errs[n]:.3g} ({'bit for bit' if same else 'not bit-equal'})")
        if errs[n] > TOL_REC:
            fail(f"costas_loop at {n} symbols: {errs[n]} > {TOL_REC}")
    n = COSTAS_CHECK[0]
    x = locked_symbols(n, 1, dev)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    z = torch.zeros((), device=dev)
    costas_ms = cuda_ms(lambda: R.costas_loop(xr, xi, z, z, 0.1, 0.005))
    costas_plain_ms = cuda_ms(
        lambda: R.costas_loop_plain(xr, xi, z, z, 0.1, 0.005), reps=3,
        warmup=1)
    xl = locked_symbols(COSTAS_LONG, 2, dev)
    lr, li = xl.real.contiguous(), xl.imag.contiguous()
    long_ms = cuda_ms(lambda: R.costas_loop(lr, li, z, z, 0.1, 0.005),
                      reps=3, warmup=1)
    print(f"costas_loop on {card}: kernel {costas_ms:.4f} ms at {n} symbols "
          f"({1e6 * costas_ms / n:.1f} ns a symbol), {long_ms:.4f} ms at "
          f"{COSTAS_LONG} ({1e6 * long_ms / COSTAS_LONG:.1f} ns a symbol); "
          f"plain {costas_plain_ms:.4f} ms at {n}; the dependent chain's "
          f"floor (measured) {floor['costas']['ns_a_step']:.1f} ns a symbol")
    del xl, lr, li
    costas_batched = batched_rows(
        "costas_loop",
        lambda xr, xi, p, f: R.costas_loop_batched(xr, xi, p, f, 0.1, 0.005),
        lambda xr, xi, p, f: R.costas_loop_batched_plain(xr, xi, p, f, 0.1,
                                                         0.005),
        lambda B, n, seed: locked_symbols_card(B, n, seed, dev),
        lambda B: (torch.linspace(-0.05, 0.05, B, device=dev),
                   torch.full((B,), -2e-4, device=dev)),
        COSTAS_CHECK[0], floor["costas"], card)

    # ---- 20c. the AGC scan kernel against its plain version, then times
    rng = np.random.default_rng(4)
    amp = np.where(np.arange(AGC_CHECK) < AGC_CHECK // 2, 0.1, 2.0)
    xa = torch.from_numpy((amp * np.exp(1j * 0.3 * np.arange(AGC_CHECK))
                           + 0.01 * rng.normal(size=AGC_CHECK))
                          .astype(np.complex64)).to(dev)
    g0 = agc.agc_init(device=dev)
    ar, ai = xa.real.contiguous(), xa.imag.contiguous()
    got = R.agc_scan(ar, ai, g0, 1.0, 5e-2)
    want = R.agc_scan_plain(ar, ai, g0, 1.0, 5e-2)
    agc_err = max(max_err(g, w) for g, w in zip(got, want))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"agc_scan at {AGC_CHECK} samples on {card}: kernel vs plain max "
          f"{agc_err:.3g} ({'bit for bit' if same else 'not bit-equal'})")
    if agc_err > TOL_REC:
        fail(f"agc_scan: {agc_err} > {TOL_REC}")
    agc_ms = cuda_ms(lambda: R.agc_scan(ar, ai, g0, 1.0, 5e-2))
    agc_plain_ms = cuda_ms(lambda: R.agc_scan_plain(ar, ai, g0, 1.0, 5e-2),
                           reps=3, warmup=1)
    xl = torch.randn(2, AGC_LONG, device=dev)
    agc_long_ms = cuda_ms(lambda: R.agc_scan(xl[0], xl[1], g0, 1.0, 1e-2),
                          reps=3, warmup=1)
    print(f"agc_scan on {card}: kernel {agc_ms:.4f} ms at {AGC_CHECK} "
          f"samples ({1e6 * agc_ms / AGC_CHECK:.1f} ns a sample), "
          f"{agc_long_ms:.4f} ms at {AGC_LONG} "
          f"({1e6 * agc_long_ms / AGC_LONG:.1f} ns a sample); plain "
          f"{agc_plain_ms:.4f} ms at {AGC_CHECK}; the dependent chain's "
          f"floor (measured) {floor['agc']['ns_a_step']:.1f} ns a sample")
    del xl
    batched_rows(
        "agc_scan",
        lambda xr, xi, g: R.agc_scan_batched(xr, xi, g, 1.0, 5e-2),
        lambda xr, xi, g: R.agc_scan_batched_plain(xr, xi, g, 1.0, 5e-2),
        lambda B, n, seed: agc_samples_card(B, n, seed, dev),
        lambda B: (torch.linspace(0.5, 2.0, B, device=dev),),
        AGC_CHECK, floor["agc"], card)

    # ---- 20d. the Costas receiver on the JAX test's channel, served
    cfg = tstream.QpskRxStreamConfig(block=LINK_BLOCK)
    M = cfg.syms_per_block
    bits_c, pairs = link_channel(LINK_BLOCKS, LINK_BLOCK, LINK_SEED)
    blocks = [torch.from_numpy(pairs[b * LINK_BLOCK:(b + 1) * LINK_BLOCK])
              .to(dev) for b in range(LINK_BLOCKS)]
    step = tstream.make_stream_fn(cfg)
    calls = []      # each call's host ms inside the runner

    def timed_step(state, x):
        t0 = time.perf_counter()
        r = step(state, x)
        calls.append((time.perf_counter() - t0) * 1e3)
        return r

    def serve_link(out):
        calls.clear()
        torch.cuda.synchronize()
        msps = StreamRunner(timed_step, tstream.init_state(cfg, dev),
                            iter(blocks), sink=out.append, depth=SERVE_DEPTH,
                            device=dev).run().msps
        return msps, list(calls)

    # the first pass holds the step's first calls ever; the rate is
    # timed on a second pass over the same blocks
    out = []
    zero_counts()
    first_msps, first_calls = serve_link(out)
    served_counts = counts()
    sym = np.concatenate(out[LINK_SKIP:])
    errs_c, compared, rot, lag = best_align(sym[:, 0] + 1j * sym[:, 1],
                                            bits_c, LINK_SKIP * M)
    link_msps, link_calls = serve_link([])
    st = tstream.init_state(cfg, dev)
    enqueue = []
    for b in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = step(st, blocks[b])
        enqueue.append((time.perf_counter() - t0) * 1e3)
    dev_ms = cuda_ms(lambda: step(st, blocks[5]))
    print(f"Costas receiver served on {card} ({LINK_BLOCKS} blocks of "
          f"{LINK_BLOCK}, depth {SERVE_DEPTH}, device-resident, copying "
          f"sink, carrier step at block {LINK_STEP_BLOCK}): "
          f"{link_msps:.4f} Msps, {1e3 * LINK_BLOCK / link_msps / 1e6:.4f} "
          f"ms a block, a step call {float(np.median(link_calls)):.4f} ms "
          f"(median) on the second pass; the first pass (the step's first "
          f"calls) {first_msps:.4f} Msps, its step calls {first_calls[0]:.1f}"
          f" ms first, then median {float(np.median(first_calls[1:])):.4f},"
          f" max {max(first_calls[1:]):.1f}; "
          f"{errs_c} bit errors over {compared} bits after {LINK_SKIP} "
          f"acquisition blocks (rot {rot}, lag {lag}); host enqueue on an "
          f"idle card {float(np.median(enqueue)):.4f} ms a block (median "
          f"of 5); device {dev_ms:.4f} ms a block; launches in the first "
          f"pass {json.dumps(served_counts)}")
    if served_counts["costas_loop"] != LINK_BLOCKS:
        fail(f"Costas receiver: {served_counts['costas_loop']} Costas "
             f"launches in {LINK_BLOCKS} blocks")
    if errs_c or compared <= 60000:
        fail(f"Costas receiver: {errs_c} bit errors over {compared} bits")
    profile_served(lambda: step(st, blocks[6]), card,
                   "one Costas receiver block")
    costas_launches = served_counts["costas_loop"]
    agc_launches = served_counts["agc_scan"]
    del blocks, out

    # ---- 20e. the network loopback: the port's transmitter on the card
    # -> TCP on 127.0.0.1 -> the Costas receiver on the card, both codecs
    tcfg = tq.QpskTxConfig(bits_per_block=NET_BITS, dphase=TX_DPHASE,
                           phase0=TX_PHASE0)
    key, drawn = trand.source_init(NET_SEED, dev), []
    for _ in range(NET_BLOCKS):
        b, key = trand.random_bits_block(key, NET_BITS)
        drawn.append(b)
    tx_bits = torch.cat(drawn).cpu().numpy().astype(np.uint8)
    net = {}
    for codec in ("raw", "cbor"):
        port = free_port()
        ep = f"tcp://127.0.0.1:{port}"
        got = []

        def rx():
            got.extend(qpsk_stream.receive_blocks(
                ep, NET_BLOCKS, backend="tcp", codec=codec, timeout=120.0))

        th = threading.Thread(target=rx, daemon=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th.start()
        sent = qpsk_stream.stream_blocks(ep, NET_BLOCKS, tcfg, seed=NET_SEED,
                                         backend="tcp", codec=codec,
                                         device=dev)
        th.join(timeout=300)
        if th.is_alive() or len(got) != NET_BLOCKS:
            fail(f"network loopback ({codec}): {len(got)} of {NET_BLOCKS} "
                 f"blocks received")
        t_net = time.perf_counter() - t0
        rx_out = []
        zero_counts()
        StreamRunner(step, tstream.init_state(cfg, dev),
                     (np.stack([g.real, g.imag], -1) for g in got),
                     sink=rx_out.append, depth=SERVE_DEPTH,
                     device=dev).run()
        c = counts()
        t_all = time.perf_counter() - t0
        sym = np.concatenate(rx_out[LINK_SKIP:])
        e, m, rot, lag = best_align(sym[:, 0] + 1j * sym[:, 1], tx_bits,
                                    LINK_SKIP * M)
        net[codec] = {"samples": sent, "seconds": t_all,
                      "transfer_seconds": t_net,
                      "msps": sent / t_all / 1e6, "bit_errors": e,
                      "bits": m, "rot": rot, "lag": lag,
                      "costas_launches": c["costas_loop"]}
        costas_launches += c["costas_loop"]
        agc_launches += c["agc_scan"]
        if e or m < 2 * (NET_BLOCKS - LINK_SKIP - 1) * M:
            fail(f"network loopback ({codec}): {e} bit errors over {m}")
        if c["costas_loop"] != NET_BLOCKS:
            fail(f"network loopback ({codec}): {c['costas_loop']} Costas "
                 f"launches")
    print(f"network loopback on {card} (QPSK tx on the card, {NET_BITS} "
          f"bits a block, dphase {tcfg.dphase}, phase0 {tcfg.phase0}, "
          f"{NET_BLOCKS} blocks; TCP on 127.0.0.1; the Costas receiver on "
          f"the card):", json.dumps(net))

    # ---- 20f. est_lag=2 and the split steps at the fused step's width
    blocks = []
    for b in range(SERVE_WARMUP + SERVE_BLOCKS):
        a = (QPSK_CFO * b * QPSK_N) % (2 * np.pi)
        c_, s_ = float(np.cos(a)), float(np.sin(a))
        blocks.append(((re * c_ - im * s_).contiguous(),
                       (re * s_ + im * c_).contiguous()))
    Mq = QPSK_N // 4
    fast = tstream.make_stream_fast_fn(rcfg)
    st_f = tstream.init_state_fast(rcfg, dev)
    want = []
    for r_, i_ in blocks[:3]:
        y, st_f = fast(st_f, r_, i_)
        want.append(y)
    split = tstream.make_split_serving_step(rcfg)
    got = []
    zero_counts()
    StreamRunner(split, tstream.init_state_fast(rcfg, dev), blocks[:3],
                 sink=got.append, samples_of=lambda x: x[0].shape[0],
                 depth=2, device=dev).run()
    c_split = counts()
    e_split = max(rel_err(torch.from_numpy(g).to(dev), w)
                  for g, w in zip(got, want))
    print(f"split serving step at {QPSK_N} on {card}: against the fast step "
          f"{e_split:.3g} relative over 3 blocks (bound {TOL_SPLIT}); "
          f"launches in the 3 blocks {json.dumps(c_split)}")
    if e_split > TOL_SPLIT:
        fail(f"split step vs fast: {e_split}")
    if (c_split["qpsk_symbol_gemm_scalars"] != 3
            or c_split["qpsk_panels"] != 3):
        fail(f"split step launches {c_split}")
    del want, got

    lag2 = tstream.make_stream_fused_fn(rcfg, est_lag=2)
    rates = {}
    for name, fn, init in (
            ("fused", lambda st, x: fused(st, *x), tstream.init_state_fast),
            ("split", split, tstream.init_state_fast),
            ("est_lag2", lambda st, x: lag2(st, *x),
             tstream.init_state_fused2)):
        outs = []

        def serve(n, keep):
            torch.cuda.synchronize()
            r = StreamRunner(fn, init(rcfg, dev), blocks[:n],
                             sink=outs.append if keep else None,
                             samples_of=lambda x: x[0].shape[0],
                             depth=SERVE_DEPTH, device=dev)
            return r.run().msps

        serve(SERVE_WARMUP, False)
        zero_counts()
        rates[name] = serve(SERVE_BLOCKS, False)
        per_block = {k: v / SERVE_BLOCKS for k, v in counts().items()}
        print(f"{name} step served on {card} ({SERVE_BLOCKS} blocks of "
              f"{QPSK_N}, depth {SERVE_DEPTH}, device-resident, no sink): "
              f"{rates[name]:.1f} Msps; launches a block "
              f"{json.dumps(per_block)}")
        if name == "est_lag2":
            serve(4, True)
            sym = torch.from_numpy(np.concatenate(outs[2:], axis=1)).to(dev)
            rot_v, lag_v, _ = qpsk_align(sym, 2 * Mq, bits)
            ber = qpsk_bit_errors(sym, 2 * Mq, bits, rot_v, lag_v)
            print(f"est_lag=2 at {QPSK_N} on {card}: {ber} bit errors over "
                  f"{2 * sym.shape[1]} bits after its two warm-up blocks "
                  f"(lag {lag_v}, rot {rot_v})")
            if ber:
                fail(f"est_lag=2: {ber} bit errors")
            if per_block["qpsk_symbol_gemm_scalars"] != 1:
                fail(f"est_lag=2 launches {per_block}")
    del blocks, re, im

    # ---- 20g. the Costas receiver served for B streams
    costas_launches += served_streams(step, cfg, dev, card, zero_counts,
                                      counts, floor["costas"]["ns_a_step"])

    # the bound: the largest of the measured chain x n, the bytes and the
    # issue term (recurrence_floor.bound_ms); the kernels line names a
    # bound "bytes" or "operations", and the chain and the issue term are
    # the step's operations, so it says "operations" where either sets it
    rf = recurrence_tools()
    for name, src, lc, err, ms, pms, key, n in (
            ("costas_loop",
             "comms_tpu/ops/demodulation.py:143 (lax.scan; no Pallas "
             "kernel)", costas_launches, max(errs.values()), costas_ms,
             costas_plain_ms, "costas", COSTAS_CHECK[0]),
            ("agc_scan",
             "comms_tpu/ops/agc.py:43 (lax.scan; no Pallas kernel)",
             agc_launches, agc_err, agc_ms, agc_plain_ms, "agc",
             AGC_CHECK)):
        b = rf.bound_ms(floor[key], 1, n)
        print(f"{name} row's bound on {card}: {b['bound_ms']:.4f} ms, set "
              f"by the {b['bound_by']} (chain {b['chain_ms']:.4f}, bytes "
              f"{b['bytes_ms']:.6f}, issue {b['issue_ms']:.6f} ms)")
        rows.append(kernel_row(
            name, "recurrence.cu", src, lc, err, ms, pms, 16 * n + 16, 0.0,
            bound_ms_by=(b["bound_ms"], "bytes" if b["bound_by"] == "bytes"
                         else "operations")))
    print(f"batched Costas rows (B, ms, bound ms): "
          f"{json.dumps([(r['B'], r['ms'], r['bound_ms']) for r in costas_batched])}")
    return rows


def state_gaps(a, b, sps: int) -> dict:
    """The largest gap, leaf by leaf, between two Costas receiver states
    (``costas`` a pair: ``costas_phase``, ``costas_freq``); ``theta`` and
    ``tau`` modulo their periods (2 pi, ``sps``), where a wrap is no
    gap."""
    import torch

    out = {}
    for k in a:
        pairs = (zip(("costas_phase", "costas_freq"), a[k], b[k])
                 if k == "costas" else ((k, a[k], b[k]),))
        for name, x, y in pairs:
            d = (x - y).abs()
            period = {"theta": 2 * np.pi, "tau": float(sps)}.get(name)
            if period is not None:
                d = torch.minimum(d, period - d)
            out[name] = float(d.max())
    return out


def served_streams(step, cfg, dev, card: str, zero_counts, counts,
                   floor_ns: float) -> int:
    """Phase 20g: the Costas receiver ``step`` served for each of
    SERVE_STREAMS streams (each its own channel: seed LINK_SEED + b)
    through ``BatchedStreamRunner``, three routes: ``mode="vmap"`` (the
    batched vmap rule: one Costas launch a round), ``mode="vmap"`` with
    the per-slice rule registered in its place (a launch a stream), and
    ``mode="unroll"``.  Each route: a first pass (copying sinks) for the
    checks and the launches, a second for the rate; the round's host
    enqueue (idle card, median of 5) and device ms; the busy share.  The
    vmap route's first pass records the Costas op's calls (its inputs as
    vmap passes them, strides and all); the calls of the carrier step's
    round and of the last are held to ``costas_loop_batched_plain`` on
    the same inputs, bit for bit.  The vmap and the unroll routes: zero
    bit errors on every stream; vmap's symbols and states against
    unroll's, a block, bit for bit, else within TOL_SPLIT, else within
    TOL_VMAP_SYM and TOL_VMAP_STATE with the same decisions on every
    stream (it prints which); the per-slice rule bit for bit with the
    batched rule.  ``floor_ns``: the Costas chain's measured ns a
    symbol.  Returns the Costas launches of the vmap route's first
    passes."""
    import torch

    from comms_tpu_torch.kernels import _build
    from comms_tpu_torch.kernels import recurrence as R
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.models import qpsk_rx_stream as tstream
    from comms_tpu_torch.runtime import BatchedStreamRunner

    M = cfg.syms_per_block
    main_launches = 0
    checked_rounds = (LINK_STEP_BLOCK, LINK_BLOCKS - 1)
    for S in SERVE_STREAMS:
        chans = [link_channel(LINK_BLOCKS, LINK_BLOCK, LINK_SEED + b)
                 for b in range(S)]
        rounds = [torch.stack([torch.from_numpy(
            p[k * LINK_BLOCK:(k + 1) * LINK_BLOCK]) for _, p in chans])
            .to(dev) for k in range(LINK_BLOCKS)]
        res, recorded = {}, []

        def recording(*args):
            outs = R._costas_op(*args)
            recorded.append((args, outs))
            return outs

        for route in ("vmap", "per_slice", "unroll"):
            mode = "unroll" if route == "unroll" else "vmap"
            try:
                if route == "per_slice":
                    _build.per_slice_vmap(R._costas_op)
                passes = []
                for k in range(2):
                    if route == "vmap":
                        R._costas_op.register_vmap(R.batched_vmap_rule(
                            recording if k == 0 else R._costas_op))
                    outs = [[] for _ in range(S)]
                    zero_counts()
                    r = BatchedStreamRunner(
                        step, [tstream.init_state(cfg, dev)
                               for _ in range(S)],
                        batched_source=rounds,
                        sinks=[o.append for o in outs], depth=SERVE_DEPTH,
                        mode=mode, device=dev)
                    msps = r.run().msps
                    passes.append((msps, outs, r.stream_states(), counts()))
                enqueue = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r.block_fn(r.state, rounds[5])
                    enqueue.append((time.perf_counter() - t0) * 1e3)
                dev_ms = cuda_ms(lambda: r.block_fn(r.state, rounds[5]),
                                 reps=5)
            finally:
                R._costas_op.register_vmap(
                    R.batched_vmap_rule(R._costas_op))
            msps = passes[1][0]
            wall_ms = 1e3 * S * LINK_BLOCK / (msps * 1e6)
            res[route] = {
                "msps": msps, "first_pass_msps": passes[0][0],
                "enqueue_ms": float(np.median(enqueue)),
                "device_ms": dev_ms, "wall_ms": wall_ms,
                "busy": dev_ms / wall_ms,
                "costas_launches_a_round":
                    passes[0][3]["costas_loop"] / LINK_BLOCKS,
                "outs": passes[0][1], "states": passes[0][2]}
            if route == "vmap":
                main_launches += passes[0][3]["costas_loop"]
        v, u = res["vmap"], res["unroll"]
        if v["costas_launches_a_round"] != 1:
            fail(f"Costas receiver, {S} streams under vmap: "
                 f"{v['costas_launches_a_round']} Costas launches a round")
        # the Costas op's calls under vmap against the batched plain
        # version on the same inputs
        if len(recorded) != LINK_BLOCKS:
            fail(f"{S} streams: {len(recorded)} Costas op calls recorded "
                 f"in {LINK_BLOCKS} rounds")
        for k in checked_rounds:
            (xr, xi, ph, fr, order, alpha, beta), got = recorded[k]
            want = R.costas_loop_batched_plain(xr, xi, ph, fr, alpha, beta,
                                               order)
            if xr.shape != (S, M) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                err = max(max_err(g, w) for g, w in zip(got, want))
                fail(f"{S} streams, round {k}: the Costas op under vmap "
                     f"({tuple(xr.shape)}, strides {xr.stride()}) is not "
                     f"bit-equal to the batched plain version (max "
                     f"{err:.3g})")
        print(f"Costas op under vmap, {S} streams on {card}: rounds "
              f"{list(checked_rounds)} ({tuple(recorded[0][0][0].shape)} "
              f"planes, strides {recorded[0][0][0].stride()} and "
              f"{recorded[0][0][1].stride()}) bit for bit with "
              f"costas_loop_batched_plain on the same inputs")
        del recorded[:]

        def symbols(route, b):
            a = np.concatenate(res[route]["outs"][b][LINK_SKIP:])
            return a[:, 0] + 1j * a[:, 1]

        errs = {}
        for route in ("vmap", "unroll"):
            errs[route] = []
            for b in range(S):
                e, m, _, _ = best_align(symbols(route, b), chans[b][0],
                                        LINK_SKIP * M)
                errs[route].append(e)
                if e or m <= 60000:
                    fail(f"Costas receiver, {S} streams ({route}): stream "
                         f"{b} {e} bit errors over {m} bits")
        for b in range(S):
            if not all(np.array_equal(a, c) for a, c in
                       zip(res["per_slice"]["outs"][b], v["outs"][b])):
                fail(f"{S} streams: the per-slice rule's symbols differ"
                     f" from the batched rule's (stream {b})")
        sym_d = max(float(np.abs(a - c).max()) for b in range(S)
                    for a, c in zip(v["outs"][b], u["outs"][b]))
        gaps = {}
        for b in range(S):
            for key, d in state_gaps(v["states"][b], u["states"][b],
                                     cfg.sps).items():
                gaps[key] = max(gaps.get(key, 0.0), d)
        st_d = max(gaps.values())
        same_bits = all(np.array_equal(trx.decide_bits(symbols("vmap", b)),
                                       trx.decide_bits(symbols("unroll", b)))
                        for b in range(S))
        if sym_d == 0 and st_d == 0:
            case = "bit for bit"
        elif max(sym_d, st_d) <= TOL_SPLIT:
            case = "within TOL_SPLIT"
        elif sym_d <= TOL_VMAP_SYM and st_d <= TOL_VMAP_STATE and same_bits:
            case = ("within TOL_VMAP_SYM and TOL_VMAP_STATE, decisions bit "
                    "for bit (the batched frequency-estimate sum and "
                    "matched-filter GEMM round otherwise, and the Costas "
                    "detector's +-pi branch carries it)")
        else:
            case = None
        summary = {k: {q: w for q, w in d.items()
                       if q not in ("outs", "states")}
                   for k, d in res.items()}
        print(f"Costas receiver served for {S} streams on {card} "
              f"({LINK_BLOCKS} rounds of {S} x {LINK_BLOCK} samples, each "
              f"stream its own channel, depth {SERVE_DEPTH}, copying "
              f"sinks; the Costas chain floor x {M} symbols "
              f"{floor_ns * M * 1e-6:.4f} ms a round): "
              f"{json.dumps(summary)}; bit errors after {LINK_SKIP} blocks "
              f"{json.dumps(errs)}; vmap against unroll over the "
              f"{LINK_BLOCKS} blocks: symbols max {sym_d:.3g}, states "
              f"{json.dumps({k: float(f'{d:.3g}') for k, d in gaps.items()})}"
              f": {case or 'beyond the limits, or decisions differ'}")
        if case is None:
            fail(f"Costas receiver, {S} streams: vmap against unroll: "
                 f"symbols {sym_d:.3g} (limit {TOL_VMAP_SYM}), states "
                 f"{st_d:.3g} (limit {TOL_VMAP_STATE}), the same decisions "
                 f"{same_bits}")
        del rounds, res
    return main_launches


# ---------------------------------------------------------------- phase 21
EDGE_EXAMPLE_BLOCKS = 3          # multi_stream_serving: blocks a capture
EDGE_SERVE_STREAMS = 2
EDGE_FM_RADIO_BLOCKS = 8         # fm_radio: 262,144-sample blocks
EDGE_READ_REPS = 3
KERNEL_MODULES = ("fm_chain", "decim_fir", "fir", "channelizer",
                  "band_monitor", "qpsk_sym", "panel_reduce", "fft",
                  "fft_big", "halo_ring", "recurrence", "lag1_demod")


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by module (and entry where a
    module counts its entries apart)."""
    import importlib

    out = {}
    for name in KERNEL_MODULES:
        c = importlib.import_module(f"comms_tpu_torch.kernels.{name}").launches
        if isinstance(c, dict):
            out.update({f"{name}.{k}": v for k, v in c.items()})
        else:
            out[name] = c
    return out


def zero_counts() -> None:
    import importlib

    for name in KERNEL_MODULES:
        mod = importlib.import_module(f"comms_tpu_torch.kernels.{name}")
        if isinstance(mod.launches, dict):
            for k in mod.launches:
                mod.launches[k] = 0
        else:
            mod.launches = 0


def launched() -> dict:
    """The counts that are not 0."""
    return {k: v for k, v in launch_counts().items() if v}


class python_io:
    """Inside the block the native reader's construction fails, so
    ``run_file`` takes its numpy fallback (as where no toolchain is)."""

    def __enter__(self):
        from comms_tpu_torch import native

        def unavailable(*args, **kwargs):
            raise RuntimeError("native reader made unavailable")
        self._native, self._real = native, native.NativeBlockReader
        native.NativeBlockReader = unavailable

    def __exit__(self, *exc):
        self._native.NativeBlockReader = self._real


def read_rates(path: Path, nbytes: int) -> dict:
    """GB/s of reading the capture a block of ``nbytes`` at a time, through
    the native reader (its thread reading ahead, the blocks borrowed and
    released) and through ``np.fromfile`` (a new array a block); the file
    was just written, so both read from the page cache (warm).  Also the
    seconds of the native reader's construction alone ("open": it
    allocates and zero-fills its ring of three blocks before its thread
    starts), which the native rate includes."""
    from comms_tpu_torch.native import NativeBlockReader

    size = path.stat().st_size
    open_s = []

    def native_read():
        t0 = time.perf_counter()
        with NativeBlockReader(path, block_bytes=nbytes) as rd:
            open_s.append(time.perf_counter() - t0)
            got = 0
            while (b := rd.next_block()) is not None:
                got += b.size
        return got

    def numpy_read():
        got = 0
        with open(path, "rb") as f:
            while (b := np.fromfile(f, np.uint8, count=nbytes)).size:
                got += b.size
        return got

    rates = {"native": [], "numpy": []}
    for _ in range(EDGE_READ_REPS):
        for name, fn in (("native", native_read), ("numpy", numpy_read)):
            t0 = time.perf_counter()
            if fn() != size:
                fail(f"{name} read returned the wrong byte count")
            rates[name].append(size / (time.perf_counter() - t0) / 1e9)
    out = {k: statistics.median(v) for k, v in rates.items()}
    out["open_s"] = statistics.median(open_s)
    return out


def wav_frames(path) -> np.ndarray:
    import wave

    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def pcm16(x) -> np.ndarray:
    """What a WavSink writes for float samples ``x``."""
    return np.clip(np.round(np.asarray(x, np.float64) * 32767.0),
                   -32768, 32767).astype("<i2")


def edges_phases(dev, card: str, iq: np.ndarray, w: np.ndarray) -> None:
    """Phase 21: the native reader under ``run_file``, the capture served
    from ``FileReplayRadio`` into a ``WavSink``, ``play_audio``, and each
    example's ``main`` on the card."""
    import os

    import torch

    from comms_tpu_torch import native
    from comms_tpu_torch.hardware import FileReplayRadio
    from comms_tpu_torch.io.audio import WavSink
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.models import play_audio
    from comms_tpu_torch.native import loader
    from comms_tpu_torch.runtime import StreamRunner

    # ---- the reader (built in phase 2): part of the path, no fallback
    if not native.native_available():
        fail(f"the native reader does not build: {loader._build_error}")

    cfg = fm.FmReceiverConfig(block=BLOCK)
    n_total = iq.shape[0]
    full = 3 * (BLOCK // 25)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "capture.iq"
        iq.tofile(path)

        # ---- run_file at full width through the native reader
        zero_counts()
        t0 = time.perf_counter()
        audio = fm.run_file(path, cfg, device=dev)
        first_s = time.perf_counter() - t0
        if launched() != {"fm_chain": 3}:
            fail(f"run_file: launches {launched()}, expected 3 of K1")
        with python_io():
            fallback = fm.run_file(path, cfg, device=dev)
        if not np.array_equal(audio, fallback):
            fail("run_file: the native reader's audio differs from the "
                 "numpy reads'")
        want_len = fm._tail_valid_out(cfg, n_total)
        if audio.shape != (want_len,) or not np.isfinite(audio).all():
            fail(f"run_file: shape {audio.shape}, want ({want_len},)")
        corr = demod_matches_tones(audio, w)
        if corr < 0.99:
            fail(f"run_file audio does not follow the tones: {corr}")
        print(f"run_file at {BLOCK} (3 blocks + {RAGGED}): native reader "
              f"= numpy reads bit for bit, K1 launches 3, tone "
              f"correlation {corr:.5f}, first call {first_s:.3f} s")

        # ---- timing: the readers alone, then run_file with each
        rates = read_rates(path, 2 * BLOCK)
        secs = {"native": [], "numpy": []}
        for _ in range(2):
            for name in ("native", "numpy"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "native":
                    fm.run_file(path, cfg, device=dev)
                else:
                    with python_io():
                        fm.run_file(path, cfg, device=dev)
                secs[name].append((time.perf_counter() - t0) / 4)
        print(f"read GB/s over the {path.stat().st_size} B capture "
              f"(page cache, warm; median of {EDGE_READ_REPS}) on {card}: "
              f"native {rates['native']:.3f} (of which its construction, "
              f"the ring's allocation, {1e3 * rates['open_s']:.1f} ms), "
              f"np.fromfile {rates['numpy']:.3f}")
        print(f"run_file s a block (wall / 4: 3 blocks of {BLOCK} and the "
              f"padded tail) on {card}: native "
              f"{json.dumps([round(x, 5) for x in secs['native']])}, "
              f"numpy {json.dumps([round(x, 5) for x in secs['numpy']])}")

        # ---- served from the radio into a WAV
        fblock = fm.make_fused_block_fn(cfg)
        radio = FileReplayRadio(path, "u8", loop_forever=False)

        def radio_blocks():
            while (x := radio.recv_samples(BLOCK)).shape[0] == BLOCK:
                yield np.ascontiguousarray(x[:, 0]), \
                    np.ascontiguousarray(x[:, 1])

        peak = float(np.max(np.abs(audio)))
        served = []
        wav = tmp / "served.wav"
        zero_counts()
        with WavSink(wav, channels=1, sample_rate=45600) as sink:
            def keep(a):
                served.append(a)
                sink.write(a / peak)
            meter = StreamRunner(
                lambda s, x: fblock(s, *x), fm.fused_init_state(dev),
                radio_blocks(), sink=keep,
                samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
                device=dev).run()
        served = np.concatenate(served)
        if launched() != {"fm_chain": 3}:
            fail(f"served radio: launches {launched()}, expected 3 of K1")
        if not np.array_equal(served, audio[:full]):
            fail("the radio-served audio differs from run_file's blocks")
        if not np.array_equal(wav_frames(wav), pcm16(served / peak)):
            fail("the served WAV's frames are not the scaled audio")
        print(f"FileReplayRadio -> StreamRunner (fused step, depth "
              f"{SERVE_DEPTH}) -> WavSink: 3 blocks bit-equal to run_file's, "
              f"{meter.msps:.1f} Msps from host blocks, K1 launches 3")

        # ---- play_audio: f32 and i16 PCM of that audio
        scaled = (served / peak).astype(np.float32)
        scaled.tofile(tmp / "pcm.f32")
        pcm16(scaled).tofile(tmp / "pcm.i16")
        n32 = play_audio.play_file(tmp / "pcm.f32", tmp / "f32.wav",
                                   sample_rate=45600)
        n16 = play_audio.play_file(tmp / "pcm.i16", tmp / "i16.wav",
                                   dtype="i16", sample_rate=45600)
        i16 = pcm16(scaled).astype(np.float32) / np.float32(32768.0)
        if (n32, n16) != (full, full) or not (
                np.array_equal(wav_frames(tmp / "f32.wav"), pcm16(scaled))
                and np.array_equal(wav_frames(tmp / "i16.wav"), pcm16(i16))):
            fail("play_audio's WAV frames differ from its PCM input")
        print(f"play_audio: {full} samples as f32 and as i16, frames equal")

        # ---- each example's main on the card
        ex_dir = tmp / "examples"
        ex_dir.mkdir()
        here = os.getcwd()
        os.chdir(ex_dir)
        try:
            edge_examples(dev, card, iq, w)
        finally:
            os.chdir(here)


def run_example(name: str, fn, expect: dict):
    """Run ``fn`` (an example's main) with every kernel count at 0 before
    it; the kernels in ``expect`` must have launched that many times
    (None: at least once), and no other kernel may have."""
    import torch

    zero_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launched()
    for k, n in expect.items():
        if (got.get(k, 0) == 0) if n is None else (got.get(k, 0) != n):
            fail(f"example {name}: launches {got}, expected {expect}")
    if set(got) - set(expect):
        fail(f"example {name}: unexpected launches {got}")
    return result, secs, got


def edge_examples(dev, card: str, iq: np.ndarray, w: np.ndarray) -> None:
    """The eleven examples in-process on the card (cwd: a scratch
    directory), one line each: seconds, launches, result."""
    import threading

    import torch

    from comms_tpu_torch.examples import (
        bpsk_mod, channelizer_demo, fm_band_monitor, fm_radio,
        fused_sharded_fm, multi_stream_serving, play_audio as play_ex,
        qpsk_mod, qpsk_receiver, qpsk_zmq, wideband_psd)
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.models import qpsk_tx

    def line(name, secs, got, what):
        print(f"example {name} on {card}: {secs:.3f} s, launches "
              f"{json.dumps(got)}, {what}")

    # fm_radio: the default (dense, 262,144) configuration, no kernel
    n = EDGE_FM_RADIO_BLOCKS * ENTRY_BLOCK + RAGGED
    iq[:n].tofile("fm.u8")
    got_n, secs, got = run_example(
        "fm_radio", lambda: fm_radio.main(["fm.u8", "fm.wav"]), {})
    frames = wav_frames("fm.wav")
    corr = demod_matches_tones(frames.astype(np.float64), w)
    if got_n != frames.shape[0] or corr < 0.99:
        fail(f"fm_radio: {frames.shape[0]} frames, tone correlation {corr}")
    line("fm_radio", secs, got, f"{got_n} samples, WAV tone correlation "
         f"{corr:.5f}")

    # play_audio: host only
    np.linspace(-1, 1, 1 << 20, dtype=np.float32).tofile("pcm.f32")
    got_n, secs, got = run_example(
        "play_audio", lambda: play_ex.main(["pcm.f32", "pcm.wav"]), {})
    if not np.array_equal(wav_frames("pcm.wav"),
                          pcm16(np.linspace(-1, 1, 1 << 20,
                                            dtype=np.float32))):
        fail("play_audio example: frames differ")
    line("play_audio", secs, got, f"{got_n} samples, frames equal")

    # multi_stream_serving: 2 streams, the fused step (K1) a block
    block = 16 * fm.FUSED_BLOCK_QUANTUM
    caps = []
    for s in range(EDGE_SERVE_STREAMS):
        caps.append(f"stream{s}.u8")
        iq[s * block:(s + EDGE_EXAMPLE_BLOCKS) * block].tofile(caps[-1])
    rounds = EDGE_EXAMPLE_BLOCKS
    meter, secs, got = run_example(
        "multi_stream_serving", lambda: multi_stream_serving.main(caps),
        {"fm_chain": EDGE_SERVE_STREAMS * rounds})
    per = block // 25
    for c in caps:
        a = fm.run_file(c, fm.FmReceiverConfig(block=block), device=dev)
        want = np.concatenate([
            pcm16(a[b * per:(b + 1) * per]
                  / (np.max(np.abs(a[b * per:(b + 1) * per])) or 1.0))
            for b in range(rounds)])
        if not np.array_equal(wav_frames(c + ".wav"), want):
            fail(f"multi_stream_serving: {c}.wav differs from run_file's "
                 f"blocks")
    line("multi_stream_serving", secs, got,
         f"{EDGE_SERVE_STREAMS} streams x {rounds} blocks of {block}, "
         f"{meter.msps:.1f} Msps, WAVs equal run_file's blocks")

    # qpsk_receiver: the Costas receiver, zero bit errors
    (errs, m), secs, got = run_example(
        "qpsk_receiver", lambda: qpsk_receiver.main([]),
        {"recurrence.costas_loop": 24})
    if errs:
        fail(f"qpsk_receiver: {errs} bit errors of {m}")
    line("qpsk_receiver", secs, got, f"{errs} bit errors of {m}")

    # fm_band_monitor: the staged step at BM_BLOCK, K=16 (K8, the lag-1
    # demod, K2)
    re, im, tones = station_capture(BM_BLOCK, BM_K, 21, dev)
    torch.stack([re, im], dim=-1).cpu().numpy().tofile("wide.f32")
    audio, secs, got = run_example(
        "fm_band_monitor",
        lambda: fm_band_monitor.main(["wide.f32", str(BM_K)]),
        {"channelizer": 1, "decim_fir": None, "lag1_demod": 1})
    ratios = tone_ratios(torch.from_numpy(audio), tones, 4)
    if not np.isfinite(audio).all() or min(ratios) <= 10:
        fail(f"fm_band_monitor: tone ratios {ratios}")
    line("fm_band_monitor", secs, got, f"{BM_K} channels of "
         f"{audio.shape[1]} samples, least tone ratio {min(ratios):.1f}")

    # channelizer_demo: K=64 on K8
    (tones64, found), secs, got = run_example(
        "channelizer_demo", lambda: channelizer_demo.main([]),
        {"channelizer": 1})
    if found != tones64:
        fail(f"channelizer_demo: tones {tones64}, found {found}")
    line("channelizer_demo", secs, got, f"tones {found} found")

    # bpsk_mod / qpsk_mod: 10 blocks on the card against the CPU
    for name, mod in (("bpsk_mod", bpsk_mod), ("qpsk_mod", qpsk_mod)):
        n_out, secs, got = run_example(
            name, lambda: mod.main(["10", name + ".bin"]), {})
        mod.main(["10", name + ".cpu.bin", "--device", "cpu"])
        a = np.fromfile(name + ".bin", "<i2").astype(np.int64)
        b = np.fromfile(name + ".cpu.bin", "<i2").astype(np.int64)
        diff = np.abs(a - b).reshape(-1, 2).max(axis=1)
        if a.shape != b.shape or diff.max() > 1 or np.mean(diff > 0) >= 0.01:
            fail(f"{name}: the card's file differs from the CPU's beyond "
                 f"1 LSB")
        line(name, secs, got, f"{n_out} samples, file "
             f"{'equal to' if diff.max() == 0 else 'within 1 LSB of'} the "
             f"CPU's ({int(np.sum(diff > 0))} samples differ)")

    # qpsk_zmq: send on the card, receive in a thread (TCP)
    ep = f"tcp://127.0.0.1:{free_port()}"
    rx = {}
    t = threading.Thread(target=lambda: rx.update(
        blocks=qpsk_zmq.main(["recv", ep, "10"])))
    t.start()
    sent, secs, got = run_example(
        "qpsk_zmq", lambda: qpsk_zmq.main(["send", ep, "10"]), {})
    t.join(timeout=120)
    if t.is_alive() or "blocks" not in rx:
        fail("qpsk_zmq: the receiver did not finish")
    cfg = qpsk_tx.QpskTxConfig()
    blk, st = qpsk_tx.make_block_fn(cfg), qpsk_tx.init_state(cfg, 0, dev)
    want = []
    for _ in range(10):
        out, st = blk(st)
        p = out.cpu().numpy().astype(np.float32) / cfg.scale
        want.append((p[:, 0] + 1j * p[:, 1]).astype(np.complex64))
    recv = np.concatenate(rx["blocks"])
    if recv.shape[0] != sent or not np.array_equal(recv,
                                                   np.concatenate(want)):
        fail("qpsk_zmq: the received samples differ from the sent blocks")
    line("qpsk_zmq", secs, got, f"{sent} samples over TCP, equal to the "
         f"transmitter's blocks")

    # wideband_psd and fused_sharded_fm: 8 shards on the one card.  The
    # PSD on 8 shards is the distributed FFT (torch.fft.fft a shard, as
    # the JAX package's jnp.fft.fft): no kernel of the port's.
    top, secs, got = run_example("wideband_psd",
                                 lambda: wideband_psd.main([]), {})
    line("wideband_psd", secs, got, f"carriers at bins {top}")
    exact, secs, got = run_example(
        "fused_sharded_fm", lambda: fused_sharded_fm.main([]),
        {"fm_chain": 16, "halo_ring": None})
    line("fused_sharded_fm", secs, got, "sharded == sequential bit for bit")


# Phase 22, the multi-process slice, in two spawns of worker processes on
# the one card (CUDA contexts time-sliced), each program against the same
# program on a mesh of as many shards in one process, bit for bit.  The
# first spawn, 2 processes x 4 shards of an 8-shard pod mesh: the psum,
# K12's cross-process form at the fused FM raw tails (3 calls), the fused
# FM step at BLOCK (3 blocks chained from stream start: its audio and
# state compared in this process), the wideband chain at BLOCK (2^25 does
# not divide by the chain's 25) and the QPSK receiver at QPSK_N, the
# frequency-sharded PSD at BIG[0] (the dfft's two all-to-alls across the
# processes on K12), dry-run config 8.  Both spawns, 2 x 4 and then 4
# processes x 2 shards: the 2-D band monitor at BM_BLOCK, K = BM_K, on a
# 2 x 4 mesh_2d laid over the processes, two blocks chained (in the 4 x 2
# layout each time row spans two processes and the corner turn crosses).
# The 4 x 2 spawn also times one corner turn at the 2-D step's shapes on
# the device route beside the gloo route.
POD_PROCS = 2
POD_LOCAL = 4
POD4_PROCS = 4
POD4_LOCAL = 2
POD_DEVICE = "cuda"
POD_BLOCKS = 3
POD_BM_BLOCKS = 2
POD_SEED = 45
POD_TIMEOUT_S = 300
POD_K12_REPS = 21
POD_K12_HOST_CALLS = 100
POD_CT_HOST_CALLS = 20


def same_shards(rank: int, got, want, what: str) -> None:
    """Each of this process's shards of ``got`` (a Sharded value) equals
    its slice of the one-process ``want``, bit for bit."""
    import torch

    for s in got.addressable_shards:
        if not torch.equal(s.data, want[s.index]):
            fail(f"rank {rank}: {what}: shard {s.index} differs from the "
                 f"mesh in one process")


def same_everywhere(rank: int, tensors, what: str) -> None:
    """The tensors' integer checksums agree in every process (an input
    made in each process from one seed)."""
    import torch
    import torch.distributed

    mine = [int(t.reshape(-1).view(torch.int32).to(torch.int64).sum())
            for t in tensors]
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, mine)
    if any(x != mine for x in every):
        fail(f"rank {rank}: {what} differ between processes")


def band2d_crossings(mesh) -> dict:
    """For each collective of one 2-D band monitor step, 1 where this
    process sends a pair into another process's window (then K12 launches
    once for it: every call here has fewer than 128 pairs), else 0.  The
    mesh is (time, chan), row-major."""
    own, nc, size = mesh.owners, mesh.shape["chan"], mesh.size
    me = mesh.rank
    mine = mesh.local
    rows = int(any(s + nc < size and own[s + nc] != me for s in mine))
    return {
        "channelizer_halo": int(any(s + 1 < size and own[s + 1] != me
                                    for s in mine)),
        "stream_ctx": int(size - 1 in mine and len(set(own)) > 1),
        "corner_turn": int(any(own[s // nc * nc + c] != me for s in mine
                               for c in range(nc))),
        "demod_halo": rows, "audio_halo": rows}


class counted_all_to_all:
    """Inside the block ``sharding.all_to_all`` adds the cross-process K12
    launches it makes to ``self.cross`` (the corner turn's and the dfft's
    share of ``halo_ring.cross_launches``)."""

    def __enter__(self):
        from comms_tpu_torch.kernels import halo_ring as HR
        from comms_tpu_torch.parallel import sharding as sh

        self.cross, self._sh, self._real = 0, sh, sh.all_to_all

        def counted(*args, **kwargs):
            c0 = HR.cross_launches
            out = self._real(*args, **kwargs)
            self.cross += HR.cross_launches - c0
            return out
        sh.all_to_all = counted
        return self

    def __exit__(self, *exc):
        self._sh.all_to_all = self._real


def pod_worker(rank: int, procs: int, local: int, port: int,
               out: Path) -> None:
    """One process of phase 22 (``chip_smoke.py --pod-worker RANK PROCS
    LOCAL PORT DIR``): joins the process group of ``procs`` processes,
    runs the spawn's programs (the phase's comment above) over meshes of
    ``local`` shards a process and over meshes of as many shards in this
    process, holds its own shards bit for bit, writes its fused FM audio
    and state to ``DIR``, prints one ``POD_WORKER`` JSON line of counts
    and times, then ``POD_WORKER_OK``.  Any disagreement exits non-zero.
    The captures whose phase is a float64 cumulative sum (the FM
    capture, the band monitor's stations) come from the parent
    (``DIR/*.npy``): made on each card apart they may round otherwise in
    the last bit; the others are made here from one seed and their
    checksums held equal across the processes."""
    import torch

    from comms_tpu_torch.parallel import dryrun, multihost

    t_start = time.perf_counter()
    multihost.init(f"127.0.0.1:{port}", procs, rank)
    mesh = multihost.pod_mesh(local_shards=local, device=POD_DEVICE)
    dev = mesh.devices[mesh.local[0]]
    rep = {"rank": rank, "procs": procs, "device": str(dev)}
    first = (procs, local) == (POD_PROCS, POD_LOCAL)
    if first:
        pod_time_programs(rank, mesh, dev, out, rep)
        pod_psd(rank, mesh, dev, rep)
    pod_band2d(rank, procs, dev, out, rep)
    if not first:
        pod_corner_turn(rank, dev, rep)
    else:
        dryrun.dryrun_multihost(local, dev)      # config 8 across processes
    torch.cuda.synchronize()
    rep["seconds"] = time.perf_counter() - t_start
    print("POD_WORKER " + json.dumps(rep), flush=True)
    multihost.shutdown()
    print(f"POD_WORKER_OK {rank}", flush=True)


def pod_time_programs(rank: int, mesh, dev, out: Path, rep: dict) -> None:
    """The first spawn's programs on the 8-shard pod mesh: the psum, K12
    across processes, the fused FM step, the wideband chain, the QPSK
    receiver."""
    import torch
    import torch.distributed

    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.parallel import fused_wideband as fw
    from comms_tpu_torch.parallel import multihost
    from comms_tpu_torch.parallel import qpsk_rx_sharded as qs
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband as wb

    one = sh.time_mesh(mesh.size, device=dev)
    tail = fm.FUSED_TAIL_SAMPLES

    def mine(x):
        per = x.shape[0] // POD_PROCS
        return multihost.host_feed(x[rank * per:(rank + 1) * per], mesh)

    # ---- the psum: every shard's part summed in shard order
    tot = sh.psum([torch.tensor(float(s), device=dev) for s in mesh.local],
                  mesh)
    if any(float(t) != sum(range(mesh.size)) for t in tot):
        fail(f"rank {rank}: psum {[float(t) for t in tot]}")

    # ---- K12 across processes at the fused raw tails: two u8 planes, 8
    # shards of BLOCK / 8, 25,669-byte tails, the ring wrapped
    re, im = torch.from_numpy(np.load(out / "fm_u8.npy")).to(dev).unbind(0)
    planes = [list(torch.chunk(p[:BLOCK], mesh.size)) for p in (re, im)]
    rings = [[x if s in mesh.slot else None for s, x in enumerate(p)]
             for p in planes]
    owners = [mesh.owners] * len(planes)
    want = HR.exchange(planes, tail)
    HR.cross_launches = 0
    for _ in range(3):
        got = HR.exchange_across(rings, owners, tail)
        for g, w in zip(got, want):
            for s in mesh.local:
                if not torch.equal(g[s], w[s]):
                    fail(f"rank {rank}: K12 across processes differs from "
                         f"the exchange in one process at shard {s}")
    torch.cuda.synchronize()
    if HR.cross_launches != 3:
        fail(f"rank {rank}: {HR.cross_launches} cross-process K12 launches "
             f"in 3 calls")
    ev_ms = []
    for _ in range(POD_K12_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        HR.exchange_across(rings, owners, tail)
        b.record()
        b.synchronize()
        ev_ms.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(POD_K12_HOST_CALLS):
        HR.exchange_across(rings, owners, tail)
    host_us = (time.perf_counter() - t0) / POD_K12_HOST_CALLS * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(POD_K12_HOST_CALLS):
        torch.distributed.barrier()
    barrier_us = (time.perf_counter() - t0) / POD_K12_HOST_CALLS * 1e6
    cpu_rings = [[None if x is None else x[-tail:].cpu() for x in r]
                 for r in rings]
    plain = []
    for _ in range(POD_K12_REPS):
        t0 = time.perf_counter()
        got_cpu = HR.exchange_across(cpu_rings, owners, tail)
        plain.append((time.perf_counter() - t0) * 1e3)
    for g, w in zip(got_cpu, want):
        for s in mesh.local:
            if not torch.equal(g[s], w[s].cpu()):
                fail(f"rank {rank}: the plain cross-process exchange differs")
    rep["k12"] = {"device_ms": statistics.median(ev_ms),
                  "host_us": host_us, "barrier_us": barrier_us,
                  "plain_ms": statistics.median(plain),
                  "pairs": 2 * mesh.size, "bytes_each": tail}

    # ---- the main path: the fused FM step (K1 per shard, K12 raw tails),
    # 3 blocks chained from stream start; counts from 0 just before
    step = fw.make_sharded_fused_step(mesh, block=BLOCK)
    blocks = [(re[b * BLOCK:(b + 1) * BLOCK], im[b * BLOCK:(b + 1) * BLOCK])
              for b in range(POD_BLOCKS)]

    def run_fused():
        st, audio = fm.fused_init_state(dev), []
        for r_, i_ in blocks:
            a, st = step(st, mine(r_), mine(i_))
            audio.append(a)
        return audio, st

    zero_counts()
    HR.cross_launches = 0
    audio, st = run_fused()
    torch.cuda.synchronize()
    rep["fused_launches"] = launched()
    rep["fused_cross_launches"] = HR.cross_launches
    expect = {"fm_chain": POD_BLOCKS * POD_LOCAL,
              "halo_ring": POD_BLOCKS * (1 + rank)}
    if rep["fused_launches"] != expect or HR.cross_launches != expect[
            "halo_ring"]:
        fail(f"rank {rank}: fused step launches {rep['fused_launches']}, "
             f"cross-process K12 {HR.cross_launches}; expected {expect}")
    torch.save({"audio": [torch.cat([s.data for s in a.addressable_shards])
                          .cpu() for a in audio],
                "lo": audio[0].addressable_shards[0].index[0].start,
                "state": {k: v.cpu() for k, v in st.items()}},
               out / f"fused_{rank}.pt")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fused()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / POD_BLOCKS)
    rep["fused_ms_a_block"] = statistics.median(walls)

    # ---- the wideband chain at BLOCK, one block, and its state
    pairs = torch.stack([re[:BLOCK], im[:BLOCK]], -1).float().sub_(
        127.5).div_(127.5)
    cfg = wb.WidebandConfig(fm.FM_LPF_TAPS, block=BLOCK, dec1=5, dec2=5)
    zero_counts()
    (a_p, f_p), st_p = wb.make_sharded_step(cfg, mesh)(wb.init_state(cfg, dev),
                                                       mine(pairs))
    torch.cuda.synchronize()
    rep["wideband_launches"] = launched()
    (a_1, f_1), st_1 = wb.make_sharded_step(cfg, one)(wb.init_state(cfg, dev),
                                                      pairs)
    same_shards(rank, a_p, a_1, "wideband audio")
    if not (torch.equal(f_p, f_1)
            and all(torch.equal(x, y) for x, y in zip(st_p, st_1))):
        fail(f"rank {rank}: wideband estimate or state differs")
    del pairs, a_p, a_1

    # ---- the QPSK receiver at QPSK_N (K5 per shard)
    qre, qim, _ = qpsk_capture(dev, seed=7)
    same_everywhere(rank, (qre, qim), "the QPSK captures")
    qcfg = trx.QpskRxConfig()
    zero_counts()
    sym_p, d_p = qs.make_sharded_rx_step(qcfg, mesh)(mine(qre), mine(qim))
    torch.cuda.synchronize()
    rep["qpsk_launches"] = launched()
    sym_1, d_1 = qs.make_sharded_rx_step(qcfg, one)(qre, qim)
    same_shards(rank, sym_p, sym_1, "QPSK symbols")
    if d_p.keys() != d_1.keys() or not all(torch.equal(d_p[k], d_1[k])
                                           for k in d_p):
        fail(f"rank {rank}: QPSK estimates differ")
    for name in ("wideband_launches", "qpsk_launches"):
        if not rep[name].get("halo_ring"):
            fail(f"rank {rank}: {name} {rep[name]}: no K12 launch")
    if rep["qpsk_launches"].get("qpsk_sym.qpsk_panels") != POD_LOCAL:
        fail(f"rank {rank}: QPSK launches {rep['qpsk_launches']}")
    del qre, qim, sym_p, sym_1



def pod_psd(rank: int, mesh, dev, rep: dict) -> None:
    """The frequency-sharded PSD (the dfft route) at BIG[0] across the
    processes against the 8-shard mesh in this process, bit for bit; the
    dfft's two all-to-alls cross on K12, one cross-process launch each on
    every rank."""
    import torch

    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband as wb

    F, B = BIG[0]
    g = torch.Generator(device=dev)
    g.manual_seed(POD_SEED + 1)
    pairs = (torch.randn(2, B, F, generator=g, device=dev) + 0.05).permute(
        1, 2, 0).contiguous()                             # [B, F, 2]
    same_everywhere(rank, (pairs,), "the PSD's segments")
    psd = wb.make_sharded_psd(F, mesh)
    zero_counts()
    HR.cross_launches = 0
    with counted_all_to_all() as a2a:
        got = psd(pairs)
    torch.cuda.synchronize()
    rep["psd"] = {"launches": launched(), "cross_launches": HR.cross_launches,
                  "all_to_all_cross": a2a.cross}
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psd(pairs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    rep["psd"]["ms"] = statistics.median(walls)
    same_shards(rank, got, wb.make_sharded_psd(
        F, sh.time_mesh(mesh.size, device=dev))(pairs),
        "frequency-sharded PSD")
    if a2a.cross != 2 or rep["psd"]["cross_launches"] != 2:
        fail(f"rank {rank}: the dfft's all-to-alls made {a2a.cross} "
             f"cross-process K12 launches of {rep['psd']['cross_launches']},"
             f" expected 2")


def pod_band2d(rank: int, procs: int, dev, out: Path, rep: dict) -> None:
    """The 2-D band monitor at BM_BLOCK, K = BM_K on a 2 x 4 mesh_2d laid
    over the processes, POD_BM_BLOCKS blocks chained from stream start fed
    through ``host_feed`` over ("time", "chan"), against the same blocks on
    a 2 x 4 mesh in this process, bit for bit: audio and power shards, the
    state whole.  Counts from 0 just before: K8 and K2 once a local shard a
    block, K12's cross-process launches those of ``band2d_crossings``
    (the corner turn's counted apart)."""
    import torch

    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.models import fm_band_monitor as bm
    from comms_tpu_torch.parallel import multihost
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband2d as w2

    pairs = torch.from_numpy(np.load(out / "bm_pairs.npy")).to(dev)
    cfg = bm.BandMonitorConfig(num_channels=BM_K, block=BM_BLOCK)
    m2 = w2.mesh_2d(2, 4, device=POD_DEVICE)
    step = w2.make_sharded_band_monitor_2d(cfg, m2)
    per = BM_BLOCK // procs
    blocks = [pairs[b * BM_BLOCK:(b + 1) * BM_BLOCK]
              for b in range(POD_BM_BLOCKS)]
    feeds = [multihost.host_feed(x[rank * per:(rank + 1) * per], m2,
                                 ("time", "chan")) for x in blocks]

    def run():
        st, outs = bm.init_state(cfg, dev), []
        for f in feeds:
            o, st = step(st, f)
            outs.append(o)
        return outs, st

    zero_counts()
    HR.cross_launches = 0
    with counted_all_to_all() as a2a:
        outs, st = run()
    torch.cuda.synchronize()
    counts = launched()
    cross = HR.cross_launches
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / POD_BM_BLOCKS)
    ref = w2.make_sharded_band_monitor_2d(
        cfg, sh.Mesh([dev] * m2.size, (2, 4), ("time", "chan")))
    st1 = bm.init_state(cfg, dev)
    for b, ((a, pw), x) in enumerate(zip(outs, blocks)):
        (a1, pw1), st1 = ref(st1, x)
        if (a.shape != (BM_K, BM_BLOCK // BM_K // cfg.audio_dec)
                or pw.shape != (BM_K,)):
            fail(f"rank {rank}: 2-D band monitor shapes {a.shape}, "
                 f"{pw.shape}")
        same_shards(rank, a, a1, f"2-D band monitor audio, block {b}")
        same_shards(rank, pw, pw1, f"2-D band monitor power, block {b}")
    if not all(torch.equal(x, y) for x, y in zip(st, st1)):
        fail(f"rank {rank}: 2-D band monitor state differs from the mesh "
             f"in one process")
    if not all(torch.isfinite(s.data).all() for o in outs for v in o
               for s in v.addressable_shards):
        fail(f"rank {rank}: 2-D band monitor output not finite")
    crossings = band2d_crossings(m2)
    n_local = len(m2.local)
    expect = {"channelizer": POD_BM_BLOCKS * n_local,
              "decim_fir": POD_BM_BLOCKS * n_local}
    if ({k: counts.get(k) for k in expect} != expect
            or set(counts) - {"channelizer", "decim_fir", "halo_ring"}
            or not counts.get("halo_ring")
            or cross != POD_BM_BLOCKS * sum(crossings.values())
            or a2a.cross != POD_BM_BLOCKS * crossings["corner_turn"]
            or not cross):
        fail(f"rank {rank}: 2-D band monitor launches {counts}, "
             f"cross-process K12 {cross} (all-to-all {a2a.cross}); "
             f"expected {expect}, crossings a block {crossings}")
    if procs == POD4_PROCS and not a2a.cross:
        fail(f"rank {rank}: the corner turn did not cross processes")
    rep["band2d"] = {"launches": counts, "cross_launches": cross,
                     "corner_turn_cross": a2a.cross,
                     "ms_a_block": statistics.median(walls)}


def pod_corner_turn(rank: int, dev, rep: dict) -> None:
    """One corner turn at the 2-D step's shapes (both planes of [BM_BLOCK /
    (8 BM_K), BM_K] float32 a shard, in one call) on the 2 x 4 mesh_2d
    across the processes: against the mesh in this process bit for bit,
    one cross-process K12 launch a call; its host us a call and its device
    span (events on this rank's stream) beside the gloo route, the same
    call on host copies of the shards (``halo_ring.transfer_plain``)."""
    import torch

    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband2d as w2

    m2 = w2.mesh_2d(2, 4, device=POD_DEVICE)
    one = sh.Mesh([dev] * m2.size, (2, 4), ("time", "chan"))
    fl = BM_BLOCK // (m2.size * BM_K)
    g = torch.Generator(device=dev)
    g.manual_seed(POD_SEED + 2)
    planes = torch.randn(2, m2.size, fl, BM_K, generator=g, device=dev)
    same_everywhere(rank, (planes,), "the corner turn's planes")
    mine = tuple([p[s] for s in m2.local] for p in planes)
    want = sh.corner_turn(tuple(list(p.unbind(0)) for p in planes), one,
                          "chan")
    HR.cross_launches = 0
    got = sh.corner_turn(mine, m2, "chan")
    torch.cuda.synchronize()
    if HR.cross_launches != 1:
        fail(f"rank {rank}: a corner turn made {HR.cross_launches} "
             f"cross-process K12 launches, expected 1")
    host = tuple([x.cpu() for x in p] for p in mine)
    got_host = sh.corner_turn(host, m2, "chan")
    for p in range(2):
        for k, s in enumerate(m2.local):
            if not (torch.equal(got[p][k], want[p][s])
                    and torch.equal(got_host[p][k], want[p][s].cpu())):
                fail(f"rank {rank}: the corner turn across processes "
                     f"differs at plane {p}, shard {s}")
    spans = []
    for _ in range(POD_K12_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        sh.corner_turn(mine, m2, "chan")
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(POD_CT_HOST_CALLS):
        sh.corner_turn(mine, m2, "chan")
    host_us = (time.perf_counter() - t0) / POD_CT_HOST_CALLS * 1e6
    torch.cuda.synchronize()
    gloo = []
    for _ in range(POD_K12_REPS):
        t0 = time.perf_counter()
        sh.corner_turn(host, m2, "chan")
        gloo.append((time.perf_counter() - t0) * 1e3)
    nc = m2.shape["chan"]
    crossing = sum(1 for s in m2.local for c in range(nc)
                   if m2.owners[s // nc * nc + c] != rank)
    rep["corner_turn"] = {
        "device_ms": statistics.median(spans), "host_us": host_us,
        "gloo_ms": statistics.median(gloo), "pairs_sent": 2 * crossing,
        "block_bytes": fl * BM_K // nc * 4,
        "bytes_in_out": 2 * planes.numel() * planes.element_size()}


def spawn_pod(procs: int, local: int, tmp: str) -> list:
    """Start ``procs`` workers of ``local`` shards each, wait for them
    (each with POD_TIMEOUT_S), fail the run on any that exits non-zero,
    times out or prints no OK line; returns their JSON reports."""
    port = free_port()
    workers = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--pod-worker",
         str(r), str(procs), str(local), str(port), tmp], cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(procs)]
    outs = []
    try:
        for w in workers:
            outs.append((w.communicate(timeout=POD_TIMEOUT_S)[0],
                         w.returncode))
    except subprocess.TimeoutExpired:
        for w in workers:
            w.kill()
        for w in workers:
            w.communicate()
        fail(f"phase 22: a worker of {procs} x {local} ran past "
             f"{POD_TIMEOUT_S} s")
    reps = []
    for r, (o, rc) in enumerate(outs):
        if rc != 0 or f"POD_WORKER_OK {r}" not in o:
            fail(f"phase 22: worker {r} of {procs} x {local} exited {rc}:"
                 f"\n{o[-4000:]}")
        line = [x for x in o.splitlines() if x.startswith("POD_WORKER {")]
        reps.append(json.loads(line[-1][len("POD_WORKER "):]))
        print(f"[worker {r} of {procs} x {local}] "
              f"{line[-1][len('POD_WORKER '):]}")
    return reps


def multiprocess_phase(dev, card: str) -> list:
    """Phase 22: the two spawns of worker processes on the card
    (``spawn_pod``).  The first spawn's fused FM audio and states against
    the 8-shard mesh in this process, bit for bit; the times beside the
    card; K12's cross-process rows of the kernel table (the halo and the
    all-to-all)."""
    import gc

    import torch

    from comms_tpu_torch.models import fm_band_monitor as bm
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.parallel import fused_wideband as fw
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband2d as w2

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        re, im = fm_u8_planes(POD_BLOCKS * BLOCK, POD_SEED, dev)
        np.save(Path(tmp) / "fm_u8.npy", torch.stack([re, im]).cpu().numpy())
        bre, bim, _ = station_capture(POD_BM_BLOCKS * BM_BLOCK, BM_K, 44, dev)
        bpairs = torch.stack([bre, bim], -1)
        np.save(Path(tmp) / "bm_pairs.npy", bpairs.cpu().numpy())
        del bre, bim
        reps = spawn_pod(POD_PROCS, POD_LOCAL, tmp)
        wall_s = time.perf_counter() - t0
        t4 = time.perf_counter()
        reps4 = spawn_pod(POD4_PROCS, POD4_LOCAL, tmp)
        wall4_s = time.perf_counter() - t4

        # the one-process 8-shard mesh on the same blocks
        blocks = [(re[b * BLOCK:(b + 1) * BLOCK],
                   im[b * BLOCK:(b + 1) * BLOCK]) for b in range(POD_BLOCKS)]
        step = fw.make_sharded_fused_step(
            sh.time_mesh(POD_PROCS * POD_LOCAL, device=dev), block=BLOCK)

        def run_fused():
            st, audio = fm.fused_init_state(dev), []
            for r_, i_ in blocks:
                a, st = step(st, r_, i_)
                audio.append(a)
            return audio, st

        ref, ref_st = run_fused()
        torch.cuda.synchronize()
        for r in range(POD_PROCS):
            got = torch.load(Path(tmp) / f"fused_{r}.pt")
            lo = got["lo"]
            for b, a in enumerate(got["audio"]):
                if not torch.equal(a, ref[b][lo:lo + a.shape[0]].cpu()):
                    fail(f"phase 22: worker {r}'s fused FM audio of block "
                         f"{b} differs from the mesh in one process")
            if not all(torch.equal(got["state"][k], ref_st[k].cpu())
                       for k in ref_st):
                fail(f"phase 22: worker {r}'s fused FM state differs")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_fused()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3 / POD_BLOCKS)
    one_ms = statistics.median(walls)
    del ref, blocks
    # the 2-D step on the 2 x 4 mesh in this process, the same blocks
    bcfg = bm.BandMonitorConfig(num_channels=BM_K, block=BM_BLOCK)
    step2d = w2.make_sharded_band_monitor_2d(bcfg, w2.mesh_2d(2, 4,
                                                              device=dev))

    def run_2d():
        st = bm.init_state(bcfg, dev)
        for b in range(POD_BM_BLOCKS):
            _, st = step2d(st, bpairs[b * BM_BLOCK:(b + 1) * BM_BLOCK])

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_2d()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3 / POD_BM_BLOCKS)
    one_2d_ms = statistics.median(walls)
    del bpairs
    k12 = [x["k12"] for x in reps]
    print(f"K12 across 2 processes on {card}, a call at the fused raw tails "
          f"({k12[0]['pairs']} pairs of {k12[0]['bytes_each']} B, barrier "
          f"and events included): device ms (events on each rank's stream) "
          f"{[x['device_ms'] for x in k12]}, host us "
          f"{[x['host_us'] for x in k12]} (the gloo barrier alone "
          f"{[x['barrier_us'] for x in k12]}); plain version (gloo, host "
          f"tensors) ms {[x['plain_ms'] for x in k12]}")
    print(f"fused FM step on {card}, wall ms a block of {BLOCK} (3 blocks "
          f"chained, median of 3 runs): 2 processes x {POD_LOCAL} shards "
          f"{[x['fused_ms_a_block'] for x in reps]}, one process x "
          f"{POD_PROCS * POD_LOCAL} shards {one_ms}")
    launches = [(x["fused_launches"], x["wideband_launches"],
                 x["qpsk_launches"]) for x in reps]
    psd = [x["psd"] for x in reps]
    print(f"frequency-sharded PSD at {BIG[0][0]} x {BIG[0][1]} across "
          f"{POD_PROCS} processes on {card}: bit-equal to one process x "
          f"{POD_PROCS * POD_LOCAL} shards; cross-process K12 launches a "
          f"rank {[x['cross_launches'] for x in psd]} (the dfft's "
          f"all-to-alls {[x['all_to_all_cross'] for x in psd]}), launches "
          f"{[x['launches'] for x in psd]}, wall ms {[x['ms'] for x in psd]}")
    for rs, (procs, local) in ((reps, (POD_PROCS, POD_LOCAL)),
                               (reps4, (POD4_PROCS, POD4_LOCAL))):
        b2 = [x["band2d"] for x in rs]
        print(f"2-D band monitor K={BM_K}, {POD_BM_BLOCKS} chained blocks of "
              f"{BM_BLOCK} on a 2 x 4 mesh_2d, {procs} processes x {local} "
              f"shards on {card}: every rank bit-equal to the 2 x 4 mesh in "
              f"one process; wall ms a block {[x['ms_a_block'] for x in b2]} "
              f"(one process x 8 shards {one_2d_ms}); launches a rank "
              f"{[x['launches'] for x in b2]}, cross-process K12 "
              f"{[x['cross_launches'] for x in b2]} (the corner turn's "
              f"{[x['corner_turn_cross'] for x in b2]})")
    ct = [x["corner_turn"] for x in reps4]
    print(f"corner turn across {POD4_PROCS} processes on {card}, one call "
          f"(2 planes of [{BM_BLOCK // (8 * BM_K)}, {BM_K}] float32 a shard; "
          f"{ct[0]['pairs_sent']} blocks of {ct[0]['block_bytes']} B sent a "
          f"rank): device route (K12 into the windows, barrier, copy-out) "
          f"host us {[x['host_us'] for x in ct]}, device span ms (events on "
          f"each rank's stream) {[x['device_ms'] for x in ct]}; gloo route "
          f"(host copies, transfer_plain) ms {[x['gloo_ms'] for x in ct]}")
    print(f"phase 22 on {card}: workers' seconds "
          f"{[x['seconds'] for x in reps]} ({POD_PROCS} x {POD_LOCAL}), "
          f"{[x['seconds'] for x in reps4]} ({POD4_PROCS} x {POD4_LOCAL}); "
          f"launches a rank (fused, wideband, QPSK): {launches}; "
          f"{wall_s:.1f} s and {wall4_s:.1f} s with the workers; fused, "
          f"wideband, QPSK, PSD and 2-D band monitor bit-equal to one "
          f"process; config 8 OK")
    pairs, nbytes = k12[0]["pairs"], k12[0]["bytes_each"]
    return [kernel_row(
        "ring_halo_exchange_across_processes", "halo_ring.cu",
        "comms_tpu/kernels/halo_rdma.py:84",
        sum(x["fused_launches"]["halo_ring"] for x in reps), 0.0,
        statistics.median(x["device_ms"] for x in k12),
        statistics.median(x["plain_ms"] for x in k12),
        2 * pairs * nbytes, 0), kernel_row(
        "all_to_all_across_processes", "halo_ring.cu",
        "comms_tpu/kernels/halo_rdma.py:84",
        sum(x["band2d"]["corner_turn_cross"] for x in reps + reps4), 0.0,
        statistics.median(x["device_ms"] for x in ct),
        statistics.median(x["gloo_ms"] for x in ct),
        ct[0]["bytes_in_out"], 0)]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that the OS has just handed out."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    import comms_tpu_torch
    if Path(comms_tpu_torch.__file__).resolve().parents[1] != REPO:
        fail(f"comms_tpu_torch imported from {comms_tpu_torch.__file__}, "
             f"not from this checkout")
    from comms_tpu_torch.kernels import _build

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on; the plain version must run in float32")
    # The library yardsticks (F.conv1d) run on cuDNN, whose float32
    # convolutions default to TF32: hold them to float32 as well.
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # ---- 2. build (the recurrence probe's nvcc runs beside the
    # package's)
    t0 = time.perf_counter()
    RECURRENCE_PROBE.append(recurrence_tools().start_probe(
        REPO / "build" / "recurrence_probe"))
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({_build.BUILD_DIR})")
    print_ptxas_report(_build)
    print_ptxas_kernels(_build, ("fm_chain_kernel", "band_monitor_kernel",
                                 "channelize_kernel", "fir_kernel",
                                 "decim_fir_kernel",
                                 "qpsk_sym_kernel",
                                 "qpsk_panel_tf32x3_kernel",
                                 "qpsk_panel_chunk_sum_kernel",
                                 "panel_reduce_kernel", "fft_rows_kernel",
                                 "psd_partial_kernel", "psd_reduce_kernel",
                                 "stage_a_kernel", "stage_b_psd_kernel",
                                 "stage_b_reduce_kernel",
                                 "stage_b_fft_kernel", "halo_ring_kernel",
                                 "costas_loop_kernel", "agc_scan_kernel"))
    build_native()

    fm_row, fm_iq, fm_w = fm_receiver_phases(dev, card)
    rows = [fm_row]
    rows += band_monitor_phases(dev, card)
    rows += qpsk_phases(dev, card)
    rows += spectrum_phases(dev, card)
    rows += sharded_phases(dev, card)
    transmit_phases(dev, card)
    rows += runtime_phases(dev, card)
    rows += qpsk_link_phases(dev, card)
    t0 = time.perf_counter()
    edges_phases(dev, card, fm_iq, fm_w)
    print(f"phase 21 (the file edges): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += multiprocess_phase(dev, card)
    print(f"phase 22 (2 and 4 processes): {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-worker"]:
        pod_worker(*map(int, sys.argv[2:6]), Path(sys.argv[6]))
    else:
        main()
