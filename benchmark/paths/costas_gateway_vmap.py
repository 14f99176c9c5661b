"""Served path: the Costas-loop QPSK receiver, ``qpsk_rx_stream.
make_stream_fn``, lifted over B carriers by the runtime's own
``runtime.stream.lift(..., mode="vmap")`` (the step
``BatchedStreamRunner(mode="vmap")`` runs): one round is every
carrier's block, its Costas loop one launch of the recurrence kernel.
A round is the ring's float32 pairs [B, N, 2]; its output the symbols
[B, N / sps, 2], each carrier's block turned by the quarter-turn that
takes its first symbol into the first quadrant (:func:`first_quadrant`).

That turn (:mod:`benchlib.quadrant`, which the reference takes too) is
the check's canonical form of the Costas loop's 4-fold phase ambiguity,
one elementwise pass inside the timed step."""

from __future__ import annotations

from benchlib.quadrant import first_quadrant
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.models import qpsk_rx_stream as rx
from comms_tpu_torch.runtime.stream import lift


class Served:
    def __init__(self, cfg: dict, device):
        self.device = device
        self.streams = int(cfg["streams"])
        self.cfg = rx.QpskRxStreamConfig(
            block=cfg["block_samples"], sps=cfg["sps"],
            num_taps=cfg["num_taps"], beta=cfg["beta"],
            timing_d=cfg["timing_d"], costas_alpha=cfg["costas_alpha"],
            costas_beta=cfg["costas_beta"], g_freq=cfg["g_freq"],
            g_tau=cfg["g_tau"])
        if device.type == "cuda":
            _build.load()
        self.samples = self.streams * self.cfg.block
        states = [rx.init_state(self.cfg, device)
                  for _ in range(self.streams)]
        self.lifted, self.state0 = lift(rx.make_stream_fn(self.cfg), states,
                                        mode="vmap")

    def step(self, state, x):
        y, state = self.lifted(state, x)
        return first_quadrant(y), state

    def init_state(self):
        """Every carrier from the stream-start state, stacked by ``lift``
        (the step makes a new state; it writes into none)."""
        return self.state0

    @staticmethod
    def item(ring: dict, i: int):
        return ring["iq"][i]

    def launches(self) -> list:
        """One Costas launch a round, a lane a carrier."""
        return [("costas", dict(streams=self.streams,
                                steps=self.cfg.syms_per_block))]

