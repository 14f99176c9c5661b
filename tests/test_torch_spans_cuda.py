"""The port's spans on a CUDA card: the composed FM receiver
(``fm_receiver.make_pipeline``) and the staged band monitor
(``fm_band_monitor.make_planar_block_fn``) served through
``StreamRunner`` under ``torch.profiler``:

* every launch of a port kernel (``comms_tpu_torch/csrc``) is recorded
  inside its wrapper's ``kernel.<module>`` span, and CUPTI's correlation
  links the device kernel to that launch (the library's statically
  linked CUDA runtime reports its calls to CUPTI as PyTorch's does);
* the D2H copy of each output is launched inside ``stream.d2h``, the
  H2D copies of host blocks inside ``stream.upload``;
* no device operation starts before the span that launched it: the spans
  and the device's events share the profiler's clock.  As in the
  benchmark's traced segment, a first profiler session is discarded;
  a session whose mapping of the card's timestamps puts one of
  PyTorch's own kernels before its launch is set aside too (at most
  three are tried).

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_spans_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.runtime.stream import StreamRunner

# the port's kernels these paths launch, and the module of each wrapper
KERNEL_MODULE = {"decim_fir_kernel": "decim_fir",
                 "channelize_kernel": "channelizer"}
FM_BLOCK = 64 * 25600           # both FirDecimate stages on K2's kernel
BM_BLOCK = 64 * 5 * 128 * 16    # K8, and K2 over the 64 channels' audio


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _short(name: str) -> str:
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    return s.split("(")[0].split("<")[0].strip().split("::")[-1]


class _Ev:
    def __init__(self, e):
        self.name = e.name()
        self.start = e.start_ns()
        self.end = e.start_ns() + e.duration_ns()
        self.device = e.device_type() == torch.autograd.DeviceType.CUDA
        self.annotation = e.is_user_annotation()
        self.corr = e.correlation_id()

    def __repr__(self):
        return f"{self.name[:60]!r} [{self.start}, {self.end}] {self.corr}"


def _is_api_call(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return re.match(r"cu(da)?[A-Z]", name) is not None


def _trace_of(prof):
    evs = [_Ev(e) for e in prof.profiler.kineto_results.events()]
    host = [e for e in evs if not e.device]
    dev = [e for e in evs if e.device and not e.annotation]
    return host, dev


def _mapping_sound(host, dev) -> bool:
    """No device operation of PyTorch's own starts before the runtime
    call that launched it: the session mapped the card's timestamps onto
    the host clock.  (Sessions on the H100 have mapped every device
    event 0.7 to 310 us early; the port's code plays no part in that.)"""
    calls = {h.corr: h for h in host if _is_api_call(h.name)}
    return all(d.start >= calls[d.corr].start for d in dev
               if d.corr in calls and _short(d.name) not in KERNEL_MODULE)


def _served_trace(step, state, blocks, device, sessions: int = 3):
    """The blocks served with a copying sink once to warm up, then under
    the profiler as the benchmark's traced segment is served: a first
    session discarded, then sessions until one maps the card's clock
    soundly (at most ``sessions``).  The host and device events of that
    session."""
    got = []
    r = StreamRunner(step, state, iter(blocks), sink=got.append, depth=2,
                     device=device)
    r.run()                                    # warm: build, first launches
    torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for i in range(sessions + 1):
        r = StreamRunner(step, r.state, iter(blocks), sink=got.append,
                         depth=2, device=device)
        with profile(activities=acts) as prof:
            r.run()
            torch.cuda.synchronize(device)
        if i == 0:
            continue
        host, dev = _trace_of(prof)
        if _mapping_sound(host, dev):
            break
    assert _mapping_sound(host, dev), f"{sessions} sessions mapped unsoundly"
    runs = i + 2                                  # the warm-up's included
    assert len(got) == runs * len(blocks)         # every block delivered
    return host, dev, runs


def _check_linkage(host, dev, kernels_expected, h2d: bool):
    """Each device operation shares CUPTI's correlation id with the
    runtime call that launched it; that call lies inside the span the
    operation belongs to: a port kernel's inside its wrapper's
    ``kernel.<module>``, a D2H copy's inside ``stream.d2h``."""
    spans = {}
    for h in host:
        if h.name.startswith(("kernel.", "stream.")):
            spans.setdefault(h.name, []).append(h)
    calls = {h.corr: h for h in host if _is_api_call(h.name)}

    def enclosing(names, call):
        for name in names:
            for s in spans.get(name, []):
                if s.start <= call.start and call.end <= s.end:
                    return name, s
        return None, None

    seen = set()
    checked = {"kernel": 0, "d2h": 0, "h2d": 0}   # device operations
    for d in dev:
        short = _short(d.name)
        if short in KERNEL_MODULE:
            want = ("kernel." + KERNEL_MODULE[short],)
            seen.add(short)
        elif "DtoH" in d.name:
            want = ("stream.d2h",)
        elif "HtoD" in d.name:
            # a host block's copy; a step's own constants inside the step
            want = ("stream.upload", "stream.step")
        else:
            continue
        call = calls.get(d.corr)
        assert call is not None, d
        name, span = enclosing(want, call)
        assert span is not None, (want, d, call)
        # the shared clock: nothing runs before the span, or the call,
        # that launched it
        assert span.start <= call.start <= d.start, (want, d, call, span)
        kind = {"stream.d2h": "d2h", "stream.upload": "h2d",
                "stream.step": None}.get(name, "kernel")
        if kind:
            checked[kind] += 1
    assert seen == set(kernels_expected)
    assert checked["kernel"] >= 1 and checked["d2h"] >= 1
    assert (checked["h2d"] >= 1) == h2d
    # every wrapper's span holds its recorded launch
    launches = [c for c in calls.values()
                if c.name.startswith(("cudaLaunch", "cuLaunch"))]
    for name, ss in spans.items():
        if name.startswith("kernel."):
            for s in ss:
                assert any(s.start <= c.start and c.end <= s.end
                           for c in launches), (name, s)


@pytest.mark.cuda
def test_fm_pipeline_launches_inside_their_spans(cuda):
    cfg = tfm.FmReceiverConfig(block=FM_BLOCK)
    pipe = tfm.make_pipeline(cfg)
    rng = np.random.default_rng(5)
    blocks = [rng.integers(0, 256, (FM_BLOCK, 2), dtype=np.uint8)
              for _ in range(3)]
    before = TDF.launches
    host, dev, runs = _served_trace(pipe.step, pipe.init_state(device=cuda),
                                    blocks, cuda)
    assert TDF.launches - before == runs * 2 * len(blocks)
    _check_linkage(host, dev, {"decim_fir_kernel"}, h2d=True)


@pytest.mark.cuda
def test_staged_band_monitor_launches_inside_their_spans(cuda):
    cfg = tbm.BandMonitorConfig(num_channels=64, taps_per_branch=13,
                                block=BM_BLOCK, audio_dec=5,
                                audio_taps=tfm.FM_LPF_TAPS)
    step = tbm.make_planar_block_fn(cfg)
    g = torch.Generator(device=cuda).manual_seed(9)
    blocks = [tuple(torch.randn(BM_BLOCK, device=cuda, generator=g)
                    for _ in range(2)) for _ in range(3)]
    before = TCK.launches, TDF.launches
    host, dev, runs = _served_trace(lambda s, x: step(s, *x),
                                    tbm.init_state(cfg, cuda), blocks, cuda)
    n = runs * len(blocks)
    assert (TCK.launches - before[0], TDF.launches - before[1]) == (n, n)
    _check_linkage(host, dev, {"decim_fir_kernel", "channelize_kernel"},
                   h2d=False)
