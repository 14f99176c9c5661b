"""``sink_lent_pct`` on events made by hand: the share of ``stream.copy``
spans holding a ``stream.lend`` span, 0 where every block was copied (a
program that lends nothing), and None where the trace holds no
``stream.copy`` span or no device operation (a CPU run)."""

import pytest

from benchlib import serve, trace
from benchlib.trace import Op, TraceView


def _view(lent, device=True):
    """Four blocks' ``stream.copy`` spans; those in ``lent`` hold a
    ``stream.lend``.  A stray ``stream.lend`` outside any copy counts
    for none."""
    dev = [Op("Memcpy DtoH (Device -> Pinned)", 5, 9)] if device else []
    host = [Op(trace.WINDOW, 0, 100)]
    for k in range(4):
        host.append(Op("stream.copy", 20 * k + 10, 20 * k + 20))
        if k in lent:
            host.append(Op("stream.lend", 20 * k + 11, 20 * k + 19))
    host.append(Op("stream.lend", 95, 97))
    return TraceView(4, host[0], dev, host, frozenset())


def _read(view):
    run = serve.RunView(samples_per_block=1000, setup_s=1.0, window_s=1.0,
                        delivered=4, latencies_s=[0.001],
                        dispatch_s=[0.001], launches=[], trace=view)
    return serve.Manifest().reader("sink_lent_pct").read(run)


@pytest.mark.parametrize("lent,pct", [((0, 1, 2, 3), 100.0),
                                      ((1, 3), 50.0), ((), 0.0)])
def test_share_of_copies_holding_a_lend(lent, pct):
    assert _read(_view(lent)) == pytest.approx(pct)


def test_copies_without_a_lend_read_zero():
    no_lend = _view(())
    no_lend.host_ops = [o for o in no_lend.host_ops
                        if o.name != "stream.lend"]
    assert _read(no_lend) == 0.0


def test_no_copy_no_reading():
    no_copy = _view((0, 1))
    no_copy.host_ops = [o for o in no_copy.host_ops
                        if o.name != "stream.copy"]
    assert _read(no_copy) is None
    assert _read(None) is None
    assert _read(_view((0, 1), device=False)) is None


def test_manifest_entry():
    m = serve.Manifest()
    spec, = [e for e in m.data["per_layer"] if e["name"] == "sink_lent_pct"]
    assert spec["source"] == "program_span" and spec["better"] == "higher"
    assert spec["moves"] == "rx_msps" and spec["unit"] == "%"
    assert "workloads" not in spec
    assert all(spec in m.per_layer(w["name"]) for w in m.data["workloads"])
