"""``BENCHMARK.json`` against the benchmark contract's rules of form,
and every file it names present."""

import json
import re

import pytest

from benchlib import serve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = json.loads((serve.ROOT / "BENCHMARK.json").read_text())
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert len((serve.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32 and all(map(_line, B["command"]))
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries(key):
    entries = B[key]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if key == "per_layer" else set()
        assert KEYS[key] <= set(e) <= KEYS[key] | extra, e
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_configs_cells_and_metrics_fit_together():
    configs = {c["name"]: c for c in B["configs"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for c in B["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        f = serve.ROOT / c["file"]
        assert f.is_file() and f.with_suffix(".py").is_file()
        assert c["file"].startswith(B["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        assert json.loads(f.read_text())["reduced"] == c["reduced"]
    assert {w["config"] for w in B["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(cells) // 4)
    for w in B["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (serve.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(e2e) >= 2
    man = serve.Manifest()
    for w in cells:
        assert man.per_layer(w)
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in B["end_to_end"] + B["per_layer"]:
        assert (serve.BENCH / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
