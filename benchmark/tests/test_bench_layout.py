"""A new cell, configuration and per-layer metric are files of their
own, found by name: added beside the benchmark's files in a copy, with
no existing file edited, they run."""

import hashlib
import json
import shutil
import time

from benchlib import serve


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_per_layer_metric_are_found_by_name(tmp_path):
    src = serve.BENCH
    shutil.copytree(src, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    manifest = json.loads((serve.ROOT / "BENCHMARK.json").read_text())

    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "band_monitor_k64.json").read_text())
    cfg.update(name="band_monitor_k32", num_channels=32)
    cfg["input"]["channels"] = 32
    (b / "configs" / "band_monitor_k32.json").write_text(json.dumps(cfg))
    shutil.copy(b / "configs" / "band_monitor_k64.py",
                b / "configs" / "band_monitor_k32.py")
    traffic = json.loads((b / "traffic" / "staged_device_ring.json")
                         .read_text())
    traffic.update(ring_blocks=3, depth=2)
    (b / "traffic" / "staged_short_ring.json").write_text(
        json.dumps(traffic))
    (b / "metrics" / "blocks_delivered.py").write_text(
        "def read(run):\n    return run.delivered\n")

    manifest["configs"].append(dict(
        manifest["configs"][0], name="band_monitor_k32",
        file="benchmark/configs/band_monitor_k32.json"))
    manifest["workloads"].append(dict(
        manifest["workloads"][0], name="bm32_staged",
        config="band_monitor_k32", traffic="staged_short_ring"))
    manifest["per_layer"].append(dict(
        name="blocks_delivered", unit="blocks", better="higher",
        source="host_clock", layer="serving loop: runtime/stream.StreamRunner",
        moves="rx_msps", workloads=["bm32_staged"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    for p, digest in before.items():
        assert _digest(tmp_path / "benchmark")[p] == digest
    m = serve.Manifest(tmp_path)
    kw = dict(t0=time.perf_counter(), manifest=m, device="cpu",
              sizes={"block_samples": 10240})
    result, compared = serve.run_cell("bm32_staged", 11, 0.3, False, **kw)
    assert result["correct"], compared
    assert set(result["metrics"]) == {"rx_msps", "block_p95_ms", "setup_s"}
    result, compared = serve.run_cell("bm32_staged", 12, 0.3, True, **kw)
    assert result["correct"], compared
    assert result["metrics"]["blocks_delivered"]["value"] \
        == result["attempted"]
    assert "dispatch_ms" in result["metrics"]
    # the cells already there are untouched by the new entries
    assert "blocks_delivered" not in {
        e["name"] for e in m.per_layer("fm_pipeline")}
