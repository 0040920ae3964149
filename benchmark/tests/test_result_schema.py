"""BENCHMARK.json keeps to the benchmark's contract, and a run's last
line has the keys, types and order the driver reads."""

import json
import re
from pathlib import Path

import torch

from benchmark import run
from benchmark.tests.tiny import make_root, one_thread, shrink_350m  # noqa

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).exists()
        assert c["file"].startswith("benchmark/")
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (REPO / "benchmark" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert (REPO / "benchmark" / "workloads"
                / f"{w['name']}.json").exists()
        used.add(w["config"])
    assert used == configs
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_last_line_schema(tmp_path, shrink_350m, one_thread):
    root = make_root(tmp_path)
    out = run.run_cell(run.load_cell("tiny-lora.emb", root), 5, 0.2, False,
                       torch.device("cpu"))["output"]
    line = json.loads(json.dumps(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert isinstance(line["correct"], bool)
    assert set(line["metrics"]) == {"train_sections_per_s", "peak_mem_gib",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["unit"] == "GiB"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
