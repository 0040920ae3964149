"""A configuration, a model family, a cell and a per-layer metric are
added as files alone and found by name: in a temporary copy of the
benchmark, a throwaway configuration file whose text tower is a new
family (its counts, its program adapter and its reference forward, each a
file of its own, here copies of Roberta's), a traffic mix, a check file
and a metric reader, with their entries in BENCHMARK.json, run through the
harness without an edit to any file the benchmark has."""

import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark.tests.tiny import make_root

REPO = Path(__file__).resolve().parents[2]

READER = '''"""A throwaway reader: the windows' updates."""


def read(ctx):
    return float(ctx["updates"])
'''

SCRIPT = """
import json, torch
torch.set_num_threads(1)
from benchmark import run
assert run.ROOT.parent.resolve() == __import__("pathlib").Path.cwd().resolve()
out = run.run_cell(run.load_cell("throwaway.emb"), 3, 0.2, True,
                   torch.device("cpu"))["output"]
print(json.dumps(out))
"""


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/tiny-lora.json").read_text())
    cfg["settings"]["lora_r"] = 2
    cfg["parts"][1]["family"] = "throwaway_text"
    for folder in ("families", "adapters", "reference/families"):
        here = root / "benchmark" / folder
        (here / "throwaway_text.py").write_text(
            (here / "roberta.py").read_text())
    (root / "benchmark/configs/throwaway.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(name="throwaway", source="a test",
                                 file="benchmark/configs/throwaway.json",
                                 reduced=[], why="a test"))
    (root / "benchmark/workloads/throwaway.emb.json").write_text(
        (root / "benchmark/workloads/tiny-lora.emb.json").read_text())
    bench["workloads"].append(dict(name="throwaway.emb", config="throwaway",
                                   traffic="tiny.emb", chips=1,
                                   why="a test"))
    (root / "benchmark/metrics/throwaway_updates.py").write_text(READER)
    bench["per_layer"].append(dict(name="throwaway_updates", unit="updates",
                                   better="higher", source="host_clock",
                                   layer="loop and loader",
                                   moves="train_sections_per_s",
                                   workloads=["throwaway.emb"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    done = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["throwaway_updates"]["value"] >= 1
    assert out["checks"]["tower_gap"]["value"] < 1e-5
