"""The program's spans and cast counters as the harness reads them, on the
CPU: a traced run of each tiny cell, its compute in bf16 so that the
casts write bytes, reports ``batch_copy_ms``, ``param_cast_mb`` and
``norm_cast_mb`` as finite numbers, and off the card the device spans'
metrics read nothing. Where the program has no recorder (an older tree),
``adapters/spans.py``'s ``drain`` is None and every new reader returns
None."""

import math
import sys

import pytest
import torch

from benchmark import run, work
from benchmark.adapters import spans as program_spans
from benchmark.tests.tiny import make_root, one_thread, shrink_350m  # noqa

CELLS = ["tiny-post.raw", "tiny-lora.emb"]
SEED = 2**31 + 29
READERS = ["batch_copy_ms", "idle_in_batch_copy_ms", "forward_device_ms",
           "backward_device_ms", "optimizer_device_ms", "param_cast_mb",
           "norm_cast_mb"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_programs_spans(root, name, shrink_350m,
                                             one_thread):
    cell = run.load_cell(name, root)
    cell["settings"].update(bf16=True, compute_dtype="bfloat16")
    got = run.run_cell(cell, SEED, 0.3, True, torch.device("cpu"))
    metrics = got["output"]["metrics"]
    for metric in ("batch_copy_ms", "param_cast_mb", "norm_cast_mb"):
        value = metrics[metric]["value"]
        assert math.isfinite(value) and value > 0, (metric, value)
    assert math.isfinite(metrics["idle_in_batch_copy_ms"]["value"])
    for metric in ("forward_device_ms", "backward_device_ms",
                   "optimizer_device_ms"):
        assert metric not in metrics
    records = got["ctx"]["spans"]
    assert sum(s.name == "update" for s in records["spans"]) == \
        cell["check"]["trace_updates"]


def test_readers_read_nothing_without_the_recorder(monkeypatch):
    import mmgl_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "mmgl_tpu_torch.utils.spans", None)
    monkeypatch.delattr(mmgl_tpu_torch.utils, "spans")
    assert program_spans.drain() is None
    for name in READERS:
        assert work.load("metrics", name).read({"spans": None}) is None
