"""The harness end to end on the CPU at two tiny cells, with the kernels'
plain versions: a traced run gives a whole result whose check compares
the port with the plain reference; planted faults turn ``correct``
false."""

import math

import numpy as np
import pytest
import torch

from benchmark import program, run
from benchmark.tests.tiny import make_root, one_thread, shrink_350m  # noqa

CELLS = ["tiny-post.raw", "tiny-lora.emb"]
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_is_correct(root, name, shrink_350m, one_thread):
    got = run.run_cell(run.load_cell(name, root), SEED, 0.5, True,
                       torch.device("cpu"))
    out = got["output"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    checks = out["checks"]
    assert checks["batch_diff"]["value"] == 0
    # float32 on both sides: the port's plain kernels against the
    # reference, to rounding
    for name_ in ("tower_gap", "loss_gap", "grad_gap", "change_gap"):
        assert checks[name_]["value"] < 1e-5, (name_, checks[name_])
    # the host-clock readers read on the CPU too
    for metric in ("data_wait_ms", "update_host_cpu_ms", "copy_cast_ms",
                   "device_idle_share"):
        assert math.isfinite(out["metrics"][metric]["value"])
    assert list(out)[-1] == "checks"


def plant(prog, fault: str) -> None:
    """Break the port's timed path under the harness: ``frozen`` (the
    update leaves the parameters as they were), ``half`` (half of each
    micro-batch left out, the mean over the rest), ``token`` (one token of
    each batch altered where the loader makes it), ``no_decay`` (AdamW's
    weight decay dropped), ``beta2`` (0.999 for the configuration's)."""
    if fault == "frozen":
        prog.optimizer.step = lambda *a, **k: None
    elif fault in ("no_decay", "beta2"):
        for group in prog.optimizer.param_groups:
            if fault == "no_decay":
                group["weight_decay"] = 0.0
            else:
                group["betas"] = (group["betas"][0], 0.999)
    elif fault == "half":
        step = prog.train_step
        accum = prog.args.grad_accumulation_steps

        def half(batch, generator=None):
            rows = next(iter(batch.values())).shape[0] // accum
            keep = np.concatenate([np.arange(i * rows, i * rows + rows // 2)
                                   for i in range(accum)])
            return step({k: v[keep] for k, v in batch.items()}, generator)

        prog.train_step = half
    else:
        batches = prog.batches

        def altered():
            for batch in batches:
                ids = batch["input_ids"].copy()
                ids[0, 1] = (ids[0, 1] % 200) + 5
                yield dict(batch, input_ids=ids)

        prog.batches = altered()


@pytest.mark.parametrize("fault", ["frozen", "half", "token", "no_decay",
                                   "beta2"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(root, name, fault, shrink_350m, one_thread,
                              monkeypatch):
    class Broken(program.Program):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            plant(self, fault)

    monkeypatch.setattr(program, "Program", Broken)
    got = run.run_cell(run.load_cell(name, root), SEED, 0.2, False,
                       torch.device("cpu"))
    out = got["output"]
    assert out["correct"] is False, (fault, out["checks"])
    over = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    expected = {"frozen": "change_gap", "half": "loss_gap",
                "token": "batch_diff", "no_decay": "optim_diff",
                "beta2": "optim_diff"}[fault]
    assert expected in over, (fault, out["checks"])
