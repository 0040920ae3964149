"""The port's observability against the JAX CLI, on the CPU: wandb, the
profiler and the parameter table (mmgl_tpu/cli.py:194-207, 244-255,
384-385, 478-480, 546-547; mmgl_tpu/utils/meters.py:83-116).

Both CLIs train opt-tiny (section_only, raw, ``--use_pallas false``) for
one epoch of 5 updates under the same flags, with ``--log_to_wandb true``
and ``--profile_dir``, once each, in a module fixture: a fake ``wandb``
module injected into ``sys.modules`` records every call, the JAX
profiler's start and stop are recorded, not run, and each is placed by the
number of updates done when it is called.
"""

import contextlib
import copy
import io
import json
import sys
import types

import jax
import numpy as np
import pytest

from mmgl_tpu import cli as jcli
from mmgl_tpu.config import parse_args as jax_parse_args
from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.utils.meters import get_params_count as jax_params_count
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.utils.meters import get_params_count, get_params_count_str
from test_torch_peft import jax_pair, port_model
# autouse: one intra-op thread for the module's tiny shapes
from test_torch_regularization import _one_thread  # noqa: F401

FLAGS = ["--model_name_or_path", "opt-tiny", "--task", "section",
         "--context", "section_only", "--neighbor_mode", "raw",
         "--max_input_length", "32", "--max_output_length", "16",
         "--per_device_train_batch_size", "2", "--grad_accumulation_steps",
         "1", "--steps_per_epoch", "5", "--epochs", "1",
         "--per_device_val_batch_size", "2", "--val_steps_per_epoch", "1",
         "--print_freq", "1", "--use_pallas", "false", "--seed", "0",
         "--dataloader_num_workers", "1", "--log_to_wandb", "true",
         "--wandb_project", "mmgl-test", "--wandb_run", "tiny"]
UPDATES = 5


def fake_wandb(calls):
    """A ``wandb`` module whose init, config.update, log and finish append
    (what, arguments) to ``calls``; the config is copied at the call."""
    run = types.SimpleNamespace()
    run.config = types.SimpleNamespace(update=lambda d, **kw: calls.append(
        ("config.update", copy.deepcopy(dict(d)), kw)))
    run.log = lambda scalars, **kw: calls.append(
        ("log", sorted(scalars), kw))
    run.finish = lambda: calls.append(("finish",))
    module = types.ModuleType("wandb")

    def init(*a, **kw):
        calls.append(("init", a, kw))
        return run
    module.init = init
    return module


def _count_updates(make_step, seen):
    """make_step wrapped: its steps count ``seen["updates"]``."""
    def make(*a, **kw):
        step = make_step(*a, **kw)

        def counted(*sa, **skw):
            out = step(*sa, **skw)
            seen["updates"] += 1
            return out
        return counted
    return make


def _run_jax(tmp, monkeypatch):
    calls, seen = [], {"updates": 0, "profile": []}
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls))
    monkeypatch.setattr(jcli, "make_production_train_step", _count_updates(
        jcli.make_production_train_step, seen))
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: seen[
        "profile"].append(("start", seen["updates"])))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: seen[
        "profile"].append(("stop", seen["updates"])))
    args = jax_parse_args(FLAGS + ["--log_dir", str(tmp / "jax"),
                                   "--profile_dir", str(tmp / "jax_prof")])
    jcli.run_training(args)
    return calls, seen


def _run_port(tmp, monkeypatch):
    calls, seen = [], {"updates": 0, "profile": []}
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls))
    monkeypatch.setattr(cli, "make_train_step", _count_updates(
        cli.make_train_step, seen))
    start, stop = cli.start_profile, cli.stop_profile

    def started(*a, **kw):
        seen["profile"].append(("start", seen["updates"]))
        return start(*a, **kw)

    def stopped(*a, **kw):
        seen["profile"].append(("stop", seen["updates"]))
        seen["trace"] = stop(*a, **kw)
        return seen["trace"]

    monkeypatch.setattr(cli, "start_profile", started)
    monkeypatch.setattr(cli, "stop_profile", stopped)
    cli.main(FLAGS + ["--log_dir", str(tmp / "port"), "--profile_dir",
                      str(tmp / "port_prof"), "--device", "cpu"])
    return calls, seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (wandb calls, update marks, stdout), "port": the same}."""
    tmp = tmp_path_factory.mktemp("observability")
    out = {}
    for name, fn in (("jax", _run_jax), ("port", _run_port)):
        stdout = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(stdout):
            out[name] = (*fn(tmp, mp), stdout.getvalue())
    return out


def test_wandb_gets_the_calls_of_the_jax_cli(runs):
    """The fake wandb sees, from both CLIs, in the same order: init with
    the same project and name; the flags as its config (the same keys and
    values, the run directories apart); the parameter totals; log calls
    with the same keys at the same steps (the epoch-0 val pass, every
    update at --print_freq 1, the val pass, the test pass); finish."""
    jcalls, pcalls = runs["jax"][0], runs["port"][0]
    assert [c[0] for c in pcalls] == [c[0] for c in jcalls]
    assert pcalls[0] == jcalls[0] == ("init", (), {
        "project": "mmgl-test", "name": "tiny"})
    jflags, pflags = jcalls[1][1], pcalls[1][1]
    assert sorted(jflags) == sorted(pflags)
    for key in ("log_dir", "save_dir", "profile_dir"):
        # each run's own directories: .../jax and .../port
        assert jflags.pop(key).replace("/jax", "/port") == pflags.pop(key)
    assert jflags == pflags and jcalls[1][2] == pcalls[1][2]
    assert jcalls[2] == pcalls[2]
    assert set(jcalls[2][1]) == {"total_params", "trainable_params",
                                 "non_trainable_params"}
    jlogs = [c[1:] for c in jcalls if c[0] == "log"]
    assert [c[1:] for c in pcalls if c[0] == "log"] == jlogs
    assert sum("train/loss" in keys for keys, _ in jlogs) == UPDATES
    assert pcalls[-1] == jcalls[-1] == ("finish",)


def test_profile_dir_writes_a_trace_and_stops_where_the_jax_cli_stops(
        runs):
    """--profile_dir: the trace starts before the first update of the first
    epoch and stops after update min(3, updates - 1) + 1 = 4 of 5, in both
    CLIs; the port's Chrome trace is written under --profile_dir and holds
    the train step's host events and the update's spans."""
    want = [("start", 0), ("stop", 4)]
    assert runs["jax"][1]["profile"] == want
    seen = runs["port"][1]
    assert seen["profile"] == want and seen["updates"] == UPDATES
    assert "port_prof" in seen["trace"]
    with open(seen["trace"]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert {"update", "forward", "backward", "optimizer"} <= names
    assert "[profile]" in runs["port"][2]


def test_the_cli_prints_the_parameter_table_before_the_totals(runs):
    """Both CLIs print the parameter table, then the totals line; the
    port's totals are the JAX CLI's."""
    totals = []
    for name in ("jax", "port"):
        out = runs[name][2]
        table = out.index("| Total trainable params")
        line = out.index("Total params:")
        assert out.index("| Module") < table < line
        totals.append(out[line:].splitlines()[0])
    assert totals[0] == totals[1]


def test_unimportable_wandb_prints_the_jax_cli_line(monkeypatch, capsys):
    """ROADMAP C6: with wandb unimportable, --log_to_wandb true prints the
    JAX CLI's ``[wandb] disabled: <error>`` (its exception's text) and the
    test pass runs on."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError) as err:
        import wandb  # noqa: F401
    got = cli.main(FLAGS + ["--test", "true", "--device", "cpu"])
    assert f"[wandb] disabled: {err.value}\n" in capsys.readouterr().out
    assert np.isfinite(got["loss"])


def test_parameter_table_matches_jax():
    """The table of family 3's layout (opt-tiny + LoRA, text_only): the
    trainable and non-trainable totals, and the rows' (count, trainable)
    as a multiset, equal the JAX table's for the same weights and
    trainable set; the formatted table ends with the two totals."""
    args, _, _, params = jax_pair("opt-lora")
    model = port_model(args, params)
    jtable, jtrain, jfrozen = jax_params_count(
        params, jax_trainable_mask(params, args.peft_type, args.freeze_lm))
    table, train, frozen = get_params_count(model)
    assert (train, frozen) == (jtrain, jfrozen)
    assert sorted((n, t) for _, n, _, t in table) == sorted(
        (n, t) for _, n, _, t in jtable)
    assert sum(t for *_, t in table) > 0 and not all(t for *_, t in table)
    lines = get_params_count_str(model).splitlines()
    assert f"{train:>12,} |" in lines[-3] and f"{frozen:>12,} |" in lines[-2]
    assert len(lines) == len(table) + 7
