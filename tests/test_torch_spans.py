"""The port's span recorder (mmgl_tpu_torch/utils/spans.py) on the CPU.

opt-tiny + tiny CLIP (frozen), context all, raw neighbours, bf16 compute
with fp32 parameters, 2 micro-batches of 2 an update. One module fixture
runs the updates once: one with no profiler on, then, under
``torch.profiler`` with CPU activity, one in the steady state (every
frozen cast kept) and one after ``invalidate_kept_casts()``.
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import layers
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import make_train_step
from mmgl_tpu_torch.utils import spans
# autouse: one intra-op thread for the module's tiny shapes
from test_torch_regularization import _one_thread  # noqa: F401

FLAGS = ["--model_name_or_path", "opt-tiny", "--task", "section",
         "--context", "all", "--neighbor_mode", "raw",
         "--max_input_length", "96", "--max_output_length", "32",
         "--per_device_train_batch_size", "2", "--grad_accumulation_steps",
         "2", "--steps_per_epoch", "4", "--dataloader_num_workers", "1",
         "--seed", "0", "--device", "cpu", "--bf16", "true",
         "--compute_dtype", "bfloat16", "--param_dtype", "float32"]
MICRO_BATCHES = 2


def _cast_at_use_numel(model, trainable: bool) -> int:
    """Elements of the leaves that ``cast_at_use`` casts: every parameter
    but the norms' (already fp32) and the LM's position table (looked up,
    then cast). The tied token table is looked up the same way, and cast
    whole for the head."""
    skip = {id(p) for m in model.modules()
            if isinstance(m, (layers.LayerNorm, layers.RMSNorm))
            for p in m.parameters(recurse=False)}
    skip.add(id(model.lm.decoder.embed_positions.weight))
    return sum(p.numel() for p in model.parameters()
               if p.requires_grad == trainable and id(p) not in skip)


@pytest.fixture(scope="module")
def recorded():
    args, _ = cli.parse_cli(FLAGS)
    device = torch.device("cpu")
    tok, model, _, (train_ds, _, _) = cli._build(args, device)
    optimizer, scheduler = build_optimizer(args, model)
    step = make_train_step(model, optimizer, scheduler, True,
                           args.max_input_length, tok.pad_token_id,
                           MICRO_BATCHES, args.grad_clip)
    loader = cli.PrefetchLoader(train_ds, num_workers=1,
                                batch_size=2 * MICRO_BATCHES)
    batches = list(loader)[:3]
    gen = cli.dropout_generator(0, 0, device)
    spans.drain()
    step(batches[0], gen)
    out = {"unprofiled": spans.drain(), "model": model, "windows": []}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, batch in enumerate(batches[1:]):
            if i == 1:
                layers.invalidate_kept_casts()
            start = time.time_ns()
            step(batch, gen)
            out["windows"].append((start, time.time_ns()))
    out["records"] = spans.drain()
    base = prof.profiler.kineto_results.trace_start_ns()
    out["layer_norms"] = [(base + 1000 * e.time_range.start,
                           base + 1000 * e.time_range.end)
                          for e in prof.events()
                          if e.name == "aten::layer_norm"]
    return out


def _updates(records):
    return [s for s in records["spans"] if s.name == "update"]


def test_no_profiler_records_nothing(recorded):
    """With no profiler on, an update records no span and no count, and
    ``span`` hands out one shared no-op context."""
    assert recorded["unprofiled"] == {"spans": [], "counts": {}}
    assert spans.span("update", root=True) is spans.span("forward")


def test_update_records_its_span_tree(recorded):
    """Each profiled update: one root ``update``; two ``micro_batch``, each
    holding ``forward`` (holding ``batch_to_device``) then ``backward``;
    then one ``optimizer``. Every span carries its update's id, its
    parent's, and a host interval inside its parent's; off the card no
    span has device time."""
    records = recorded["records"]
    ups = _updates(records)
    assert len(ups) == 2
    by_id = {s.id: s for s in records["spans"]}
    for up in ups:
        assert up.parent is None and up.update == up.id
        mine = [s for s in records["spans"] if s.update == up.id]
        children = sorted((s for s in mine if s.parent == up.id),
                          key=lambda s: s.start_ns)
        assert [s.name for s in children] == ["micro_batch"] * 2 + [
            "optimizer"]
        for mb in children[:2]:
            inner = sorted((s for s in mine if s.parent == mb.id),
                           key=lambda s: s.start_ns)
            assert [s.name for s in inner] == ["forward", "backward"]
            copies = [s for s in mine if s.parent == inner[0].id]
            assert [s.name for s in copies] == ["batch_to_device"]
        assert children[1].start_ns >= children[0].end_ns
        assert children[2].start_ns >= children[1].end_ns
        assert len(mine) == 1 + 2 * 4 + 1
        for s in mine:
            assert s.device_ms is None and s.thread == up.thread
            if s.parent is not None:
                parent = by_id[s.parent]
                assert parent.start_ns <= s.start_ns <= s.end_ns \
                    <= parent.end_ns


def test_spans_lie_on_the_profilers_clock(recorded):
    """Every span lies inside the epoch window taken around its update;
    each LayerNorm op the profiler recorded, placed on the epoch clock
    through ``trace_start_ns``, lies inside one of the ``forward`` spans."""
    records = recorded["records"]
    for up, (start, end) in zip(_updates(records), recorded["windows"]):
        for s in records["spans"]:
            if s.update == up.id:
                assert start <= s.start_ns <= s.end_ns <= end
    forwards = [s for s in records["spans"] if s.name == "forward"]
    assert recorded["layer_norms"]
    for op_start, op_end in recorded["layer_norms"]:
        assert any(f.start_ns <= op_start <= op_end <= f.end_ns
                   for f in forwards), (op_start, op_end)


@pytest.mark.parametrize("update", ["steady", "after_invalidate"])
def test_param_cast_counts_the_casts_made(recorded, update):
    """``param_cast`` of an update: 2 bytes for each element of the
    trainable leaves that ``cast_at_use`` casts, once a micro-batch; the
    frozen leaves' kept casts count 0 in the steady state and once in
    the update after ``invalidate_kept_casts()``."""
    records, model = recorded["records"], recorded["model"]
    up = _updates(records)[["steady", "after_invalidate"].index(update)]
    trainable = _cast_at_use_numel(model, True)
    frozen = _cast_at_use_numel(model, False)
    want = 2 * trainable * MICRO_BATCHES
    if update == "after_invalidate":
        want += 2 * frozen
    assert trainable > 0 and frozen > 0
    assert records["counts"][(up.id, "param_cast")] == want


@pytest.mark.parametrize("norm, dtype, per_element", [
    (layers.LayerNorm, torch.bfloat16, 4 + 2),
    (layers.LayerNorm, torch.float32, 2),
    (layers.RMSNorm, torch.bfloat16, 4 + 2)])
def test_norm_cast_counts_one_call(norm, dtype, per_element):
    """One call of a bf16-compute norm layer counts the bytes its casts
    write: 4 an element for the fp32 input (none where the input is fp32
    already), 2 for the bf16 output; outside an update, under id None."""
    layer = norm(8, compute_dtype=torch.bfloat16)
    x = torch.randn(3, 5, 8).to(dtype)
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        layer(x)
    assert spans.drain()["counts"] == {(None, "norm_cast"):
                                       per_element * x.numel()}


def test_stop_profile_drains_the_recorder(tmp_path):
    """``cli.stop_profile`` leaves no record behind: a run with
    --profile_dir keeps none after its profiled updates."""
    device = torch.device("cpu")
    prof = cli.start_profile(device)
    with spans.span("update", root=True):
        spans.count("param_cast", torch.zeros(4))
    cli.stop_profile(prof, device, str(tmp_path), 0)
    assert spans.drain() == {"spans": [], "counts": {}}
