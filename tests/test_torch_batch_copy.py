"""The batch's trip to the device (``models/fusion.py`` ``_as_tensor``),
CLIP's normalisation constants and the dropout-stream key: nothing the
update copies from the host waits for the card's stream.

On the CPU, with a stand-in CUDA target where one is needed
(``Tensor.pin_memory`` and ``Tensor.to`` patched): the CPU path is the
plain copy; bound for a card, each host field is staged in page-locked
memory once and copied with ``non_blocking=True``, counted by the
``batch_copy_pinned`` and ``batch_copy_pageable`` counters under a
profiler; CLIP's constants are made once a device with the same bits; the
key of a tensor-parallel rank's dropout stream is made on the device.

Marked ``gpu``: two updates of a tiny OPT + CLIP (raw images) and of a
tiny OPT + Roberta (embedding mode), attention in its plain version, under
``torch.cuda.set_sync_debug_mode("error")``, held bit for bit to the same
updates through blocking copies; and one update of each benchmark cell's
model (its settings and traffic, two layers a stack at the published
widths, so head dim 64 and the CUDA attention kernels) under "error". This
file imports no JAX, so on the GPU machine (the repository's conftest
imports JAX, which it lacks):

    python -m pytest tests/test_torch_batch_copy.py -m gpu --noconftest -q
"""

import functools
import json
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import clip, factory, fusion
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.ops import flash_attention as fa
from mmgl_tpu_torch.parallel.mesh import Mesh
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import make_train_step
from mmgl_tpu_torch.utils import spans

CARD = torch.device("cuda", 0)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny shapes: more only contend with
    the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields():
    """A micro-batch's kinds of field: token ids, uint8 pixels, a bool
    mask (numpy, as the loader gives them) and a CPU tensor."""
    rng = np.random.RandomState(0)
    return {"input_ids": rng.randint(0, 50, (2, 5)).astype(np.int64),
            "images": rng.randint(0, 256, (2, 1, 3, 4, 4)).astype(np.uint8),
            "images_valid": rng.rand(2, 1) > 0.5,
            "lpe": torch.randn(2, 3, 4)}


def _nbytes(fields) -> int:
    return sum(v.nbytes for v in fields.values())


class _StandIn:
    """``Tensor.pin_memory`` and ``Tensor.to`` patched so that a CPU build
    takes ``_as_tensor``'s card path: ``pinned`` records each tensor
    pinned and hands back a copy marked as staged, ``moved`` each move to
    the card as (tensor, keyword arguments), which returns the tensor."""

    def __init__(self, monkeypatch, pin_fails: bool = False):
        self.pinned, self.moved, self.staged = [], [], set()
        to = torch.Tensor.to

        def pin_memory(t):
            if pin_fails:
                raise RuntimeError("CUDA error: out of memory")
            self.pinned.append(t)
            staged = t.clone()
            self.staged.add(id(staged))
            return staged

        def moved_to(t, *args, **kw):
            if args and isinstance(args[0], torch.device) and \
                    args[0].type == "cuda":
                self.moved.append((t, kw))
                return t
            return to(t, *args, **kw)

        monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
        monkeypatch.setattr(torch.Tensor, "to", moved_to)


def _counted(fields, device):
    """(the fields through ``_as_tensor``, the counts recorded) under a
    profiler session."""
    spans.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        out = {k: fusion._as_tensor(v, device) for k, v in fields.items()}
    return out, spans.drain()["counts"]


def test_cpu_target_copies_as_before_and_pins_nothing(monkeypatch):
    """On a CPU device each field is ``torch.from_numpy``'s tensor (a CPU
    tensor itself), as before; nothing is pinned and nothing counted."""
    def refuse(t):
        raise AssertionError("pinned on the CPU path")

    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    fields = _fields()
    out, counts = _counted(fields, CPU)
    assert counts == {}
    assert out["lpe"] is fields["lpe"]
    for k, v in fields.items():
        want = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        assert out[k].device == CPU and out[k].dtype == want.dtype
        assert torch.equal(out[k], want), k


def test_card_target_pins_each_field_once_and_copies_without_a_wait(
        monkeypatch):
    """Bound for the card, each host field is pinned once and the staged
    copy moved with ``non_blocking=True``, its bits unchanged; the
    ``batch_copy_pinned`` counter counts each field's bytes once, and
    ``batch_copy_pageable`` nothing."""
    stand_in = _StandIn(monkeypatch)
    fields = _fields()
    out, counts = _counted(fields, CARD)
    assert len(stand_in.pinned) == len(stand_in.moved) == len(fields)
    for (k, v), pinned, (moved, kw) in zip(fields.items(), stand_in.pinned,
                                           stand_in.moved):
        want = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        assert torch.equal(pinned, want), k
        assert id(moved) in stand_in.staged and kw == {"non_blocking": True}
        assert out[k] is moved and torch.equal(out[k], want), k
    assert counts == {(None, "batch_copy_pinned"): _nbytes(fields)}


def test_card_target_without_page_locked_memory_copies_with_a_wait(
        monkeypatch):
    """Where pinning fails, each field goes by the blocking copy and the
    ``batch_copy_pageable`` counter counts its bytes once."""
    stand_in = _StandIn(monkeypatch, pin_fails=True)
    fields = _fields()
    out, counts = _counted(fields, CARD)
    assert [kw for _, kw in stand_in.moved] == [{}] * len(fields)
    assert counts == {(None, "batch_copy_pageable"): _nbytes(fields)}


def test_a_field_on_the_card_passes_through(monkeypatch):
    """A tensor already on the card is neither pinned nor counted: its own
    ``to`` hands it back."""
    class OnCard:
        device = CARD

        def to(self, device, **kw):
            assert device == CARD and kw == {}
            return self

        def pin_memory(self):
            raise AssertionError("pinned a tensor on the card")

    on_card = OnCard()
    out, counts = _counted({"input_ids": on_card}, CARD)
    assert out["input_ids"] is on_card and counts == {}


def _per_call_normalize(pixels, valid, dtype):
    """``normalize_pixels`` as it was, its constants made at every call."""
    x = pixels.to(torch.float32) / 255.0
    mean = torch.tensor(clip.CLIP_MEAN, dtype=torch.float32).reshape(3, 1, 1)
    std = torch.tensor(clip.CLIP_STD, dtype=torch.float32).reshape(3, 1, 1)
    x = (x - mean) / std
    shape = tuple(valid.shape) + (1,) * (x.dim() - valid.dim())
    return (x * valid.reshape(shape).to(x.dtype)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_pixels_makes_its_constants_once(dtype):
    """The same bits as the constants made at every call, and a second
    call makes none."""
    rng = np.random.RandomState(1)
    pixels = torch.from_numpy(
        rng.randint(0, 256, (2, 3, 3, 8, 8)).astype(np.uint8))
    valid = torch.from_numpy(rng.rand(2, 3) > 0.3)
    clip._pixel_stats.cache_clear()
    for _ in range(2):
        got = clip.normalize_pixels(pixels, valid, dtype=dtype)
        assert got.dtype == dtype
        assert torch.equal(got, _per_call_normalize(pixels, valid, dtype))
    info = clip._pixel_stats.cache_info()
    assert (info.misses, info.hits) == (1, 1)


@pytest.mark.parametrize("stream", [1, 2, 3, 2**31 - 1])
def test_dropout_stream_key_is_the_drawn_key_plus_the_stream(monkeypatch,
                                                             stream):
    """A rank's attention dropout key is the drawn key plus
    ``[0, dropout_stream]``, as ``seed + torch.tensor([0, s])`` gives it."""
    keys = []
    plain = att.attention_reference

    def reference(*args, dropout_seed=None, **kw):
        keys.append(dropout_seed)
        return plain(*args, dropout_seed=dropout_seed, **kw)

    monkeypatch.setattr(att, "attention_reference", reference)
    q = torch.randn(1, 4, 2, 8)
    gen = torch.Generator().manual_seed(stream)
    att.multi_head_attention(q, q, q, dropout_rate=0.1, generator=gen,
                             dropout_stream=stream, use_pallas=False)
    drawn = att.draw_dropout_seed(torch.Generator().manual_seed(stream))
    want = drawn + torch.tensor([0, stream])
    assert keys[0].dtype == want.dtype == torch.int64
    assert torch.equal(keys[0], want)


def test_batch_pinned_share_reads_the_counters():
    """The benchmark's ``batch_pinned_share``: pinned over pinned +
    pageable bytes, in %; None where neither was counted or nothing was
    recorded."""
    sys.path.insert(0, str(REPO))
    try:
        from benchmark import work
    finally:
        sys.path.pop(0)
    reader = work.load("metrics", "batch_pinned_share")
    update = spans.Span("update", 7, None, 7, 0, 0, 1)

    def share(counts):
        return reader.read({"spans": {"spans": [update], "counts": counts}})

    assert share({(7, "batch_copy_pinned"): 300}) == 100.0
    assert share({(7, "batch_copy_pinned"): 300,
                  (7, "batch_copy_pageable"): 100}) == 75.0
    assert share({(7, "param_cast"): 10}) is None
    assert reader.read({"spans": None}) is None


# ---- on the card ------------------------------------------------------

# --use_pallas false: no CUDA kernel takes a head dim this small, so the
# attention runs its plain version
TINY = ["--task", "section", "--max_output_length", "16",
        "--use_pallas", "false",
        "--per_device_train_batch_size", "2", "--grad_accumulation_steps",
        "2", "--steps_per_epoch", "4", "--dataloader_num_workers", "1",
        "--seed", "0", "--device", "cuda", "--bf16", "true",
        "--compute_dtype", "bfloat16", "--param_dtype", "float32"]
MODELS = {
    "clip_raw": ["--model_name_or_path", "opt-tiny", "--context", "all",
                 "--neighbor_mode", "raw", "--max_input_length", "96"],
    "roberta_embedding": ["--model_name_or_path", "opt-tiny", "--context",
                          "text_only", "--neighbor_mode", "embedding",
                          "--max_input_length", "32",
                          "--max_text_neighbors", "3", "--n_text_tokens",
                          "2", "--n_visual_tokens", "2"],
}


def _blocking(x, device):
    """The batch copy as it was: a blocking copy from pageable memory."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


@contextmanager
def _sync_debug(mode):
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _three_updates(flags, no_sync: bool):
    """Three updates from the seed: each one's metrics, the gradients the
    optimizer stepped on and the trainable parameters after it. With
    ``no_sync`` the second and third run under sync debug mode "error"
    (the first builds the kernels, CLIP's constants and the optimizer's
    state)."""
    args, _ = cli.parse_cli(flags)
    tok, model, _, (train_ds, _, _) = cli._build(args, CARD)
    optimizer, scheduler = build_optimizer(args, model)
    step = make_train_step(model, optimizer, scheduler, True,
                           args.max_input_length, tok.pad_token_id, 2,
                           args.grad_clip)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    grads = []
    optimizer.register_step_pre_hook(
        lambda *_: grads.append([p.grad.clone() for p in params]))
    loader = cli.PrefetchLoader(train_ds, num_workers=1, batch_size=4)
    batches = list(loader)[:3]
    gen = cli.dropout_generator(0, 0, CARD)
    out = []
    for i, batch in enumerate(batches):
        with _sync_debug("error" if no_sync and i else 0):
            metrics = step(batch, gen)
        out.append((metrics, [p.detach().clone() for p in params]))
    torch.cuda.synchronize()
    return [(m, g, p) for (m, p), g in zip(out, grads)]


@pytest.mark.gpu
@pytest.mark.parametrize("model", list(MODELS))
def test_updates_never_wait_and_match_blocking_copies(model, monkeypatch):
    """The second and third updates raise nothing under sync debug mode
    "error", and every update's losses, gradient norm, gradients and
    parameters equal those through blocking copies bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the update runs the "
                    "CUDA kernels")
    flags = MODELS[model] + TINY
    got = _three_updates(flags, no_sync=True)
    monkeypatch.setattr(fusion, "_as_tensor", _blocking)
    want = _three_updates(flags, no_sync=False)
    for i, ((m, g, p), (wm, wg, wp)) in enumerate(zip(got, want)):
        for key in ("loss", "summary_loss", "grad_norm"):
            assert torch.equal(m[key], wm[key]), (i, key)
        assert len(g) == len(wg) and len(p) == len(wp)
        for j, (a, b) in enumerate(zip(g + p, wg + wp)):
            assert torch.equal(a, b), (i, j)


# the benchmark's cells: (configuration, traffic) under benchmark/
CELLS = {"opt-350m.train.s2048": ("opt-350m", "train.s2048"),
         "opt-1.3b-lora.train.s684": ("opt-1.3b-lora", "train.s684")}
# the attention kernels' wrappers, forward and backward
KERNELS = (("flash_attention_allheads", "fused_heads_attention",
            "flash_attention"),
           ("flash_attention_allheads_bwd", "flash_attention_bwd",
            "flash_attention_blocked_bwd"))


def _cell_flags(config: str, traffic: str):
    """The CLI's flags for a cell: its configuration's settings and its
    traffic's, as the benchmark gives them to the port."""
    settings = json.loads((REPO / "benchmark" / "configs" /
                           f"{config}.json").read_text())["settings"]
    settings.update(json.loads((REPO / "benchmark" / "traffic" /
                                f"{traffic}.json").read_text())["settings"])
    flags = []
    for key, value in settings.items():
        flags += [f"--{key}", str(value).lower() if isinstance(value, bool)
                  else str(value)]
    return flags + ["--seed", "0", "--device", "cuda"]


@pytest.fixture
def two_layers(monkeypatch):
    """The factory's OPT rows, CLIP's vision tower and Roberta at two
    layers each, every width as published."""
    monkeypatch.setattr(factory, "_OPT_SIZES", {
        k: (h, min(n, 2), heads, ffn, proj)
        for k, (h, n, heads, ffn, proj) in factory._OPT_SIZES.items()})
    for tower in ("CLIPVisionConfig", "RobertaConfig"):
        monkeypatch.setattr(factory, tower, functools.partial(
            getattr(factory, tower), num_hidden_layers=2))


def _launches():
    return [sum(getattr(fa, n).launches for n in names) for names in KERNELS]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_update_never_waits(cell, two_layers):
    """A benchmark cell's update, built as the benchmark builds it (fused
    CE, the cell's batch, micro-batches and sequence lengths, the towers
    at full width), raises nothing under sync debug mode "error" after two
    set-up updates, and runs the CUDA attention kernels forward and
    backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the update runs the "
                    "CUDA kernels")
    args, _ = cli.parse_cli(_cell_flags(*CELLS[cell]))
    tok, model, _, (train_ds, _, _) = cli._build(args, CARD)
    mesh = Mesh()
    optimizer, scheduler = build_optimizer(args, model, mesh)
    accum = max(1, args.grad_accumulation_steps)
    step = make_train_step(
        model, optimizer, scheduler, args.decoder_only,
        args.max_input_length, tok.pad_token_id,
        grad_accumulation_steps=accum, grad_clip=args.grad_clip,
        fused_ce=args.fused_ce,
        chunked_ce=args.chunked_ce if args.decoder_only else 0, mesh=mesh)
    loader = cli._loader(args, train_ds,
                         args.per_device_train_batch_size * accum, mesh,
                         shuffle=True, seed=0)
    batches = iter(loader)
    gen = cli.dropout_generator(0, 0, CARD, mesh.data_index)
    try:
        for _ in range(2):
            step(next(batches), gen)
        batch = next(batches)
    finally:
        batches.close()
    torch.cuda.synchronize()
    before = _launches()
    with _sync_debug("error"):
        metrics = step(batch, gen)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert all(a > b for a, b in zip(_launches(), before)), (before,
                                                              _launches())
