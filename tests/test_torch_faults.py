"""Faults of the port against the JAX package, each held by a CPU test.

C1: ``--use_pallas false`` sends every attention to the plain route, as the
JAX factory's ``use_pallas=False`` sends it to ``xla_attention``
(mmgl_tpu/models/factory.py:65-68, 81, 147).
C2: a local checkpoint directory raised, where the JAX package overlays
it; its import is now ported, held by tests/test_torch_hf_import.py.
C3: float16 compute on a CUDA device was refused before the model was
built, while the kernels took float32 and bfloat16 only; their tensor-core
bodies now have a float16 form, and float16 builds.
B4: OPT-2.7B's head dim 80 and 6.7B's 128 were refused on a CUDA device
before the model was built, while the kernels took 64 only; K1 and K3-K6
now take both, and the models build.
C4: ``--param_dtype bfloat16`` (the JAX bench's ``param_bf16``) failed in
every LayerNorm, whose fp32 statistics met bf16 scale and bias; they are
now taken in fp32.
The train step gives a zero gradient only to the parameters the model
declares behind a stop_gradient (the text pooler), and raises for any other
trainable parameter cut off from the loss.
"""

import pytest
import torch

from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import factory
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.ops import flash_attention as fa
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import losses_of, make_train_step
from mmgl_tpu_torch.utils.tokenizer import ByteTokenizer

# every launcher of the kernel wrappers
LAUNCHERS = ("_launch_fused", "_launch_bwd", "_launch_blocked_bwd",
             "_launch_bias", "_launch_bias_bwd", "_launch_allheads",
             "_launch_allheads_bwd", "_launch_flash")


def _args(model, *extra):
    """Tiny flags whose lengths reach the kernel routes: an encoder or
    prompt of 96 tokens and a summary of 32 (K7 for T5, K1 and K2 for
    OPT, K2 for the images)."""
    args, _ = cli.parse_cli([
        "--model_name_or_path", model, "--task", "section", "--context",
        "all", "--neighbor_mode", "raw", "--max_input_length", "96",
        "--max_output_length", "32", "--seed", "0", "--device", "cpu",
        *extra])
    args.decoder_only = "t5" not in model
    return args


def _step(args, batch, tok):
    """(logits, loss, gradients) of one forward and backward."""
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    out = model(batch)
    loss, _ = losses_of(out, args.decoder_only, args.max_input_length,
                        tok.pad_token_id)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.requires_grad}
    return out["logits"].detach(), loss.detach(), grads


@pytest.mark.parametrize("model", ["t5-tiny", "opt-tiny"])
def test_use_pallas_false_launches_no_kernel(model, monkeypatch):
    """With the card path taken on the CPU (every launcher replaced by one
    that records its call), a forward and backward at --use_pallas false
    launches no kernel; its logits equal the kernel route's plain versions
    and its gradients agree with them (atol 1e-5 of the largest)."""
    tok = ByteTokenizer()
    args = _args(model)
    train_ds = cli.setup_data(args, tok)[0]
    batch = next(iter(cli.PrefetchLoader(train_ds, batch_size=2,
                                         num_workers=1)))
    want = _step(args, batch, tok)

    launched = []

    def launcher(name):
        def launch(*a, **kw):
            launched.append(name)
            raise AssertionError(f"{name} launched at --use_pallas false")
        return launch

    monkeypatch.setattr(fa, "_plain", lambda q: False)
    for name in LAUNCHERS:
        monkeypatch.setattr(fa, name, launcher(name))
    logits, loss, grads = _step(_args(model, "--use_pallas", "false"), batch,
                                tok)
    assert launched == []
    assert torch.equal(logits, want[0]) and torch.equal(loss, want[1])
    assert grads.keys() == want[2].keys()
    scale = max(float(g.abs().max()) for g in want[2].values())
    for name, g in grads.items():
        torch.testing.assert_close(g, want[2][name], atol=1e-5 * scale,
                                   rtol=0, msg=name)


def _refuse_building(monkeypatch):
    """Make building the model itself raise, so that build_model's checks
    run on a CUDA device without a card."""
    def built(*a, **kw):
        raise AssertionError("the model was built")

    monkeypatch.setattr(factory, "MMGLModel", built)


def test_float16_on_cuda_passes_the_checks_and_the_kernels_take_it(
        monkeypatch):
    """C3 repaired: --bf16 true --compute_dtype float16 on a CUDA device
    passes build_model's checks and reaches the build (monkeypatched to
    raise there, so no card is needed), as bfloat16 does; the model's
    compute dtype is float16; and the kernel wrappers' input check accepts
    float16 q/k/v and a float16 bias on the card (it refuses float64)."""
    argv = ["--model_name_or_path", "t5-base", "--bf16", "true",
            "--device", "cpu"]
    args, _ = cli.parse_cli(argv + ["--compute_dtype", "float16"])
    assert factory.build_fusion_config(args).t5.dtype == torch.float16
    _refuse_building(monkeypatch)
    for dtype in ("float16", "bfloat16"):
        args, _ = cli.parse_cli(argv + ["--compute_dtype", dtype])
        with pytest.raises(AssertionError, match="was built"):
            build_model(args, torch.device("cuda"))

    # the card's checks, on stand-ins that carry a CUDA tensor's metadata
    # (contiguous strides, an aligned address)
    class OnCard:
        device = torch.device("cuda", 0)

        def __init__(self, shape, dtype):
            self.shape, self.dtype = torch.Size(shape), dtype

        def dim(self):
            return len(self.shape)

        def stride(self):
            return tuple(torch.Size(self.shape[i + 1:]).numel()
                         for i in range(len(self.shape)))

        def data_ptr(self):
            return 1 << 20

    monkeypatch.setattr(fa, "_check_layout", lambda name, *ts: None)
    q = OnCard((2, 64, 2, 64), torch.float16)
    assert fa._tensor_cores(q)
    fa._check("k", q, q, q, None)
    fa._check_bias("k", q, q, OnCard((2, 64, 64), torch.float16))
    fa._check_bias("k", q, q, OnCard((2, 64, 64), torch.float32))
    wide = OnCard((2, 64, 2, 64), torch.float64)
    with pytest.raises(ValueError, match="float16"):
        fa._check("k", wide, wide, wide, None)
    with pytest.raises(ValueError, match="bias must be"):
        fa._check_bias("k", q, q, OnCard((2, 64, 64), torch.bfloat16))


@pytest.mark.parametrize("model,head_dim", [("opt-2.7b", 80),
                                            ("opt-6.7b", 128)])
def test_head_dims_80_and_128_build_on_cuda(model, head_dim, monkeypatch):
    """B4 repaired: OPT-2.7B (head dim 80) and 6.7B (128) on a CUDA device
    pass build_model's checks and reach the build (monkeypatched to raise
    there, so no card is needed); on the card the wrappers of K1 and
    K3-K6 accept the head dim, and K2's and K7's refuse it, naming ROADMAP
    B (no model sends them another than 64)."""
    _refuse_building(monkeypatch)
    args, _ = cli.parse_cli(["--model_name_or_path", model, "--device",
                             "cpu"])
    assert factory.build_fusion_config(args).opt.head_dim == head_dim
    with pytest.raises(AssertionError, match="was built"):
        build_model(args, torch.device("cuda"))

    class OnCard:
        device = torch.device("cuda", 0)

        def __init__(self, shape, dtype):
            self.shape, self.dtype = torch.Size(shape), dtype

        def dim(self):
            return len(self.shape)

    monkeypatch.setattr(fa, "_check_layout", lambda name, *ts: None)
    q = OnCard((2, 64, 2, head_dim), torch.bfloat16)
    for name in ("flash_attention_allheads", "flash_attention_allheads_bwd",
                 "flash_attention", "flash_attention_bwd",
                 "flash_attention_blocked_bwd"):
        fa._check(name, q, q, q, None)
    for name in ("fused_heads_attention", "flash_attention_bias"):
        with pytest.raises(ValueError, match="ROADMAP B"):
            fa._check(name, q, q, q, None)


def test_a_plain_test_pass_reaches_prepare(monkeypatch):
    """A plain --test true run reaches prepare, the model's build, with
    the one-rank mesh (the multi-device flags are ported:
    tests/test_torch_parallel.py)."""
    class Built(Exception):
        pass

    def prepare(args, device, mesh=None):
        assert mesh is not None and mesh.shape == (1, 1)
        raise Built

    monkeypatch.setattr(cli, "prepare", prepare)
    monkeypatch.setattr(cli, "start_wandb", lambda args, is_main=True: None)
    with pytest.raises(Built):
        cli.main(["--model_name_or_path", "opt-tiny", "--device", "cpu",
                  "--test", "true"])


@pytest.mark.parametrize("cut", [False, True])
def test_train_step_raises_for_a_parameter_cut_off_from_the_loss(cut):
    """One update of t5-tiny in the embedding mode: the text pooler, behind
    the text tower's stop_gradient, gets a zero gradient and the step runs;
    with the text projection's output detached (a wiring fault), its
    weights get no gradient and the step raises naming them."""
    args, _ = cli.parse_cli([
        "--model_name_or_path", "t5-tiny", "--task", "section", "--context",
        "section_all", "--neighbor_mode", "embedding", "--max_input_length",
        "32", "--max_output_length", "16", "--max_text_neighbors", "2",
        "--max_image_neighbors", "1", "--n_text_tokens", "2",
        "--n_visual_tokens", "2", "--seed", "0", "--device", "cpu"])
    args.decoder_only = False
    tok = ByteTokenizer()
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    assert model.gradless_prefixes == ("text_pooler.",)
    if cut:
        project = model.project_text
        model.project_text = lambda *a, **kw: project(*a, **kw).detach()
    train_ds = cli.setup_data(args, tok)[0]
    batch = next(iter(cli.PrefetchLoader(train_ds, batch_size=2,
                                         num_workers=1)))
    opt, sched = build_optimizer(args, model)
    step = make_train_step(model, opt, sched, False, args.max_input_length,
                           tok.pad_token_id)
    if cut:
        with pytest.raises(RuntimeError, match="text_embeddings.weight"):
            step(batch)
    else:
        assert torch.isfinite(step(batch)["grad_norm"])


@pytest.mark.parametrize("model", ["opt-tiny", "t5-tiny"])
def test_bf16_parameters_run_as_fp32_parameters_of_the_same_values(model):
    """C4 repaired: with --param_dtype bfloat16 (and bf16 compute) the
    forward runs, and equals bit for bit the forward of fp32 parameters
    holding the same bf16-rounded values: every layer casts its parameters
    to the compute dtype (LayerNorm's scale and bias to fp32) at use."""
    args = _args(model, "--bf16", "true", "--param_dtype", "bfloat16")
    tok = ByteTokenizer()
    ds = cli.setup_data(args, tok)[2]
    batch = next(iter(cli.PrefetchLoader(ds, batch_size=2, num_workers=1)))
    half, _ = build_model(args, torch.device("cpu"),
                          vocab_size=tok.vocab_size, tokenizer=tok)
    assert {p.dtype for p in half.parameters()} == {torch.bfloat16}
    args.param_dtype = "float32"
    full, _ = build_model(args, torch.device("cpu"),
                          vocab_size=tok.vocab_size, tokenizer=tok)
    full.load_state_dict({k: v.float() for k, v in
                          half.state_dict().items()})
    with torch.no_grad():
        got = half.eval()(batch)["logits"]
        want = full.eval()(batch)["logits"]
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
