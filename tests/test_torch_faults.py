"""Faults of the port against the JAX package, each held by a CPU test.

C1: ``--use_pallas false`` sends every attention to the plain route, as the
JAX factory's ``use_pallas=False`` sends it to ``xla_attention``
(mmgl_tpu/models/factory.py:65-68, 81, 147).
C2: a local checkpoint directory raises until its import is ported
(ROADMAP A4), where the JAX package overlays it.
C3: float16 compute on a CUDA device is refused before the model is built:
the kernels take float32 and bfloat16.
"""

import pytest
import torch

from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import factory
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.ops import flash_attention as fa
from mmgl_tpu_torch.train.steps import losses_of
from mmgl_tpu_torch.utils.tokenizer import ByteTokenizer

# every launcher of the kernel wrappers
LAUNCHERS = ("_launch", "_launch_bwd", "_launch_blocked_bwd", "_launch_bias",
             "_launch_bias_bwd")


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


@pytest.mark.parametrize("flag", ["--model_name_or_path", "--visual_model",
                                  "--text_model"])
def test_checkpoint_directory_raises(flag, tmp_path):
    """C2: a local checkpoint directory, which the JAX package overlays on
    the initialized weights, raises instead of training random weights;
    the message names ROADMAP A4."""
    ckpt = tmp_path / "t5-base"
    ckpt.mkdir()
    argv = ["--model_name_or_path", "t5-tiny", "--device", "cpu"]
    args, _ = cli.parse_cli(argv + [flag, str(ckpt)])
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        build_model(args, torch.device("cpu"))
    args, _ = cli.parse_cli(argv)
    build_model(args, torch.device("cpu"))


def test_float16_on_cuda_is_refused_before_the_model_is_built(monkeypatch):
    """C3: --bf16 true --compute_dtype float16 on a CUDA device raises in
    build_model, with the reason, before any module is built (only the
    dtype check runs, so no card is needed); on the CPU float16 builds,
    and bfloat16 passes the check on a CUDA device."""
    def built(*a, **kw):
        raise AssertionError("the model was built")

    argv = ["--model_name_or_path", "t5-tiny", "--bf16", "true",
            "--device", "cpu"]
    args, _ = cli.parse_cli(argv + ["--compute_dtype", "float16"])
    build_model(args, torch.device("cpu"))
    monkeypatch.setattr(factory, "build_fusion_config", built)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        build_model(args, torch.device("cuda"))
    args, _ = cli.parse_cli(argv + ["--compute_dtype", "bfloat16"])
    with pytest.raises(AssertionError, match="was built"):
        build_model(args, torch.device("cuda"))
