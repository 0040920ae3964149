"""The port stands alone: no module of mmgl_tpu_torch, and not
chip_smoke.py, imports anything of the JAX package or of JAX itself; and
the modules it copied from the JAX package (config, metrics, tokenizer,
meters) are those modules with only their imports rewritten."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in (ROOT / "mmgl_tpu_torch").rglob("*.py")) + [
                        "chip_smoke.py"]
FORBIDDEN = ("mmgl_tpu", "jax", "jaxlib", "flax", "optax", "orbax")


def forbidden_imports(source: str):
    """The imported module names of ``source`` that belong to the JAX
    package or to JAX, at any depth (function bodies included)."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_nothing_of_jax(path):
    assert forbidden_imports((ROOT / path).read_text()) == []


@pytest.mark.parametrize("source", [
    "import mmgl_tpu", "from mmgl_tpu import config",
    "from mmgl_tpu.utils.meters import AverageMeter",
    "def f():\n    import jax.numpy as jnp\n", "import flax.linen as nn",
    "from optax import adafactor"])
def test_the_check_catches_each_form(source):
    assert forbidden_imports(source)


def test_the_check_passes_the_port_names():
    assert forbidden_imports("import mmgl_tpu_torch.cli\n"
                             "from mmgl_tpu_torch import ops\n"
                             "from . import flash_attention") == []


# copy -> (original, the text of the original the copy keeps)
COPIES = {
    "mmgl_tpu_torch/config.py": "mmgl_tpu/config.py",
    "mmgl_tpu_torch/metrics/__init__.py": "mmgl_tpu/metrics/__init__.py",
    "mmgl_tpu_torch/metrics/bleu.py": "mmgl_tpu/metrics/bleu.py",
    "mmgl_tpu_torch/metrics/rouge.py": "mmgl_tpu/metrics/rouge.py",
    "mmgl_tpu_torch/metrics/cider.py": "mmgl_tpu/metrics/cider.py",
    "mmgl_tpu_torch/utils/tokenizer.py": "mmgl_tpu/utils/tokenizer.py",
    "mmgl_tpu_torch/utils/meters.py": "mmgl_tpu/utils/meters.py",
}


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copy_is_its_original_with_the_imports_rewritten(copy):
    original = (ROOT / COPIES[copy]).read_text()
    if copy.endswith("meters.py"):
        # only AverageMeter, ProgressMeter and Summary: get_params_count
        # imports jax (peft/masks.count_params covers it)
        original = original[:original.index("\ndef get_params_count")]
    expected = re.sub(r"\bmmgl_tpu\.", "mmgl_tpu_torch.", original)
    assert (ROOT / copy).read_text().rstrip() == expected.rstrip()


@pytest.mark.parametrize("argv", [
    [], ["--model_name_or_path", "t5-base", "--bf16", "true",
         "--mesh_shape", "4,2", "--test", "true"],
    ["--context", "all", "--learning_rate", "3e-4", "--seed", "5"]])
def test_copied_parser_parses_as_the_original(argv):
    from mmgl_tpu.config import parse_args as jax_parse_args
    from mmgl_tpu_torch.config import parse_args

    assert vars(parse_args(argv)) == vars(jax_parse_args(argv))


def test_copied_metrics_score_as_the_originals():
    from mmgl_tpu import metrics as jm
    from mmgl_tpu_torch import metrics as tm

    preds = ["the cat sat on the mat", "a dog ran", "tpu kernels in cuda"]
    refs = [["the cat is on the mat"], ["a dog ran far"], ["cuda kernels"]]
    for n in (1, 2, 3, 4):
        assert tm.bleu_score(preds, refs, n_gram=n) == jm.bleu_score(
            preds, refs, n_gram=n)
    assert tm.rouge_score(preds, refs) == jm.rouge_score(preds, refs)
    cands = {i: [p] for i, p in enumerate(preds)}
    gts = {i: r for i, r in enumerate(refs)}
    assert tm.Cider().compute_score(gts, cands)[0] == \
        jm.Cider().compute_score(gts, cands)[0]


def test_copied_tokenizer_and_meters_behave_as_the_originals():
    from mmgl_tpu.utils import meters as jmeters
    from mmgl_tpu.utils.tokenizer import get_tokenizer as jax_tok
    from mmgl_tpu_torch.utils import meters
    from mmgl_tpu_torch.utils.tokenizer import get_tokenizer

    for path in (None, "byte:32128"):
        a, b = get_tokenizer(path), jax_tok(path)
        assert (a.vocab_size, a.pad_token_id, a.eos_token_id) == (
            b.vocab_size, b.pad_token_id, b.eos_token_id)
        enc_a = a(["hello world", "x"], max_length=16, padding="max_length",
                  truncation=True)
        enc_b = b(["hello world", "x"], max_length=16, padding="max_length",
                  truncation=True)
        for key in ("input_ids", "attention_mask"):
            assert np.array_equal(enc_a[key], enc_b[key])
        ids = np.asarray(enc_a["input_ids"])
        assert a.batch_decode(ids, skip_special_tokens=True) == \
            b.batch_decode(ids, skip_special_tokens=True)
    m, jm_ = meters.AverageMeter("Loss", ":.3f"), jmeters.AverageMeter(
        "Loss", ":.3f")
    for v, n in ((1.0, 2), (4.0, 1)):
        m.update(v, n)
        jm_.update(v, n)
    assert (str(m), m.avg) == (str(jm_), jm_.avg)
    assert [s.name for s in meters.Summary] == [s.name for s in
                                                  jmeters.Summary]
