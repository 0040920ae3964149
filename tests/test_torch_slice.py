"""The port's test-time slice against the JAX package, on the CPU.

opt-tiny, task=section, context=all, raw neighbors, 32 px images, fp32. The
JAX model initializes the weights, which reach the port through
mmgl_tpu_torch.utils.convert; batches come from the port's loader (its data
layer gives the JAX package's batches, tests/test_torch_data.py). Prompt 96
+ summary 32 = 128 tokens, so eval attention takes K1's route and the 96-token
prefill K2's, through their plain versions here.
"""

import os
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu.train.steps import make_eval_step as jax_eval_step
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.steps import make_eval_step
from mmgl_tpu_torch.utils.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--model_name_or_path", "opt-tiny", "--task", "section",
        "--context", "all", "--neighbor_mode", "raw", "--test", "true",
        "--max_input_length", "96", "--max_output_length", "32",
        "--per_device_val_batch_size", "2", "--val_steps_per_epoch", "2",
        "--dataloader_num_workers", "1", "--seed", "0"]
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax")


@pytest.fixture(scope="module")
def pair():
    """(args, batch, JAX model, JAX params, port model) on shared weights."""
    tok = ByteTokenizer()
    args, _ = cli.parse_cli(TINY + ["--device", "cpu"])
    args.decoder_only = True
    _, _, test_ds = cli.setup_data(args, tok)
    batch = next(iter(cli.PrefetchLoader(test_ds, batch_size=4,
                                         num_workers=1)))
    jmodel, _ = jfactory.build_model(args, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    params = jmodel.init(jax.random.PRNGKey(0), batch)["params"]
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return args, batch, jmodel, params, model


def test_eval_step_matches_jax(pair):
    args, batch, jmodel, params, model = pair
    want = jax.jit(jax_eval_step(jmodel, True, args.max_input_length,
                                 0))(params, batch)
    got = make_eval_step(model, True, args.max_input_length, 0)(batch)
    for key in ("loss", "summary_loss"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-5, key
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))


def test_greedy_generate_matches_jax(pair):
    args, batch, jmodel, params, model = pair
    want = jax.jit(partial(jax_generate, jmodel, max_new_tokens=32))(
        {"params": params}, batch)
    got = greedy_generate(model, batch, max_new_tokens=32)
    assert got.shape == (4, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_test_pass_keys(pair):
    """The metric keys of the JAX package's evaluate_loop test pass (run
    here on stub steps: the keys do not depend on the model)."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    from mmgl_tpu import cli as jcli

    args, batch = pair[:2]
    b = batch["input_ids"].shape[0]
    return jcli.evaluate_loop(
        [batch], None, SimpleNamespace(params={}),
        lambda params, x: {"loss": jnp.float32(1.0)},
        lambda variables, x: jnp.full((b, 32), 4 + ord("a"), jnp.int32),
        ByteTokenizer(), args, SimpleNamespace(decoder_only=True),
        jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                          ("data", "model")), 0, lambda *a: None,
        prefix="test")


def test_cli_test_pass_end_to_end(pair):
    """The port's --test pass runs and returns the metric keys of the JAX
    package's evaluate_loop."""
    got = cli.main(TINY + ["--device", "cpu"])
    assert sorted(got) == sorted(_jax_test_pass_keys(pair))
    assert got["n_eval_pairs"] == 4.0     # 2 batches of 2
    assert all(np.isfinite(v) for v in got.values())


TRAIN = TINY + ["--test", "false", "--per_device_train_batch_size", "2",
                "--grad_accumulation_steps", "2", "--steps_per_epoch", "4",
                "--epochs", "1"]


def test_cli_training_end_to_end(pair, tmp_path):
    """Training through the entry point: the epoch-0 val pass, two updates,
    the val pass with the best checkpoint, then the test pass on it; returns
    the JAX package's test metric keys plus train_updates."""
    logged = []
    args, device = cli.parse_cli(TRAIN + ["--log_dir", str(tmp_path),
                                          "--device", "cpu"])
    got = cli.run(args, device, lambda scalars, step: logged.append(
        (step, scalars)))
    assert got["train_updates"] == 2.0
    del got["train_updates"]
    test_keys = _jax_test_pass_keys(pair)
    assert sorted(got) == sorted(test_keys)
    assert all(np.isfinite(v) for v in got.values())
    train = [s for step, s in logged if "train/loss" in s]
    assert len(train) == 1 and np.isfinite(train[0]["train/loss"])
    assert (tmp_path / "default_0" / "ckpt" / "checkpoint.pt").exists()

    # the test pass alone on the trained checkpoint (--resume)
    args, device = cli.parse_cli(TINY + ["--log_dir", str(tmp_path),
                                         "--resume", "default_0",
                                         "--device", "cpu"])
    assert cli.run(args, device) == got


def test_remat_is_refused_only_in_training(tmp_path):
    """--remat is ported in training (it was refused there): a training
    run with it through the entry point returns the metrics of the run
    without it, and logs the same training losses."""
    runs = []
    for remat in ("false", "true"):
        logged = []
        args, device = cli.parse_cli(TRAIN + [
            "--remat", remat, "--val_steps_per_epoch", "1", "--log_dir",
            str(tmp_path), "--device", "cpu"])
        got = cli.run(args, device, lambda scalars, step: logged.append(
            (step, scalars.get("train/loss"))))
        runs.append((got, [x for x in logged if x[1] is not None]))
    assert runs[0][0]["train_updates"] == 2.0 and runs[0][1]
    assert runs[0] == runs[1]


def test_slice_runs_without_jax(tmp_path):
    """jax, jaxlib, flax, optax and orbax unimportable: the port still runs
    the whole test pass and a training run, and loads none of them."""
    train = TRAIN + ["--log_dir", str(tmp_path), "--device", "cpu"]
    code = (
        "import sys\n"
        f"for m in {JAX_MODULES!r}: sys.modules[m] = None\n"
        "from mmgl_tpu_torch import cli\n"
        f"r = cli.main({TINY + ['--device', 'cpu']!r})\n"
        "assert r['n_eval_pairs'] == 4.0, r\n"
        f"r = cli.main({train!r})\n"
        "assert r['train_updates'] == 2.0, r\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{JAX_MODULES!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX_OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_device_cuda_without_a_gpu_fails():
    """No CPU fallback: --device cuda on a host without a GPU exits
    non-zero and says why."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda would run")
    proc = subprocess.run(
        [sys.executable, "-m", "mmgl_tpu_torch.cli", *TINY, "--device",
         "cuda"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr
