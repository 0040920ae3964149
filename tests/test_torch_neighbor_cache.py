"""The port's neighbour cache (mmgl_tpu_torch/data/neighbor_cache.py)
against the JAX package's (mmgl_tpu/data/neighbor_cache.py), on the CPU.

Both caches wrap the port's assembler over the synthetic corpus (its
samples are the JAX package's, tests/test_torch_data.py) and run on the
same weights: the port's seeded ones, handed to the JAX model as
tests/test_torch_peft.py's ``shape_pair`` does, the flamingo gates seeded
non-zero. Tiny configs in fp32, dropout off. Each test states its
tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.data.neighbor_cache import \
    CachedNeighborDataset as JaxCachedNeighborDataset
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.data.neighbor_cache import CachedNeighborDataset
from mmgl_tpu_torch.utils import convert
from test_torch_embedding import TINY, _close
from test_torch_peft import perturb, shape_pair

# (model, context, neighbour mode, flags): raw images, the embedding mode's
# text and images (OPT, T5) and MPT's memory
CASES = {"opt-raw-all": ("opt-tiny", "all", "raw", ()),
         "opt-emb-all": ("opt-tiny", "all", "embedding", ()),
         "t5-emb-section_all": ("t5-tiny", "section_all", "embedding", ()),
         "mpt-flamingo-all": ("mpt-tiny", "all", "embedding",
                              ("--peft_type", "flamingo"))}
# the pooled arrays each case caches
POOLED = {"opt-raw-all": ("images_pooled",),
          "opt-emb-all": ("neighbor_text_pooled", "neighbor_image_pooled"),
          "t5-emb-section_all": ("neighbor_text_pooled",
                                 "neighbor_image_pooled"),
          "mpt-flamingo-all": ("neighbor_text_pooled",
                               "neighbor_image_pooled")}
RAW = ("images", "images_valid", "neighbor_input_ids",
       "neighbor_attention_mask", "neighbor_images")
_PAIRS = {}


def _args(case, *extra):
    model, context, mode, flags = CASES[case]
    args, _ = cli.parse_cli(["--model_name_or_path", model, "--context",
                             context, *TINY, "--neighbor_mode", mode, *flags,
                             *extra])
    args.decoder_only = "t5" not in model
    return args


def _stack(dataset, n=2):
    samples = [dataset[i] for i in range(n)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _pair(case):
    """(args, the test split, the JAX model and params, the port's model
    on them), cached per case."""
    if case not in _PAIRS:
        args = _args(case)
        ds = cli.setup_data(args, ByteTokenizer())[2]
        jmodel, params, model = shape_pair(args, _stack(ds, 4))
        params = perturb(params)
        model.load_state_dict(convert.state_dict_from_jax(params))
        _PAIRS[case] = (args, ds, jmodel, params, model)
    return _PAIRS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_pooled_arrays_match_jax(case):
    """The cached pooled arrays of the whole split against the JAX
    package's cache on the same weights, fp32, atol 1e-5; the samples
    served without the raw ids and pixels, as the JAX package's are."""
    args, ds, jmodel, params, model = _pair(case)
    got = CachedNeighborDataset(ds, model, batch_size=3, verbose=False,
                                num_workers=1)
    want = JaxCachedNeighborDataset(ds, jmodel, {"params": params},
                                    batch_size=3, verbose=False,
                                    num_workers=1)
    for attr in ("_text_cache", "_image_cache", "_raw_image_cache"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g is None) == (w is None), attr
        if g is not None:
            assert g.dtype == np.float32 and g.shape == w.shape
            _close(g, w, 1e-5, attr)
    sample, jsample = got[0], want[0]
    assert set(sample) == set(jsample)
    assert set(POOLED[case]) <= set(sample)
    assert not set(RAW) & set(sample)


@pytest.mark.parametrize("case", list(CASES))
def test_cached_logits_match_live_and_jax(case):
    """The port's logits from cached features against its live towers on
    the same samples, and against the JAX package's cached logits, atol
    1e-4 each; the labels exact."""
    args, ds, jmodel, params, model = _pair(case)
    cached = CachedNeighborDataset(ds, model, batch_size=2, verbose=False,
                                   num_workers=1)
    live_batch, cached_batch = _stack(ds), _stack(cached)
    with torch.no_grad():
        live = model(live_batch)
        fast = model(cached_batch)
    want = jax.jit(jmodel.apply)({"params": params}, cached_batch)
    np.testing.assert_array_equal(fast["labels"].numpy(),
                                  live["labels"].numpy())
    np.testing.assert_array_equal(fast["labels"].numpy(),
                                  np.asarray(want["labels"]))
    _close(fast["logits"], live["logits"], 1e-4, "cached vs live")
    _close(fast["logits"], want["logits"], 1e-4, "cached vs JAX cached")


def test_disk_cache_cold_warm_and_miss(tmp_path, monkeypatch):
    """A cold build writes one .npz; a warm start reads the same arrays and
    runs no tower (the pooling methods raise); a changed
    --max_text_neighbors probes other sample shapes and misses, writing a
    second file."""
    args, ds, _, _, model = _pair("opt-emb-all")
    kw = dict(batch_size=3, verbose=False, num_workers=1,
              cache_dir=str(tmp_path), split="test")
    cold = CachedNeighborDataset(ds, model, **kw)
    assert len(list(tmp_path.glob("neighbor_cache_*.npz"))) == 1

    def tower(*a, **k):
        raise AssertionError("a tower ran on a warm start")

    with monkeypatch.context() as m:
        m.setattr(model, "pool_text", tower)
        m.setattr(model, "pool_images", tower)
        warm = CachedNeighborDataset(ds, model, **kw)
        for i in range(len(ds)):
            c, w = cold[i], warm[i]
            assert set(c) == set(w)
            for k in c:
                np.testing.assert_array_equal(c[k], w[k], err_msg=f"{i} {k}")

    fewer = cli.setup_data(_args("opt-emb-all", "--max_text_neighbors", "2"),
                           ByteTokenizer())[2]
    missed = CachedNeighborDataset(fewer, model, **kw)
    assert len(list(tmp_path.glob("neighbor_cache_*.npz"))) == 2
    assert missed[0]["neighbor_text_pooled"].shape[0] == 2


def _train_losses(extra, log_dir):
    losses = []

    def log(scalars, step):
        if "train/loss" in scalars:
            losses.append(scalars["train/loss"])

    args, device = cli.parse_cli(
        ["--model_name_or_path", "opt-tiny", "--context", "all", *TINY,
         "--epochs", "1", "--log_dir", str(log_dir), *extra])
    results = cli.run(args, device, log)
    assert results["train_updates"] == 2.0
    return losses, results


def test_cli_training_with_the_cache_matches_without(tmp_path):
    """Two CLI updates of opt-tiny (embedding mode, context all) give the
    same losses with --cache_neighbor_embeddings true as without, and the
    same final test loss (atol 1e-5): the flag is applied, not refused."""
    live, live_res = _train_losses([], tmp_path / "live")
    cached, cached_res = _train_losses(
        ["--cache_neighbor_embeddings", "true", "--neighbor_cache_dir",
         str(tmp_path / "cache")], tmp_path / "cached")
    assert len(live) == len(cached) == 2
    _close(cached, live, 1e-5, "losses")
    _close(cached_res["loss"], live_res["loss"], 1e-5, "test loss")
    # train, val and test each cached once
    assert len(list((tmp_path / "cache").glob("neighbor_cache_*.npz"))) == 3


def test_test_pass_with_the_cache_decodes_the_same_tokens():
    """--test true with the cache (raw context all: the spliced images'
    CLIP features cached) wraps the test split and greedy-decodes the same
    tokens as without; the eval step's loss agrees (atol 1e-5)."""
    argv = ["--model_name_or_path", "opt-tiny", "--context", "all", *TINY,
            "--neighbor_mode", "raw", "--test", "true"]
    out = {}
    for flag in ("false", "true"):
        args, device = cli.parse_cli(argv + ["--cache_neighbor_embeddings",
                                             flag])
        test = cli.prepare(args, device)
        assert isinstance(test.loader.dataset,
                          CachedNeighborDataset) == (flag == "true")
        batch = next(iter(test.loader))
        assert ("images_pooled" in batch) == (flag == "true")
        out[flag] = (test.generate_fn(batch).numpy(),
                     float(test.eval_step(batch)["loss"]))
    np.testing.assert_array_equal(out["true"][0], out["false"][0])
    _close(out["true"][1], out["false"][1], 1e-5, "eval loss")
