"""Test-time entry point (counterpart of mmgl_tpu/cli.py:43-70, 157-358,
551-691).

Takes the JAX package's flag surface (mmgl_tpu.config.parse_args) plus
``--device`` (default ``cuda``). Only ``--test true`` is ported: build the
model with seeded random weights, then the test pass of ``evaluate_loop``:
the teacher-forced eval step, greedy KV-cache decode and BLEU/ROUGE/CIDEr
through mmgl_tpu.metrics. One device: no mesh, no gather.

    python -m mmgl_tpu_torch.cli --model_name_or_path opt-125m \
        --task section --context all --neighbor_mode raw --test true \
        --bf16 true --tokenizer_path byte:50272 --device cuda

``--device cuda`` on a host without a visible GPU fails: there is no CPU
fallback. Pass ``--device cpu`` to run the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmgl_tpu.config import Arguments, parse_args
from mmgl_tpu.metrics import Cider, bleu_score, rouge_score
from mmgl_tpu.utils.meters import AverageMeter
from mmgl_tpu.utils.tokenizer import get_tokenizer
from mmgl_tpu_torch.data.assemble import AssemblerConfig, WikiWeb2MAssembler
from mmgl_tpu_torch.data.loader import PrefetchLoader
from mmgl_tpu_torch.data.synthetic import make_synthetic_corpus
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.steps import make_eval_step

MAX_NEW_TOKENS = 32


def setup_data(args: Arguments, tokenizer):
    """(train, val, test) assemblers: the WikiWeb2M parquet under
    --data_dir if present, else the synthetic corpus."""
    cfg = AssemblerConfig.from_args(args)
    parquet = os.path.join(args.data_dir, "wikiweb2m_train_large.parquet")
    if os.path.exists(parquet):
        from mmgl_tpu_torch.data.images import disk_image_provider
        from mmgl_tpu_torch.data.store import load_wikiweb2m

        train_s, val_s, test_s, ids = load_wikiweb2m(args.task, args.data_dir)
        provider = disk_image_provider(args.data_dir, args.visual_model)
        mk = lambda store, idl: WikiWeb2MAssembler(cfg, store, idl, tokenizer,
                                                   provider)
        return (mk(train_s, ids["train"]), mk(val_s, ids["val"]),
                mk(test_s, ids["test"]))
    print(f"[data] no parquet under {args.data_dir}; using synthetic corpus")
    cfg.image_size = 32 if "tiny" in (args.model_name_or_path or "") else 224
    store, ids, provider = make_synthetic_corpus(
        num_pages=64, image_size=cfg.image_size, seed=args.seed or 0)
    n = len(ids)
    cut1, cut2 = int(n * 0.8), int(n * 0.9)
    mk = lambda idl: WikiWeb2MAssembler(cfg, store, idl, tokenizer, provider)
    return mk(ids[:cut1]), mk(ids[cut1:cut2]), mk(ids[cut2:])


def first_period_truncate(caption: str) -> str:
    """Eval heuristic (run_generation.py:624-630)."""
    stop = caption.find(".")
    return caption[:stop] if stop > 5 else caption


def parse_cli(argv=None) -> Tuple[Arguments, torch.device]:
    """``--device`` is read here; every other flag goes to the shared
    mmgl_tpu.config parser unchanged."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    return parse_args(rest), torch.device(ns.device)


def check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device is visible. The port has no "
            "CPU fallback on the GPU path; pass --device cpu to run the "
            "kernels' plain versions on the CPU.")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {device}: expected cuda or cpu")


@dataclass
class EvalSetup:
    """What the test pass runs: the model and the functions over it."""
    model: torch.nn.Module
    fcfg: object
    tokenizer: object
    loader: PrefetchLoader
    eval_step: Callable[[Dict], Dict]
    generate_fn: Callable[[Dict], torch.Tensor]


def prepare(args: Arguments, device: torch.device) -> EvalSetup:
    """Tokenizer, seeded model, test loader, eval step and generator."""
    check_device(device)
    tokenizer = get_tokenizer(args.tokenizer_path)
    name = args.model_name_or_path or "opt-tiny"
    args.decoder_only = "t5" not in name
    model, fcfg = build_model(args, device, vocab_size=tokenizer.vocab_size,
                              tokenizer=tokenizer)
    _, _, test_ds = setup_data(args, tokenizer)
    print(f"Testing with {len(test_ds)} examples.")
    loader = PrefetchLoader(test_ds, batch_size=args.per_device_val_batch_size,
                            prefetch=args.prefetch_batches,
                            num_workers=args.dataloader_num_workers)
    eval_step = make_eval_step(model, args.decoder_only,
                               args.max_input_length, tokenizer.pad_token_id)
    generate_fn = partial(greedy_generate, model,
                          max_new_tokens=MAX_NEW_TOKENS)
    return EvalSetup(model, fcfg, tokenizer, loader, eval_step, generate_fn)


def run(args: Arguments, device: torch.device,
        log_fn: Optional[Callable[[Dict[str, float], int], None]] = None
        ) -> Dict[str, float]:
    """The ``--test true`` pass; returns evaluate_loop's metrics."""
    if not args.test:
        raise NotImplementedError("training is ported in a later PR")
    test = prepare(args, device)
    return evaluate_loop(test, args, args.start_epoch,
                         log_fn or (lambda scalars, step: None),
                         prefix="test")


def main(argv=None) -> Dict[str, float]:
    args, device = parse_cli(argv)
    return run(args, device)


def _score_corpus(all_preds: List[str], all_refs: List[List[str]]):
    """BLEU-1..4, ROUGE and CIDEr over the corpus, in this process (the JAX
    package farms them to processes only past 2048 pairs)."""
    bleus = [bleu_score(all_preds, all_refs, n_gram=n) for n in (1, 2, 3, 4)]
    rouges = rouge_score(all_preds, all_refs)
    cands = {i: [p] for i, p in enumerate(all_preds)}
    refs = {i: r for i, r in enumerate(all_refs)}
    cider = Cider().compute_score(refs, cands)[0]
    return bleus, rouges, cider


def evaluate_loop(test: EvalSetup, args: Arguments, epoch: int,
                  log: Callable[[Dict[str, float], int], None],
                  prefix: str = "val") -> Dict[str, float]:
    """Counterpart of mmgl_tpu.cli.evaluate_loop (run_generation.py:527-703
    in the reference).

    Each batch's device work (eval step, then decode on the test pass) is
    timed to a device synchronize and logged as ``{prefix}/batch_seconds``
    with ``{prefix}/batch_sections``; decoding to text and scoring run on
    the host after it."""
    device = test.model.device
    tokenizer = test.tokenizer
    losses = AverageMeter("Loss", ":.4e")
    forward_time = AverageMeter("Forward", ":6.3f")
    all_preds, all_refs = [], []
    steps = 0
    for batch in test.loader:
        start = time.perf_counter()
        out = test.eval_step(batch)
        generated = (test.generate_fn(batch) if prefix == "test"
                     else out["predictions"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - start
        bs = batch["input_ids"].shape[0]
        forward_time.update(seconds)
        log({f"{prefix}/batch_seconds": seconds,
             f"{prefix}/batch_sections": float(bs)}, steps)

        losses.update(float(out["loss"]), bs)
        labels = batch["labels"][:, args.max_input_length + 1:]
        generated = generated.cpu().numpy()
        if generated.shape[0] != labels.shape[0]:
            raise RuntimeError(f"{generated.shape[0]} predictions for "
                               f"{labels.shape[0]} references")
        preds = tokenizer.batch_decode(generated, skip_special_tokens=True)
        labels = np.where(labels == -100, tokenizer.pad_token_id, labels)
        refs = tokenizer.batch_decode(labels, skip_special_tokens=True)
        for p, r in zip(preds, refs):
            all_preds.append(first_period_truncate(p))
            all_refs.append([r])
        steps += 1
        if steps >= args.val_steps_per_epoch:
            break

    if not all_preds:
        raise RuntimeError(
            f"{prefix} loader produced no batches — dataset smaller than the "
            f"batch (drop_last)? len={len(test.loader.dataset)} "
            f"batch_size={test.loader.batch_size}")

    print("=" * 30)
    print(f"Computing BLEU with {len(all_preds)} generated captions and "
          f"{len(all_refs)} groundtruth captions.")
    for i, cap in enumerate(all_preds[:5]):
        print(f"{i}) {cap}")
    print("=" * 30)

    bleus, rouges, cider = _score_corpus(all_preds, all_refs)
    print("BLEU", *bleus)
    print("ROUGE", rouges["rouge1_fmeasure"], rouges["rouge2_fmeasure"],
          rouges["rougeL_fmeasure"], rouges["rougeLsum_fmeasure"])
    print("CIDER", cider)

    actual_step = max(0, (epoch + 1) * args.steps_per_epoch
                      // args.grad_accumulation_steps)
    log({f"{prefix}/loss": losses.avg,
         "metrics/total_secs_captioning": forward_time.avg,
         f"{prefix}/bleu1": bleus[0], f"{prefix}/bleu2": bleus[1],
         f"{prefix}/bleu3": bleus[2], f"{prefix}/bleu4": bleus[3],
         f"{prefix}/rouge1": rouges["rouge1_fmeasure"],
         f"{prefix}/rouge2": rouges["rouge2_fmeasure"],
         f"{prefix}/rougeL": rouges["rougeL_fmeasure"],
         f"{prefix}/rougeLsum": rouges["rougeLsum_fmeasure"],
         f"{prefix}/cider": cider}, actual_step)

    return {"loss": losses.avg, "bleu1": bleus[0], "bleu2": bleus[1],
            "bleu3": bleus[2], "bleu4": bleus[3], "cider": cider,
            "n_eval_pairs": float(len(all_preds)),
            **{k: v for k, v in rouges.items()}}


if __name__ == "__main__":
    print(main())
