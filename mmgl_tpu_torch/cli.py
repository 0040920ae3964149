"""Training and test entry point (counterpart of mmgl_tpu/cli.py:43-70,
157-548, 551-691).

Takes the JAX package's flag surface (``config.parse_args``, the port's copy
of mmgl_tpu/config.py) plus ``--device`` (default ``cuda``).

OPT trains with AdamW, T5 with Adafactor (train/optim.py, chosen by the
model name as the JAX package chooses).

* Training (the default): seeded random weights, the epoch-0 val pass, then
  per epoch ``steps_per_epoch / grad_accumulation_steps`` updates, the val
  pass and a checkpoint when val BLEU-4 improves, and finally the test pass
  on the restored best checkpoint. ``--resume`` restarts after the newest
  of the run's best and ``--save_every_epochs`` checkpoints.
* ``--test true``: only the test pass of ``evaluate_loop``: the
  teacher-forced eval step, greedy KV-cache decode and BLEU/ROUGE/CIDEr
  through the port's copy of mmgl_tpu/metrics.

    python -m mmgl_tpu_torch.cli --model_name_or_path opt-125m \
        --task section --context all --neighbor_mode raw \
        --bf16 true --tokenizer_path byte:50272 --device cuda
    python -m mmgl_tpu_torch.cli --model_name_or_path t5-base \
        --task section --context all --neighbor_mode raw \
        --bf16 true --tokenizer_path byte:32128 --device cuda
    python -m mmgl_tpu_torch.cli --model_name_or_path t5-base \
        --task section --context section_all --neighbor_mode embedding \
        --position_type none --bf16 true --tokenizer_path byte:32128 \
        --device cuda

The embedding mode (the last line: BASELINE config 2) encodes each sample's
neighbor texts with the frozen Roberta tower and its neighbor images with
CLIP, and appends their soft tokens to the LM's input;
``--position_type`` embedding, laplacian or gnn adds its position encoding
(the graph ones with ``--context all``). ``--cache_neighbor_embeddings
true`` runs the frozen towers once over each split before the loop
(data/neighbor_cache.py; with ``--neighbor_cache_dir`` kept on disk for the
next start), in the embedding mode and for the raw mode's images.

Training takes ``--remat``, ``--layerdrop``, ``--fused_ce false`` and
``--chunked_ce n`` (models/opt.py, train/losses.py). ``--log_to_wandb true`` logs to wandb, or
prints ``[wandb] disabled: <error>`` where it cannot start
(mmgl_tpu/cli.py:194-207); ``--profile_dir`` writes a ``torch.profiler``
Chrome trace of the first epoch's first updates (mmgl_tpu/cli.py:384-385,
478-480). Both print the parameter table before the totals.

``--device cuda`` on a host without a visible GPU fails: there is no CPU
fallback. Pass ``--device cpu`` to run the plain versions of the kernels.

Several ranks (parallel/, mmgl_tpu/cli.py:170-176, 224-237): one process a
rank, each started with ``--distributed true --coordinator_address
host:port --num_processes N --process_id r`` (or under torchrun, whose
environment fills the flags left out), on ``cuda:<local rank>``, over NCCL
(gloo with ``--device cpu``).
``--mesh_shape d,m`` lays the ranks out as d data-parallel rows of m
tensor-parallel ranks (default: all data-parallel); ``--zero1`` shards the
optimizer's state over the data rows, ``--fsdp`` the parameters too. Each
data row loads its shard of the global batch of
``per_device_*_batch_size`` x d; the test pass gathers predictions and
labels over the data group; rank 0 logs, writes the checkpoints and runs
wandb, and every rank returns the same metrics.

    python -m mmgl_tpu_torch.cli --model_name_or_path opt-125m \
        --context all --neighbor_mode embedding --position_type laplacian \
        --peft_type prefix --mesh_shape 2,2 --distributed true \
        --coordinator_address 127.0.0.1:29500 --num_processes 4 \
        --process_id <r>
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mmgl_tpu_torch.config import Arguments, parse_args
from mmgl_tpu_torch.metrics import Cider, bleu_score, rouge_score
from mmgl_tpu_torch.utils.meters import (AverageMeter, ProgressMeter,
                                         get_params_count_str)
from mmgl_tpu_torch.utils.tokenizer import get_tokenizer
from mmgl_tpu_torch.data.assemble import AssemblerConfig, WikiWeb2MAssembler
from mmgl_tpu_torch.data.loader import PrefetchLoader
from mmgl_tpu_torch.data.synthetic import make_synthetic_corpus
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.parallel.collectives import broadcast_object
from mmgl_tpu_torch.parallel.mesh import (Mesh, apply_fsdp, default_backend,
                                          gather_tokens, init_distributed,
                                          local_device, make_mesh,
                                          param_specs)
from mmgl_tpu_torch.parallel.tensor_parallel import shard_model
from mmgl_tpu_torch.peft.masks import count_params
from mmgl_tpu_torch.train.checkpoints import (merge_restored_params,
                                              restore_checkpoint,
                                              restore_training_state,
                                              save_checkpoint)
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import make_eval_step, make_train_step

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
    """``--device`` is read here; every other flag goes to the
    flag parser (the copy of mmgl_tpu/config.py) unchanged."""
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


def setup_mesh(args: Arguments, device: torch.device
               ) -> Tuple[Mesh, torch.device]:
    """(the mesh, this rank's device). ``--distributed`` first joins the
    process group (``init_distributed``: NCCL on cuda, gloo on cpu), then
    ``--mesh_shape`` lays the world's ranks out; a mesh larger than the
    world raises ValueError, as the JAX package's ``make_mesh``."""
    check_device(device)
    if args.distributed:
        _, rank = init_distributed(args.coordinator_address,
                                   args.num_processes, args.process_id,
                                   default_backend(device))
        device = local_device(device, rank)
    return make_mesh(args.mesh_shape, args.mesh_axes, device.type), device


@dataclass
class EvalSetup:
    """What an eval pass runs: the model and the functions over it."""
    model: torch.nn.Module
    fcfg: object
    tokenizer: object
    loader: PrefetchLoader
    eval_step: Callable[[Dict], Dict]
    generate_fn: Callable[[Dict], torch.Tensor]
    mesh: Mesh


def _build(args: Arguments, device: torch.device,
           mesh: Optional[Mesh] = None):
    """(tokenizer, seeded model cut to this rank's share, its config,
    (train, val, test) data). Every rank builds the whole model from the
    seed, then keeps its tensor-parallel share (parallel/
    tensor_parallel.py) and, under ``--fsdp``, shards it over the data
    group."""
    check_device(device)
    mesh = mesh or Mesh()
    tokenizer = get_tokenizer(args.tokenizer_path)
    name = args.model_name_or_path or "opt-tiny"
    args.decoder_only = "t5" not in name
    model, fcfg = build_model(args, device, vocab_size=tokenizer.vocab_size,
                              tokenizer=tokenizer)
    specs = param_specs(model, mesh.as_dict(), fsdp=True) if args.fsdp \
        else None
    shard_model(model, mesh)
    if args.fsdp:
        apply_fsdp(model, mesh, specs)
    return tokenizer, model, fcfg, setup_data(args, tokenizer)


def _loader(args: Arguments, dataset, batch_size: int, mesh: Mesh,
            **kw) -> PrefetchLoader:
    """The rank's loader: its data row's shard of ``dataset``."""
    return PrefetchLoader(dataset, batch_size=batch_size,
                          prefetch=args.prefetch_batches,
                          num_workers=args.dataloader_num_workers,
                          shard_id=mesh.data_index, num_shards=mesh.n_data,
                          **kw)


def _eval_setup(args: Arguments, model, fcfg, tokenizer, dataset,
                mesh: Mesh) -> EvalSetup:
    loader = _loader(args, dataset, args.per_device_val_batch_size, mesh)
    eval_step = make_eval_step(model, args.decoder_only,
                               args.max_input_length, tokenizer.pad_token_id,
                               mesh=mesh)
    generate_fn = partial(greedy_generate, model,
                          max_new_tokens=MAX_NEW_TOKENS)
    return EvalSetup(model, fcfg, tokenizer, loader, eval_step, generate_fn,
                     mesh)


def cache_neighbors(args: Arguments, model, datasets, splits,
                    mesh: Optional[Mesh] = None):
    """The datasets wrapped in the neighbour cache where
    ``--cache_neighbor_embeddings`` asks for it and a frozen tower runs:
    the embedding mode, or the raw mode's images (section_all, all), as the
    JAX package applies it (mmgl_tpu/cli.py:259-270); else as given."""
    if not (args.cache_neighbor_embeddings
            and (args.neighbor_mode == "embedding"
                 or args.context in ("section_all", "all"))):
        return tuple(datasets)
    from mmgl_tpu_torch.data.neighbor_cache import CachedNeighborDataset

    print("[neighbor-cache] precomputing frozen tower outputs ...")
    group = (torch.distributed.group.WORLD
             if mesh is not None and mesh.shape != (1, 1) else None)
    return tuple(CachedNeighborDataset(
        ds, model, cache_dir=args.neighbor_cache_dir, split=split,
        num_workers=args.dataloader_num_workers, group=group)
        for ds, split in zip(datasets, splits))


def prepare(args: Arguments, device: torch.device,
            mesh: Optional[Mesh] = None) -> EvalSetup:
    """Tokenizer, seeded model, test loader (its neighbours cached under
    ``--cache_neighbor_embeddings``), eval step and generator."""
    mesh = mesh or Mesh()
    tokenizer, model, fcfg, (_, _, test_ds) = _build(args, device, mesh)
    test_ds, = cache_neighbors(args, model, (test_ds,), ("test",), mesh)
    print(f"Testing with {len(test_ds)} examples.")
    return _eval_setup(args, model, fcfg, tokenizer, test_ds, mesh)


def start_wandb(args: Arguments, is_main: bool = True):
    """The wandb run of ``--log_to_wandb`` (rank 0's only), or None:
    ``wandb.init(project, name)`` and the flags in its config, or
    ``[wandb] disabled: <error>`` where wandb cannot start
    (mmgl_tpu/cli.py:194-207)."""
    if not (args.log_to_wandb and is_main):
        return None
    try:
        import wandb

        wandb_run = wandb.init(project=args.wandb_project,
                               name=args.wandb_run)
        wandb_run.config.update(vars(args), allow_val_change=True)
        return wandb_run
    except Exception as e:  # offline hosts, or wandb not installed
        print(f"[wandb] disabled: {e}")
        return None


Log = Callable[[Dict[str, float], int], None]
# evaluate_loop's per-batch timings, which the JAX package does not log:
# they go to the caller's log function only, never to wandb
_TIMINGS = ("/batch_seconds", "/batch_sections")


def make_log(wandb_run, log_fn: Optional[Log]) -> Log:
    """log(scalars, step): to the caller's ``log_fn``, and all but the
    batch timings to the wandb run (``log(scalars, step=step)``)."""
    def log(scalars: Dict[str, float], step: int) -> None:
        logged = {k: x for k, x in scalars.items()
                  if not k.endswith(_TIMINGS)}
        if wandb_run is not None and logged:
            wandb_run.log(logged, step=step)
        if log_fn is not None:
            log_fn(scalars, step)
    return log


def report_params(model, wandb_run, is_main: bool = True) -> None:
    """The parameter table (rank 0's), then the totals (mmgl_tpu/cli.py:
    244-254; of this rank's shares on a mesh), into the wandb run's config
    too."""
    if is_main:
        print(get_params_count_str(model))
    counts = count_params(model)
    print(f"Total params: {counts['total']:,} | trainable: "
          f"{counts['trainable']:,} | non-trainable: "
          f"{counts['non_trainable']:,}")
    if wandb_run is not None:
        wandb_run.config.update({"total_params": counts["total"],
                                 "trainable_params": counts["trainable"],
                                 "non_trainable_params":
                                 counts["non_trainable"]},
                                allow_val_change=True)


def run(args: Arguments, device: torch.device,
        log_fn: Optional[Log] = None) -> Dict[str, float]:
    """Training, or with ``--test true`` the test pass alone; returns
    evaluate_loop's metrics (plus ``train_updates`` after training).
    ``log_fn(scalars, step)`` gets every scalar the wandb run gets, and the
    batch timings (rank 0's). The process group ``--distributed`` joins is
    left at the end."""
    mesh, device = setup_mesh(args, device)
    try:
        if not args.test:
            return run_training(args, device, log_fn, mesh)
        return run_test(args, device, log_fn, mesh)
    finally:
        if args.distributed and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_test(args: Arguments, device: torch.device, log_fn: Optional[Log],
             mesh: Mesh) -> Dict[str, float]:
    """The test pass alone (``--test true``), on ``--resume``'s checkpoint
    where there is one."""
    wandb_run = start_wandb(args, mesh.is_main)
    test = prepare(args, device, mesh)
    report_params(test.model, wandb_run, mesh.is_main)
    if args.resume:
        restored, path = _newest_checkpoint(args)
        if restored is not None:
            print(f"=> loaded checkpoint '{path}' (epoch {restored['epoch']})")
            merge_restored_params(test.model, restored["params"], mesh)
    results = evaluate_loop(test, args, args.start_epoch,
                            make_log(wandb_run, log_fn if mesh.is_main
                                     else None), prefix="test")
    if wandb_run is not None:
        wandb_run.finish()
    return results


def main(argv=None) -> Dict[str, float]:
    args, device = parse_cli(argv)
    return run(args, device)


def _new_log_dir(args: Arguments, mesh: Mesh) -> str:
    """{log_dir}/{wandb_run}_{i} for the first i not taken
    (run_generation.py:238-244), made by rank 0; every rank gets its
    path."""
    path = None
    if mesh.is_main:
        i = 0
        while os.path.exists(os.path.join(args.log_dir,
                                          f"{args.wandb_run}_{i}")):
            i += 1
        path = os.path.join(args.log_dir, f"{args.wandb_run}_{i}")
        os.makedirs(path)
    return broadcast_object(path)


def _newest_checkpoint(args: Arguments):
    """(checkpoint, path) of ``--resume``: the newer by epoch of its best
    checkpoint and its ``_latest`` one; (None, path) if neither exists."""
    path = os.path.join(args.log_dir, args.resume, "ckpt")
    restored = restore_checkpoint(path)
    latest = restore_checkpoint(path + "_latest")
    if latest is not None and (restored is None
                               or latest["epoch"] > restored["epoch"]):
        return latest, path + "_latest"
    return restored, path


def dropout_generator(seed: int, epoch: int, device: torch.device,
                      data_index: int = 0) -> torch.Generator:
    """The epoch's dropout stream, a function of (seed, epoch) only: a
    resumed run draws the masks the uninterrupted run drew (the counterpart
    of ``fold_in(dropout_stream_key(seed), epoch)``). A mesh's data row
    ``data_index`` > 0 draws its own, and the tensor-parallel ranks of one
    row the same."""
    entropy = [seed, epoch] + ([data_index] if data_index else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def start_profile(device: torch.device):
    """A started ``torch.profiler`` run: the host's activity, and the card's
    on CUDA."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, device: torch.device, profile_dir: str,
                 epoch: int) -> str:
    """Stop ``prof`` once the device has run what was queued, and write its
    Chrome trace under ``profile_dir``; returns the trace's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"train_epoch{epoch}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace of epoch {epoch}'s first updates: {path}")
    return path


def _train_batches(loader: PrefetchLoader, epoch: int) -> Iterator[Dict]:
    """The epoch's batches without end: each further pass over the data is
    reshuffled deterministically by (epoch, pass)."""
    data_pass = 0
    while True:
        loader.set_epoch(epoch, data_pass)
        n = 0
        for batch in loader:
            n += 1
            yield batch
        if n == 0:
            raise RuntimeError(
                f"train loader produced no batches: {len(loader.dataset)} "
                f"examples for a batch of {loader.batch_size} (drop_last)")
        data_pass += 1


def run_training(args: Arguments, device: torch.device,
                 log_fn: Optional[Log] = None,
                 mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Counterpart of mmgl_tpu.cli.run_training (run_generation.py:236-428
    in the reference), on this rank of ``mesh`` (``setup_mesh``'s; by
    default laid out here, without joining a process group). Returns the
    final test pass's metrics plus ``train_updates``."""
    if mesh is None:
        mesh, device = setup_mesh(args, device)
    seed = args.seed or 0
    if args.seed is not None:
        np.random.seed(args.seed)
    log_dir = _new_log_dir(args, mesh)
    if args.save_dir is None:
        args.save_dir = os.path.join(log_dir, "ckpt")
    wandb_run = start_wandb(args, mesh.is_main)
    log = make_log(wandb_run, log_fn if mesh.is_main else None)

    tokenizer, model, fcfg, datasets = _build(args, device, mesh)
    train_ds, val_ds, test_ds = cache_neighbors(args, model, datasets,
                                                ("train", "val", "test"),
                                                mesh)
    print(f"Training with {len(train_ds)} examples, validating with "
          f"{len(val_ds)} examples, testing with {len(test_ds)} examples.")
    report_params(model, wandb_run, mesh.is_main)

    optimizer, scheduler = build_optimizer(args, model, mesh)
    best_acc1, step = 0.0, 0
    if args.resume:
        restored, path = _newest_checkpoint(args)
        if restored is not None:
            print(f"=> loaded checkpoint '{path}' (epoch {restored['epoch']})")
            # epoch E was complete when saved: replay from E + 1
            # (DIVERGENCES.md, "Resume replays the NEXT epoch")
            args.start_epoch = restored["epoch"] + 1
            best_acc1, step = restored["best_acc1"], restored["step"]
            restore_training_state(restored, model, optimizer, scheduler,
                                   mesh)
        else:
            print(f"=> no checkpoint found at '{path}'")

    accum = max(1, args.grad_accumulation_steps)
    batch_size = args.per_device_train_batch_size
    train_step = make_train_step(
        model, optimizer, scheduler, args.decoder_only,
        args.max_input_length, tokenizer.pad_token_id,
        grad_accumulation_steps=accum, grad_clip=args.grad_clip,
        fused_ce=args.fused_ce,
        chunked_ce=args.chunked_ce if args.decoder_only else 0, mesh=mesh)
    val = _eval_setup(args, model, fcfg, tokenizer, val_ds, mesh)
    test = _eval_setup(args, model, fcfg, tokenizer, test_ds, mesh)
    train_loader = _loader(args, train_ds, batch_size * accum, mesh,
                           shuffle=True, seed=seed)

    train_updates = 0
    global_bs = batch_size * mesh.n_data
    updates_per_epoch = max(1, args.steps_per_epoch // accum)
    for epoch in range(args.start_epoch, args.epochs):
        epoch_start = time.time()
        if epoch == 0:
            evaluate_loop(val, args, epoch - 1, log)

        generator = dropout_generator(seed, epoch, device, mesh.data_index)
        batches = _train_batches(train_loader, epoch)
        batch_time = AverageMeter("Time", ":6.3f")
        data_time = AverageMeter("Data", ":6.3f")
        losses = AverageMeter("Loss", ":.4e")
        progress = ProgressMeter(updates_per_epoch, [batch_time, losses],
                                 prefix=f"Epoch: [{epoch}]")
        end = time.time()
        # the first epoch's trace: from here through update
        # min(3, updates_per_epoch - 1) (mmgl_tpu/cli.py:384-385, 478-480)
        prof = (start_profile(device)
                if args.profile_dir and epoch == args.start_epoch else None)
        for u in range(updates_per_epoch):
            batch = next(batches)
            data_time.update(time.time() - end)
            metrics = train_step(batch, generator)
            step += 1
            train_updates += 1
            batch_time.update(time.time() - end)
            end = time.time()
            if prof is not None and u == min(3, updates_per_epoch - 1):
                stop_profile(prof, device, args.profile_dir, epoch)
                prof = None

            actual_step = epoch * updates_per_epoch + u + 1
            if actual_step == 1 or actual_step % args.print_freq == 0:
                # the loss is read only here: a read waits for the device
                losses.update(float(metrics["summary_loss"]), global_bs)
                if mesh.is_main:
                    progress.display(u + 1)
                log({"train/loss": losses.avg,
                     "metrics/total_secs_per_batch": batch_time.avg,
                     "metrics/data_secs_per_batch": data_time.avg,
                     "metrics/examples_per_sec":
                         global_bs * accum / max(batch_time.avg, 1e-9)},
                    actual_step)
                losses.reset()
                batch_time.reset()
                data_time.reset()
        batches.close()

        results = evaluate_loop(val, args, epoch, log)
        acc1 = results["bleu4"]
        if acc1 > best_acc1 or epoch == 0:
            # the decision is the same on every rank (the metrics come
            # from the gathered predictions); the save is a collective and
            # rank 0 writes
            best_acc1 = max(acc1, best_acc1)
            if mesh.is_main:
                print("=> save best val model ...", args.save_dir)
            save_checkpoint(args.save_dir, model, optimizer, scheduler, epoch,
                            acc1, step, mesh)
        if args.save_every_epochs and (
                (epoch + 1) % args.save_every_epochs == 0):
            # the periodic "latest" checkpoint for kill + resume, apart from
            # the best-val one the final test restores
            save_checkpoint(args.save_dir + "_latest", model, optimizer,
                            scheduler, epoch, best_acc1, step, mesh)
        print(f"Epoch {epoch} time: {time.time() - epoch_start}s")

    # final test on the best checkpoint (run_generation.py:421-428), read
    # by every rank once rank 0 has written it
    if mesh.shape != (1, 1):
        torch.distributed.barrier()
    restored = restore_checkpoint(args.save_dir)
    if restored is not None:
        merge_restored_params(model, restored["params"], mesh)
    results = evaluate_loop(test, args, args.epochs, log, prefix="test")
    results["train_updates"] = float(train_updates)
    if wandb_run is not None:
        wandb_run.finish()
    return results


def _score_corpus(all_preds: List[str], all_refs: List[List[str]]):
    """BLEU-1..4, ROUGE and CIDEr over the corpus, in this process (the JAX
    package farms them to processes only past 2048 pairs)."""
    bleus = [bleu_score(all_preds, all_refs, n_gram=n) for n in (1, 2, 3, 4)]
    rouges = rouge_score(all_preds, all_refs)
    cands = {i: [p] for i, p in enumerate(all_preds)}
    refs = {i: r for i, r in enumerate(all_refs)}
    cider = Cider().compute_score(refs, cands)[0]
    return bleus, rouges, cider


def evaluate_loop(test: EvalSetup, args: Arguments, epoch: int, log: Log,
                  prefix: str = "val") -> Dict[str, float]:
    """Counterpart of mmgl_tpu.cli.evaluate_loop (run_generation.py:527-703
    in the reference).

    Each batch's device work (eval step, then decode on the test pass) is
    timed to a device synchronize and logged as ``{prefix}/batch_seconds``
    with ``{prefix}/batch_sections`` (to the caller's log function only:
    the JAX package logs no such scalar to wandb); decoding to text and
    scoring run on the host after it. On a mesh each rank runs its data
    row's batches and the predictions and labels are gathered over the data
    group (``gather_tokens``: each sample once), so every rank scores the
    same corpus."""
    device = test.model.device
    mesh = test.mesh
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
        labels = batch["labels"]
        if test.fcfg.decoder_only:
            labels = labels[:, args.max_input_length + 1:]
        generated = gather_tokens(generated, mesh)
        labels = gather_tokens(labels, mesh)
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
