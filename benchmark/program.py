"""The system under test: the port's training loop, built as its CLI
builds it.

With the family adapters (``benchmark/adapters/``), the only code of the
benchmark that imports the program (``mmgl_tpu_torch``). It builds the
tokenizer and the model as ``cli._build`` does (``build_model``), has each
part's adapter overlay the benchmark's weights through the port's
importer (``utils/hf_import``) and the overlay the factory uses
(``factory._overlay``), hands the benchmark's corpus to the
port's assembler (``data/assemble.WikiWeb2MAssembler``) in place of
``cli.setup_data``'s, and builds the optimizer (``train/optim``), the
update (``train/steps.make_train_step``), the loader (``cli._loader``
over ``data/loader.PrefetchLoader``, its batches from
``cli._train_batches``) and the dropout stream
(``cli.dropout_generator``) as ``cli.run_training`` does. ``update``
runs one turn of that loop's body: the next batch, the update, and the
loss read at ``print_freq``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from mmgl_tpu_torch import cli
from mmgl_tpu_torch.config import parse_args
from mmgl_tpu_torch.data.assemble import AssemblerConfig, WikiWeb2MAssembler
from mmgl_tpu_torch.data.store import Page, PageStore
from mmgl_tpu_torch.models import factory
from mmgl_tpu_torch.parallel.mesh import Mesh
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import make_train_step
from mmgl_tpu_torch.utils.tokenizer import get_tokenizer

# the program's name for a flag that is not one of the CLI's
NOT_FLAGS = ("image_size",)


def flags(settings: Dict, seed: int) -> List[str]:
    out = []
    for key, value in settings.items():
        if key in NOT_FLAGS:
            continue
        out += [f"--{key}", str(value).lower() if isinstance(value, bool)
                else str(value)]
    return out + ["--seed", str(seed)]


def _numpy(group: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.float().cpu().numpy() for k, v in group.items()}


def set_path(tree: Dict, path: List[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def overlay(model, module: str, tree: Dict) -> int:
    """Copy a flax-layout tree into ``model.<module>`` through the
    factory's overlay; the tensors copied."""
    return factory._overlay(model, module, tree)


def overlay_linears(model, tensors: Dict[str, np.ndarray]) -> int:
    """Layers of the model outside the LM and the towers (the fusion
    block's), from tensors under their parameter names: a Linear's
    (out, in) weight as its flax (in, out) kernel."""
    trees: Dict[str, Dict] = {}
    for name, value in tensors.items():
        parts = name.split(".")
        if parts[-1] == "weight":
            set_path(trees.setdefault(parts[0], {}),
                     parts[1:-1] + ["kernel"], value.T)
        else:
            set_path(trees.setdefault(parts[0], {}), parts[1:], value)
    return sum(overlay(model, module, tree) for module, tree in trees.items())


def adapter(part: Dict):
    from benchmark import work

    return work.load("adapters", part["family"])


class Program:
    """One training run of the port: model, optimizer, update, loader,
    dropout stream, and the loop's update count."""

    def __init__(self, cfg: Dict, settings: Dict, seed: int,
                 device: torch.device, corpus, weights: Dict):
        self.args = args = parse_args(flags(settings, seed))
        self.device = device
        mesh = Mesh()
        # cli._build, without cli.setup_data's corpus
        cli.check_device(device)
        tokenizer = get_tokenizer(args.tokenizer_path)
        args.decoder_only = "t5" not in args.model_name_or_path
        model, _ = factory.build_model(args, device,
                                       vocab_size=tokenizer.vocab_size,
                                       tokenizer=tokenizer)
        self.model = model
        self._load(cfg, weights)

        pages, ids, images = corpus
        store = PageStore([Page(**p) for p in pages])

        def provider(page_id, section_id, page):
            got = images.get((page_id, section_id))
            return (None, None) if got is None else (got[0],
                                                     page.image_caption[
                                                         section_id][0])

        acfg = AssemblerConfig.from_args(args)
        acfg.image_size = settings["image_size"]
        dataset = WikiWeb2MAssembler(acfg, store, ids, tokenizer, provider)

        # cli.run_training
        self.optimizer, scheduler = build_optimizer(args, model, mesh)
        accum = max(1, args.grad_accumulation_steps)
        self.train_step = make_train_step(
            model, self.optimizer, scheduler, args.decoder_only,
            args.max_input_length, tokenizer.pad_token_id,
            grad_accumulation_steps=accum, grad_clip=args.grad_clip,
            fused_ce=args.fused_ce,
            chunked_ce=args.chunked_ce if args.decoder_only else 0,
            mesh=mesh)
        self.loader = cli._loader(args, dataset,
                                  args.per_device_train_batch_size * accum,
                                  mesh, shuffle=True, seed=seed)
        self.batches = cli._train_batches(self.loader, 0)
        self.generator = cli.dropout_generator(seed, 0, device,
                                               mesh.data_index)
        self.steps = 0

    @torch.no_grad()
    def _load(self, cfg: Dict, weights: Dict) -> None:
        """Every parameter of the model from ``weights``, each part's
        through its family's adapter."""
        copied = sum(adapter(part).load(
            self.model, part, _numpy(weights[(part["part"], "hf")]),
            _numpy(weights[(part["part"], "extra")]))
            for part in cfg["parts"])
        total = len(list(self.model.parameters()))
        if copied != total:
            raise RuntimeError(f"the weights set {copied} of the model's "
                               f"{total} parameters")

    def trainable(self) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def update(self, mark=None) -> Tuple[Dict, Dict, float, float]:
        """(batch, the update's metrics, seconds waiting for the batch,
        the calling thread's CPU seconds in the update and its loss read).
        ``mark(phase)``, where given, is called as the loop changes
        phase."""
        mark = mark or (lambda phase: None)
        mark("waiting for the loader")
        start = time.perf_counter()
        batch = next(self.batches)
        waited = time.perf_counter() - start
        mark("launching the update")
        cpu = time.thread_time()
        metrics = self.train_step(batch, self.generator)
        self.steps += 1
        if self.steps == 1 or self.steps % self.args.print_freq == 0:
            mark("reading the loss")
            float(metrics["summary_loss"])
        cpu = time.thread_time() - cpu
        mark("between updates")
        return batch, metrics, waited, cpu

    def pooled_into(self, part: Dict) -> torch.nn.Module:
        """The module whose input is a tower's pooled output."""
        return getattr(self.model, adapter(part).POOLED_INTO)

    def close(self) -> None:
        self.batches.close()


def launches(wrappers) -> Dict[str, int]:
    """The launch counters of the port's attention wrappers named."""
    from mmgl_tpu_torch.ops import flash_attention as fa

    return {n: int(getattr(fa, n).launches) for n in wrappers}
