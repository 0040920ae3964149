"""The work an update asks for, counted from its batch: the attention
launches with the (query, key) pairs their masks leave, and the model
FLOPs. Every piece is found by name in a file of its own: a model
family's weights, FLOPs and launches under ``benchmark/families/``, a
kernel's FLOPs, bytes and wrappers under ``benchmark/kernels/``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

ROOT = Path(__file__).resolve().parent
_LOADED: Dict[Path, object] = {}


def load(folder: str, name: str):
    """The module ``benchmark/<folder>/<name>.py``, loaded once."""
    path = ROOT / folder / f"{name}.py"
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            "benchmark." + ".".join(folder.split("/"))
            + "." + name.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def kernels() -> List[str]:
    """The names of the kernel files."""
    return sorted(p.stem for p in (ROOT / "kernels").glob("*.py"))


def peaks(card: str) -> Dict[str, float]:
    """The published peaks of ``card`` (benchmark/peaks.json), or {}."""
    table = json.loads((ROOT / "peaks.json").read_text())
    return next((v for k, v in table.items() if k in card), {})


def allowed_pairs(mask: np.ndarray, causal: bool,
                  valid_queries: bool = False) -> float:
    """The (query, key) pairs a head's logits keep under the key mask
    (N, S) of self-attention, summed over the N sequences; a query row
    with no key left needs all S (its probabilities are uniform). With
    ``valid_queries`` only the rows of valid queries count (what a model
    needs; a kernel computes every row)."""
    mask = np.asarray(mask).astype(bool)
    n, s = mask.shape
    if causal:
        # keys j <= i that are valid: the running count of valid keys
        per_row = np.cumsum(mask, axis=1)
    else:
        per_row = np.repeat(mask.sum(axis=1, keepdims=True), s, axis=1)
    per_row = np.where(per_row == 0, s, per_row)
    if valid_queries:
        per_row = np.where(mask, per_row, 0)
    return float(per_row.sum())


def micro_batches(batch: Dict, accum: int) -> Iterator[Dict]:
    n = next(iter(batch.values())).shape[0]
    m = n // accum
    for i in range(accum):
        yield {k: v[i * m:(i + 1) * m] for k, v in batch.items()}


def launches(cfg: Dict, settings: Dict, batch: Dict) -> List[Dict]:
    """One entry a kernel launch of an update, from each part's family:
    its kernel file's name, the sequences, query and key lengths, heads,
    head dim and allowed pairs a head."""
    out = []
    for mb in micro_batches(batch, settings["grad_accumulation_steps"]):
        for part in cfg["parts"]:
            out += load("families", part["family"]).launches(
                part, cfg, settings, mb)
    return out


def bound_s(launch: Dict, peak: Dict[str, float]) -> float:
    """The least time of one launch: its FLOPs at the peak rate or its
    bytes at the peak bandwidth, whichever is longer."""
    k = load("kernels", launch["kernel"])
    args = {key: launch[key] for key in ("n", "sq", "sk", "heads",
                                         "head_dim", "pairs")}
    return max(k.flops(**args) / peak["flops"], k.nbytes(**args)
               / peak["bytes_per_s"])


def update_flops(cfg: Dict, settings: Dict, batch: Dict) -> float:
    """Model FLOPs of one update: what the forward and backward need over
    the valid tokens, nothing recomputed."""
    total = 0.0
    for mb in micro_batches(batch, settings["grad_accumulation_steps"]):
        for part in cfg["parts"]:
            total += load("families", part["family"]).flops(
                part, cfg, settings, mb)
    return total
