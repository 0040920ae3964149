"""Checkpoints (counterpart of mmgl_tpu/train/checkpoints.py:35-56, 199-206).

A checkpoint is a directory (``{log_dir}/{run}/ckpt``, and ``ckpt_latest``
for ``--save_every_epochs``) holding one ``torch.save`` file: ``epoch``,
``best_acc1``, ``step``, the parameters without the frozen towers
(``visual_model``, ``text_model``: reloadable from their pretrained
checkpoints, as the reference's key filter drops them), the optimizer
(AdamW's moments, or Adafactor's step count and factored second moments)
and scheduler states, and the torch CPU and CUDA generator states. The file is
written to a temporary name and renamed, so a killed save leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from mmgl_tpu_torch.peft.masks import TOWERS

FILE = "checkpoint.pt"


def _strip_towers(state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state_dict.items()
            if k.split(".", 1)[0] not in TOWERS}


def save_checkpoint(path: str, model, optimizer, scheduler, epoch: int,
                    best_acc1: float, step: int) -> str:
    """Write the checkpoint under directory ``path``; returns the file."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "best_acc1": float(best_acc1),
        "step": int(step),
        "params": {k: v.detach().cpu()
                   for k, v in _strip_towers(model.state_dict()).items()},
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "rng": {"cpu": torch.get_rng_state(),
                "cuda": (torch.cuda.get_rng_state_all()
                         if torch.cuda.is_available() else [])},
    }
    out = os.path.join(path, FILE)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    return out


def restore_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint under directory ``path``, or None if there is none."""
    file = os.path.join(path, FILE)
    if not os.path.exists(file):
        return None
    return torch.load(file, map_location="cpu", weights_only=True)


def merge_restored_params(model, params: Dict[str, torch.Tensor]) -> None:
    """Overlay restored (tower-stripped) parameters onto the live model;
    the towers keep their fresh weights. Raises on any other mismatch."""
    missing, unexpected = model.load_state_dict(params, strict=False)
    missing = [k for k in missing if k.split(".", 1)[0] not in TOWERS]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not match the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")


def restore_training_state(ckpt: Dict[str, Any], model, optimizer,
                           scheduler) -> None:
    """Parameters, optimizer, scheduler and generator states of a resume."""
    merge_restored_params(model, ckpt["params"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    torch.set_rng_state(ckpt["rng"]["cpu"])
    if ckpt["rng"]["cuda"] and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(ckpt["rng"]["cuda"])
