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

On a mesh (``mesh``, parallel/mesh.py; mmgl_tpu/train/checkpoints.py:32-81)
the whole state is gathered (each tensor-parallel share over the model
group, each FSDP share over the data group, a ZeRO-1 optimizer's state to
its first data rank) and rank 0 writes it in the one-device format above,
so one checkpoint restores on any mesh; on restore every rank takes its
share. Saving is a collective: every rank calls it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from mmgl_tpu_torch.parallel.mesh import full_tensor
from mmgl_tpu_torch.peft.masks import TOWERS

FILE = "checkpoint.pt"


def _strip_towers(state_dict: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state_dict.items()
            if k.split(".", 1)[0] not in TOWERS}


def _meshed(mesh) -> bool:
    return mesh is not None and mesh.shape != (1, 1)


def _state_dims(model: nn.Module, optimizer, mesh) -> Dict[int, Dict]:
    """{optimizer index: {state key: the dim its tensor-parallel shares are
    cut on, or None}}: AdamW's moments as their parameter; Adafactor's as
    ``Adafactor.state_shard_dims`` gives them (train/optim.py)."""
    from mmgl_tpu_torch.train.optim import (Adafactor, flax_transposed,
                                            tp_shards)

    shards = tp_shards(model, mesh)
    flipped = {id(w) for w in flax_transposed(model)}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out = {}
    for i, p in enumerate(params):
        if id(p) not in shards:
            out[i] = {}
            continue
        tdim, full, _ = shards[id(p)]
        out[i] = {"exp_avg": tdim, "exp_avg_sq": tdim,
                  **Adafactor.state_shard_dims(tdim, full,
                                               id(p) in flipped)}
    return out


def _whole_optimizer(model: nn.Module, optimizer, mesh) -> Optional[Dict]:
    """The optimizer's one-device state dict, gathered; None on the ranks
    that do not hold it (a ZeRO-1 state lives on each row's first data
    rank)."""
    if hasattr(optimizer, "consolidate_state_dict"):
        optimizer.consolidate_state_dict(to=0)   # the group's rank 0
        if mesh.data_index != 0:
            return None
    sd = optimizer.state_dict()
    dims = _state_dims(model, optimizer, mesh)
    state = {}
    for i, entry in sorted(sd["state"].items()):
        state[i] = {k: (full_tensor(v, dims[i].get(k), mesh).cpu()
                        if torch.is_tensor(v) and v.dim() > 0 else v)
                    for k, v in entry.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def _whole_params(model: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    layout = getattr(model, "tp_layout", {})
    return {k: full_tensor(v, layout.get(k), mesh).cpu()
            for k, v in _strip_towers(model.state_dict()).items()}


def save_checkpoint(path: str, model, optimizer, scheduler, epoch: int,
                    best_acc1: float, step: int, mesh=None) -> str:
    """Write the checkpoint under directory ``path``; returns the file. On
    a mesh every rank calls it and rank 0 writes."""
    out = os.path.join(path, FILE)
    if _meshed(mesh):
        params = _whole_params(model, mesh)
        opt_state = _whole_optimizer(model, optimizer, mesh)
        if not mesh.is_main:
            return out
    else:
        params = {k: v.detach().cpu()
                  for k, v in _strip_towers(model.state_dict()).items()}
        opt_state = optimizer.state_dict()
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "best_acc1": float(best_acc1),
        "step": int(step),
        "params": params,
        "optimizer": opt_state,
        "scheduler": scheduler.state_dict(),
        "rng": {"cpu": torch.get_rng_state(),
                "cuda": (torch.cuda.get_rng_state_all()
                         if torch.cuda.is_available() else [])},
    }
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


def _share(t: torch.Tensor, like: torch.Tensor, dim: Optional[int], mesh
           ) -> torch.Tensor:
    """This rank's share of the whole tensor ``t``, as the live ``like``
    holds it: its model index's slice along ``dim``, then its FSDP share
    (a DTensor like ``like``; None: none)."""
    if dim is not None:
        n = t.shape[dim] // mesh.n_model
        t = t.narrow(dim, mesh.model_index * n, n)
    if like is not None and hasattr(like, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(like.device, like.dtype),
                                 like.device_mesh, like.placements,
                                 src_data_rank=None)
    return t


def merge_restored_params(model, params: Dict[str, torch.Tensor],
                          mesh=None) -> None:
    """Overlay restored (tower-stripped) parameters onto the live model;
    the towers keep their fresh weights. Raises on any other mismatch. On
    a mesh each rank takes its share of each whole tensor."""
    if _meshed(mesh):
        from mmgl_tpu_torch.models.layers import invalidate_kept_casts

        layout = getattr(model, "tp_layout", {})
        live = model.state_dict()
        # a key the live model lacks passes through whole, so that
        # load_state_dict reports it as unexpected
        params = {k: (_share(v, live[k], layout.get(k), mesh) if k in live
                      else v) for k, v in params.items()}
        invalidate_kept_casts()
    missing, unexpected = model.load_state_dict(params, strict=False)
    missing = [k for k in missing if k.split(".", 1)[0] not in TOWERS]
    if missing or unexpected:
        raise KeyError(f"checkpoint does not match the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")


def _optimizer_share(model, optimizer, sd: Dict, mesh) -> Dict:
    """The one-device optimizer state cut to this rank's tensor-parallel
    (and FSDP) shares."""
    dims = _state_dims(model, optimizer, mesh)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for i, entry in sd["state"].items():
        p = params[int(i)]
        # AdamW's moments are FSDP shares like their parameter; Adafactor
        # keeps whole ones (train/optim.py)
        state[i] = {k: (_share(v, p if k.startswith("exp_avg") else None,
                               dims[int(i)].get(k), mesh)
                        if torch.is_tensor(v) and v.dim() > 0 else v)
                    for k, v in entry.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def restore_training_state(ckpt: Dict[str, Any], model, optimizer,
                           scheduler, mesh=None) -> None:
    """Parameters, optimizer, scheduler and generator states of a resume;
    on a mesh each rank takes its shares."""
    merge_restored_params(model, ckpt["params"], mesh)
    opt_state = ckpt["optimizer"]
    if _meshed(mesh):
        opt_state = _optimizer_share(model, optimizer, opt_state, mesh)
    optimizer.load_state_dict(opt_state)
    scheduler.load_state_dict(ckpt["scheduler"])
    torch.set_rng_state(ckpt["rng"]["cpu"])
    if ckpt["rng"]["cuda"] and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(ckpt["rng"]["cuda"])
