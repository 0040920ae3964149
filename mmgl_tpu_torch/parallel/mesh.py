"""The device mesh over ``torch.distributed`` (counterpart of
mmgl_tpu/parallel/mesh.py).

One process drives one rank. The ranks form a 2-D ``("data", "model")``
grid (``init_device_mesh``, the JAX package's ``devices.reshape(shape)``:
rank = data index x m + model index), with one process group per axis:

  * the batch shards over ``data`` (the loader takes the rank's data index
    as its shard), and the gradients are averaged over the data group;
  * megatron-style tensor parallelism over ``model``: the JAX package's
    rule table (``_TP_RULES``, kept with the flax paths as keys) picks the
    column-parallel (q/k/v, fc1, LoRA's B), row-parallel (out_proj, fc2)
    and vocab-sharded (the token tables) weights, and
    parallel/tensor_parallel.py slices them;
  * ``--zero1``: the optimizer's moments sharded over ``data``
    (``apply_zero1``, torch's ``ZeroRedundancyOptimizer``: each data rank
    owns whole tensors' moments and broadcasts their update, where XLA
    shards each moment along a dim);
  * ``--fsdp``: the parameters too (``apply_fsdp``, ``fully_shard`` over
    the data sub-mesh, each leaf on the dim ``param_specs`` gives it).

``init_distributed`` is ``init_process_group`` over
``tcp://<coordinator_address>`` with ``num_processes`` ranks, or from
torchrun's environment where those flags are None.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mmgl_tpu_torch.parallel.collectives import all_gather_cat, group_size

Spec = Tuple[Optional[str], ...]

# (flax path regex, the spec as a function of the model-axis name): the JAX
# package's table (mmgl_tpu/parallel/mesh.py:26-44), specs over the flax
# leaf's dims (a Dense kernel is (in, out))
_TP_RULES = [
    # attention projections (LoRADense nests kernels under /dense/)
    (r"(q_proj|k_proj|v_proj|query|key|value)(/dense)?/kernel$",
     lambda m: (None, m)),
    (r"(q_proj|k_proj|v_proj|query|key|value)(/dense)?/bias$",
     lambda m: (m,)),
    (r"(out_proj|out|o)/kernel$", lambda m: (m, None)),
    # FFN
    (r"(fc1|intermediate|wi|wi_0|wi_1|q|k|v)/kernel$", lambda m: (None, m)),
    (r"(fc1|intermediate|wi|wi_0|wi_1)/bias$", lambda m: (m,)),
    (r"(fc2|output|wo)/kernel$", lambda m: (m, None)),
    # embeddings: vocab-sharded
    (r"embed_tokens/embedding$", lambda m: (m, None)),
    (r"shared/embedding$", lambda m: (m, None)),
    (r"lm_head/kernel$", lambda m: (None, m)),
    # LoRA adapters: B column-parallel to match the base projection
    (r"lora_a$", lambda m: (None, None)),
    (r"lora_b$", lambda m: (None, m)),
]

FSDP_MIN_SIZE = 1024


def _spec_for(path: str, model_axis: str) -> Spec:
    for pattern, make_spec in _TP_RULES:
        if re.search(pattern, path):
            return make_spec(model_axis)
    return ()


def leaf_spec(path: str, shape: Tuple[int, ...], mesh_shape: Dict[str, int],
              fsdp: bool = False, model_axis: str = "model",
              data_axis: str = "data",
              fsdp_min_size: int = FSDP_MIN_SIZE) -> Spec:
    """The spec ``param_shardings`` gives the flax leaf ``path`` of
    ``shape`` (mmgl_tpu/parallel/mesh.py:65-111): the rule's, dropped where
    a sharded dim does not divide evenly, then under ``fsdp`` the data axis
    on the first free, evenly divisible dim of a leaf of at least
    ``fsdp_min_size`` elements."""
    tp = mesh_shape.get(model_axis, 1) > 1
    n_data = mesh_shape.get(data_axis, 1)
    ndim = len(shape)
    spec = _spec_for(path, model_axis) if tp else ()
    if tp and any(s is not None for s in spec):
        for dim, axis_name in enumerate(spec):
            if axis_name is None:
                continue
            if dim >= ndim or shape[dim] % mesh_shape[axis_name]:
                spec = ()
                break
    if fsdp and n_data > 1 and math.prod(shape) >= fsdp_min_size:
        dims = list(spec) + [None] * (ndim - len(spec))
        for dim in range(ndim):
            if dims[dim] is None and shape[dim] % n_data == 0:
                dims[dim] = data_axis
                spec = tuple(dims)
                break
    return tuple(spec)


# leaves that keep their flax name (utils/convert.py ``_KEPT``)
_KEPT = ("bias", "class_embedding", "lora_a", "lora_b", "gating1", "gating2",
         "kv")


def flax_path(model: nn.Module, name: str) -> Tuple[str, bool]:
    """(the flax leaf path a port parameter is converted from, whether the
    port holds it transposed): the inverse of utils/convert.py's map."""
    from mmgl_tpu_torch.models.layers import LoRALinear, RMSNorm

    mod_name, _, leaf = name.rpartition(".")
    module = model.get_submodule(mod_name) if mod_name else model
    parts = []
    for part in mod_name.split(".") if mod_name else []:
        if part.isdigit() and parts and parts[-1] in ("layers",
                                                      "neighbor_layers"):
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    if isinstance(module, LoRALinear) and leaf in ("weight", "bias"):
        parts.append("dense")
    transposed = False
    if leaf == "weight":
        if isinstance(module, nn.Linear):
            leaf, transposed = "kernel", True
        elif isinstance(module, nn.LayerNorm):
            leaf = "scale"
        elif isinstance(module, RMSNorm):
            leaf = "weight"
        else:   # Embedding tables, the prompt-tuning table
            leaf = "embedding"
    elif leaf not in _KEPT:
        raise KeyError(f"no flax leaf for the parameter {name}")
    return "/".join(parts + [leaf]), transposed


def param_specs(model: nn.Module, mesh_shape: Dict[str, int],
                fsdp: bool = False) -> Dict[str, Tuple[str, Spec, bool]]:
    """{port name: (flax path, spec over the flax leaf's dims, whether the
    port holds the leaf transposed)} for every parameter of the unsharded
    ``model``."""
    out = {}
    for name, p in model.named_parameters():
        path, transposed = flax_path(model, name)
        shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
        out[name] = (path, leaf_spec(path, shape, mesh_shape, fsdp),
                     transposed)
    return out


def port_dim(spec: Spec, axis: str, transposed: bool) -> Optional[int]:
    """The port tensor's dim that ``spec`` puts on ``axis``, or None."""
    for dim, name in enumerate(spec):
        if name == axis:
            return (len(spec) - 1 - dim) if transposed else dim
    return None


@dataclass
class Mesh:
    """A ``("data", "model")`` grid of ranks; this process is ``rank``.
    Without a process group it is the one-rank (1, 1) mesh and its groups
    are None."""
    shape: Tuple[int, int] = (1, 1)
    axes: Tuple[str, str] = ("data", "model")
    rank: int = 0
    device_mesh: Optional[object] = None

    def group(self, axis: str):
        if self.device_mesh is None or self.size(axis) == 1:
            return None
        return self.device_mesh.get_group(axis)

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    @property
    def n_data(self) -> int:
        return self.size("data")

    @property
    def n_model(self) -> int:
        return self.size("model")

    @property
    def data_group(self):
        return self.group("data")

    @property
    def model_group(self):
        return self.group("model")

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def as_dict(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))


def world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("data", "model"),
              device_type: str = "cpu") -> Mesh:
    """The mesh over the world's ranks.

    shape=None or the default (1,1) means "every rank data-parallel", as in
    the JAX package; an explicit shape must take every rank (one process a
    rank: a rank outside the mesh would have nothing to run). A mesh that
    needs more ranks than the world has raises the JAX package's
    ValueError."""
    n_world, rank = world()
    if shape is None or tuple(shape) == (1, 1):
        shape = (n_world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or tuple(axes) != ("data", "model"):
        raise ValueError(f"mesh {shape} over {axes}: the port takes a "
                         "(data, model) mesh")
    n = math.prod(shape)
    if n > n_world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {n_world}")
    if n < n_world:
        raise ValueError(f"mesh {shape} takes {n} of the world's {n_world} "
                         "ranks: the port runs one process a rank, so the "
                         "mesh must take them all")
    if n_world == 1:
        return Mesh(shape, tuple(axes))
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, shape,
                                   mesh_dim_names=tuple(axes))
    return Mesh(shape, tuple(axes), rank, device_mesh)


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks: chosen by the device, never
    by what is available."""
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> Tuple[int, int]:
    """``init_process_group`` for this process (mmgl_tpu/parallel/
    mesh.py:172-180): ``tcp://<coordinator_address>``, ``num_processes``
    ranks, this one ``process_id``. A flag left None is read from
    torchrun's environment (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK), as
    ``jax.distributed.initialize()`` detects its cluster. Returns (world
    size, rank)."""
    env = os.environ

    def from_env(key: str) -> str:
        if key not in env:
            raise ValueError(
                f"--distributed: {key} is not set; pass "
                "--coordinator_address, --num_processes and --process_id, "
                "or launch with torchrun")
        return env[key]

    n = num_processes if num_processes is not None else int(
        from_env("WORLD_SIZE"))
    rank = process_id if process_id is not None else int(from_env("RANK"))
    if coordinator_address is None:
        # torchrun's own store (MASTER_ADDR:MASTER_PORT) through env://
        from_env("MASTER_ADDR"), from_env("MASTER_PORT")
        init = "env://"
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank)
    return n, rank


def local_device(device: torch.device, rank: int) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (LOCAL_RANK, else the rank
    modulo the visible cards) on CUDA, the CPU otherwise."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(1, torch.cuda.device_count())))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def gather_tokens(x, mesh: Mesh) -> np.ndarray:
    """The rows of every data rank, in data-rank order, on every rank
    (mmgl_tpu/parallel/mesh.py:146-169, the reference's eval all_gather of
    generated and label ids). Over the data group only: ranks that differ
    only in their model index hold the same rows, so a gather over the
    world would double them and misalign the pred/ref zip."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    group = mesh.data_group
    if group_size(group) == 1:
        return t.detach().cpu().numpy()
    backend = dist.get_backend(group)
    on = t.detach()
    if backend == "nccl" and on.device.type != "cuda":
        on = on.to(torch.device("cuda", torch.cuda.current_device()))
    return all_gather_cat(on, group, dim=0).cpu().numpy()


def apply_zero1(optimizer_class, params, mesh: Mesh, **defaults):
    """ZeRO-1 (mmgl_tpu/parallel/mesh.py:183-230): the optimizer over
    ``params`` with its state sharded over the data group. Each data rank
    keeps the moments of its share of the tensors (torch's
    ``ZeroRedundancyOptimizer``), updates them and broadcasts the new
    values: the same update as the unsharded optimizer's. With one data
    rank it is the plain optimizer, as in the JAX package."""
    if mesh.n_data == 1:
        return optimizer_class(params, **defaults)
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=optimizer_class,
                                   process_group=mesh.data_group, **defaults)


def fsdp_placement(specs: Dict[str, Tuple[str, Spec, bool]], model: nn.Module,
                   data_axis: str = "data"):
    """``shard_placement_fn`` for ``fully_shard``: each parameter on the
    port dim its FSDP spec puts on the data axis (``param_specs`` with
    fsdp), else dim 0."""
    from torch.distributed.tensor import Shard

    by_id = {}
    for name, p in model.named_parameters():
        path, spec, transposed = specs[name]
        dim = port_dim(spec, data_axis, transposed)
        by_id[id(p)] = Shard(0 if dim is None else dim)
    return lambda p: by_id.get(id(p), Shard(0))


def fsdp_units(model: nn.Module):
    """The modules ``apply_fsdp`` shards one by one, innermost first: each
    decoder, encoder and tower layer; the root takes the rest."""
    units = []
    for name, module in model.named_modules():
        if re.search(r"(^|\.)(layers|neighbor_layers)\.\d+$", name):
            units.append(module)
    return units[::-1]


# the model's entry points besides forward, which FSDP must unshard for
FSDP_METHODS = ("prefill_inputs", "lm_decode", "encode_t5", "decode_t5",
                "pool_text", "pool_images")


def apply_fsdp(model: nn.Module, mesh: Mesh, specs) -> nn.Module:
    """FSDP (ZeRO-3) over the data sub-mesh: ``fully_shard`` on each layer
    and on the root, every parameter (tensor-parallel shards included)
    sharded over the data group on its ``fsdp_placement`` dim; each unit
    all-gathers its weights before it runs and reduce-scatters (averages)
    their gradients. Kept casts (models/layers.py) are invalidated once an
    update or a restore rewrites the sharded values
    (``layers.invalidate_kept_casts``). With one data rank it does
    nothing, as in the JAX package."""
    if mesh.n_data == 1:
        return model
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    data_mesh = mesh.device_mesh["data"]
    place = fsdp_placement(specs, model)
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=place)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=place)
    for method in FSDP_METHODS:
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    model.fsdp = True
    return model


def full_tensor(t: torch.Tensor, model_dim: Optional[int], mesh: Mesh
                ) -> torch.Tensor:
    """The whole of a parameter or state tensor: its FSDP shards gathered
    over the data group (a DTensor's ``full_tensor``), then its
    tensor-parallel shards over the model group along ``model_dim``. A
    collective: every rank calls it in the same order."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach()
    if model_dim is not None:
        t = all_gather_cat(t, mesh.model_group, model_dim)
    return t
