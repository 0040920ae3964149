"""Tensor parallelism over the mesh's model axis: the seeded, unsharded
model cut to one rank's share in place.

The JAX package annotates each parameter with the rule table's spec and
lets XLA reshard around it. Here each block is cut as megatron cuts it, in
pairs: an attention's q/k/v (and their LoRA B) column-parallel and its
output projection row-parallel, an FFN's first layer column-parallel and
its second row-parallel; OPT's and T5's token tables vocab-parallel, which
makes the tied head's logits vocab-sharded (train/losses.py and
train/generate.py take them so). A block is cut only where the rule table
(parallel/mesh.py ``leaf_spec``) shards every one of its weights; an
attention also needs its head count to divide by m, and otherwise stays
replicated (the JAX result is the same either way: XLA reshards). The
replicated tables that a rank reads only its heads of (T5's
relative-position buckets, the prefix-tuning keys and values) are cut at
use. The attention kernels then run on each rank's H / m heads.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from mmgl_tpu_torch.parallel.collectives import VocabShard
from mmgl_tpu_torch.parallel.mesh import Mesh, param_specs, port_dim

# block class -> (column-parallel children, row-parallel child, is attention)
_BLOCKS = {
    "OPTAttention": (("q_proj", "k_proj", "v_proj"), "out_proj", True),
    "T5Attention": (("q", "k", "v"), "o", True),
    "CLIPAttention": (("query", "key", "value"), "out", True),
    "RobertaSelfAttention": (("query", "key", "value"), "out", True),
    "OPTDecoderLayer": (("fc1",), "fc2", False),
    "CLIPEncoderLayer": (("fc1",), "fc2", False),
    "RobertaLayer": (("intermediate",), "output", False),
    "T5FFN": (("wi", "wi_0", "wi_1"), "wo", False),
}
_VOCAB_TABLES = ("lm.decoder.embed_tokens", "lm.shared")


def _heads(block: nn.Module) -> int:
    """An attention block's head count (CLIP's is an attribute, the others'
    in their config)."""
    if hasattr(block, "num_heads"):
        return block.num_heads
    cfg = block.cfg
    return getattr(cfg, "num_attention_heads", None) or cfg.num_heads


def _narrow(module: nn.Module, pname: str, dim: int, mesh: Mesh) -> None:
    """Replace ``module.<pname>`` by this rank's share along ``dim``."""
    p = getattr(module, pname)
    n = p.shape[dim] // mesh.n_model
    share = p.detach().narrow(dim, mesh.model_index * n, n).clone()
    setattr(module, pname, nn.Parameter(share, requires_grad=p.requires_grad))


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``model`` (built whole on every rank from one seed) to this
    rank's tensor-parallel share. Records on the model ``tp_layout``
    ({parameter name: the dim sharded over the model group}),
    ``vocab_shard`` (the logits' ``VocabShard``, or None) and
    ``tp_replicated`` (the parameters the rule table shards but whose block
    stays whole) and ``tp_rank`` ((m, this rank's model index))."""
    model.tp_layout, model.vocab_shard, model.tp_replicated = {}, None, []
    model.tp_rank = (mesh.n_model, mesh.model_index)
    if mesh.n_model == 1:
        return model
    specs = param_specs(model, mesh.as_dict())
    group = mesh.model_group
    sharded = set()

    def dim_of(name: str) -> Optional[int]:
        path, spec, transposed = specs[name]
        return port_dim(spec, "model", transposed)

    for mod_name, block in model.named_modules():
        kind = _BLOCKS.get(type(block).__name__)
        if kind is None:
            continue
        cols, row, attention = kind
        children = [(c, getattr(block, c)) for c in cols + (row,)
                    if isinstance(getattr(block, c, None), nn.Linear)]
        prefix = f"{mod_name}." if mod_name else ""
        names = [f"{prefix}{c}.{pn}" for c, lin in children
                 for pn, _ in lin.named_parameters()]
        weights = [f"{prefix}{c}.weight" for c, _ in children]
        ok = all(dim_of(w) is not None for w in weights)
        if attention and _heads(block) % mesh.n_model:
            ok = False
        if not ok:
            continue
        for c, lin in children:
            mode = "row" if c == row else "col"
            for pn, _ in list(lin.named_parameters()):
                name = f"{prefix}{c}.{pn}"
                dim = dim_of(name)
                if dim is None:
                    continue
                _narrow(lin, pn, dim, mesh)
                model.tp_layout[name] = dim
            if mode == "col":
                lin.out_features //= mesh.n_model
            else:
                lin.in_features //= mesh.n_model
            lin.tp = (mode, group)
        sharded.update(names)
        if attention and hasattr(block, "dropout_stream"):
            block.dropout_stream = mesh.model_index
        if not attention:
            # an FFN's inner dropout draws the whole width's mask
            drop = getattr(block, "dropout", None)
            if type(block).__name__ == "T5FFN" and drop is not None:
                drop.shard = (-1, mesh.n_model, mesh.model_index)

    for table in _VOCAB_TABLES:
        try:
            emb = model.get_submodule(table)
        except AttributeError:
            continue
        name = f"{table}.weight"
        if dim_of(name) != 0:
            continue
        size = emb.weight.shape[0]
        _narrow(emb, "weight", 0, mesh)
        rows = emb.weight.shape[0]
        emb.num_embeddings = rows
        emb.tp = VocabShard(group, mesh.model_index * rows, size)
        model.tp_layout[name] = 0
        model.vocab_shard = emb.tp
        sharded.add(name)

    _cut_head_tables(model, mesh)
    model.tp_replicated = [n for n in specs if dim_of(n) is not None
                           and n not in sharded]
    return model


def _cut_head_tables(model: nn.Module, mesh: Mesh) -> None:
    """T5's bucket tables and the prefix table, read at the rank's heads
    where its self-attention is cut."""
    lm = getattr(model, "lm", None)
    if lm is None:
        return
    if hasattr(lm, "shared"):       # T5
        for stack in (lm.encoder, lm.decoder):
            attn = stack.layers[0].self_attn
            if attn.q.tp is not None:
                heads = attn.q.weight.shape[0] // lm.config.d_kv
                stack.head_shard = (mesh.model_group,
                                    mesh.model_index * heads, heads)
        decoder_cut = lm.decoder.head_shard
    else:
        decoder_cut = (lm.decoder.layers[0].self_attn.q_proj.tp is not None)
        if decoder_cut:
            heads = lm.local_heads
            decoder_cut = (mesh.model_group, mesh.model_index * heads, heads)
        else:
            decoder_cut = None
    prefix = getattr(model, "prefix_tuning", None)
    if prefix is not None and decoder_cut is not None:
        prefix.head_shard = decoder_cut
