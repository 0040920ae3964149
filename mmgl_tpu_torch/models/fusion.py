"""Neighbor fusion: the MMGL model (counterpart of mmgl_tpu/models/fusion.py).

Ported for the decoder-only OPT LM and the encoder-decoder T5, in raw and
embedding neighbor modes, all four contexts:

* raw section_only and text_only are a plain LM call; raw section_all and
  all splice the frozen CLIP tower's image soft tokens into the reserved
  token positions (modelling_self_attention.py:248-261 in the reference),
  into the prompt for OPT and into the encoder input for T5.
* embedding mode (the paper's method) encodes each neighbor text with the
  frozen Roberta tower and pools its first token (``TextPooler``: dense +
  tanh), or with ``--text_model clip*`` the frozen CLIP text tower, whose
  pooled output (at the EOT position) is taken as it is, with no pooler
  (mmgl_tpu/models/fusion.py:118-125, 174-181); projects it from the
  tower's width to ``n_text_tokens`` soft tokens (``text_embeddings``)
  and, in section_all and all, each neighbor image with the frozen CLIP
  tower into ``n_visual_tokens`` (``visual_embeddings``); the two are
  interleaved by their page locations (``_build_neighbor_block``),
  optionally given graph position encodings (the Laplacian ``lpe`` through
  ``lpe_embeddings``, or the ``gnn`` over the page graph, context all only),
  and appended after the input tokens with their mask; OPT's labels are
  -100 there (``_append_neighbors``). section_only and text_only append the
  text neighbors alone.

MPT (``mpt``, an OPT with cross layers, models/opt.py) in the embedding
mode takes the neighbour block as cross-attention memory instead of
appending it (``uses_mpt_memory``; mmgl_tpu/models/fusion.py:64-72,
255-262, 281-286): the LM sees the prompt and summary alone, its
``neighbor_layers`` read the block under its mask, in training, the prefill
and every decode step; its position tables always exist, and the graph
encodings and prompt tuning do not apply. In the raw mode MPT is OPT.

PEFT: prompt tuning prepends ``num_virtual_tokens`` learned embeddings
(``prompt_tuning``) to the LM's (T5: the encoder's) input, the mask
extended with ones and OPT's labels with -100 (:347-358); prefix tuning
hands ``prefix_tuning``'s per-layer keys and values to the LM's
self-attention (T5: the decoder's) in the teacher-forced forward
(:158-167), and to nothing in generation, as in the JAX package. LoRA and
the flamingo gates live in the LM (models/opt.py).

The towers run without autograd (``stop_gradient`` at
mmgl_tpu/models/fusion.py:176-193): the text tower's stop sits after
``text_pooler``, so the pooler is trainable but gets no gradient (the
train step gives such a parameter, named in ``gradless_prefixes``, a zero
one, as jax.grad does, and raises for any other without a gradient). The
projections, position tables, ``lpe_embeddings`` and ``gnn`` train. T5's
labels are the summary alone and are left as they are (fusion.py:308).

Batches are the data layer's dicts of numpy arrays or tensors, with the same
keys and shapes as the JAX package's; ``_as_tensor`` moves every field to
the model's device (images as uint8, normalized there). A batch of the
neighbour cache (data/neighbor_cache.py) carries the towers' pooled
features (``neighbor_text_pooled``, ``neighbor_image_pooled``,
``images_pooled``) in place of the raw ids and pixels, and the towers do
not run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mmgl_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                        CLIPVisionConfig, CLIPVisionModel,
                                        normalize_pixels)
from mmgl_tpu_torch.models.graph import GCN
from mmgl_tpu_torch.models.layers import Embedding, Linear
from mmgl_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from mmgl_tpu_torch.models.roberta import RobertaConfig, RobertaModel
from mmgl_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from mmgl_tpu_torch.peft.virtual_tokens import PrefixTuning, PromptTuning
from mmgl_tpu_torch.utils import spans

IGNORE_INDEX = -100


CONTEXTS = ("section_only", "section_all", "text_only", "all")
NEIGHBOR_MODES = ("raw", "embedding")
POSITION_TYPES = ("none", "embedding", "laplacian", "gnn")


@dataclass(frozen=True)
class FusionConfig:
    """OPT (decoder-only; with ``mpt`` MPT, whose ``opt`` config then has
    the cross layers where a memory exists) or T5 (encoder-decoder) with
    raw or embedding neighbors: exactly one of ``opt`` and ``t5`` is set;
    ``text`` is the text tower's config where the embedding mode needs it,
    a ``CLIPTextConfig`` for a "clip" text model, else a
    ``RobertaConfig``; ``peft_type`` picks the virtual tokens (prompt,
    prefix) this model holds (LoRA and the gates are the LM's)."""
    context: str = "section_only"         # one of CONTEXTS
    neighbor_mode: str = "raw"            # one of NEIGHBOR_MODES
    n_text_tokens: int = 4
    n_visual_tokens: int = 4
    position_type: str = "none"           # one of POSITION_TYPES
    max_text_neighbors: int = 11
    max_image_neighbors: int = 5
    max_input_length: int = 512
    max_output_length: int = 128
    mpt: bool = False                     # OPT with MPT's cross layers
    peft_type: str = "none"
    num_virtual_tokens: int = 20
    opt: Optional[OPTConfig] = None
    vision: Optional[CLIPVisionConfig] = None
    t5: Optional[T5Config] = None
    text: Optional[Union[RobertaConfig, CLIPTextConfig]] = None

    def __post_init__(self):
        if self.context not in CONTEXTS:
            raise ValueError(f"unknown context {self.context!r}")
        if self.neighbor_mode not in NEIGHBOR_MODES:
            raise ValueError(f"unknown neighbor_mode {self.neighbor_mode!r}")
        if self.position_type not in POSITION_TYPES:
            raise ValueError(f"unknown position_type {self.position_type!r}")

    @property
    def clip_text(self) -> bool:
        """The CLIP text tower in place of Roberta, as the factory chose it
        from the text model's name (mmgl_tpu/models/fusion.py:119)."""
        return isinstance(self.text, CLIPTextConfig)

    @property
    def uses_mpt_memory(self) -> bool:
        """MPT takes the embedding mode's neighbours as cross-attention
        memory (the flag parser maps cross_attention to embedding)."""
        return self.mpt and self.neighbor_mode == "embedding"

    @property
    def needs_text_tower(self) -> bool:
        if self.mpt:
            return self.has_memory
        return self.neighbor_mode == "embedding"

    @property
    def has_memory(self) -> bool:
        """Whether MPT's decoder gets a neighbour memory, and so has cross
        layers (the JAX package creates them on their first call)."""
        return self.uses_mpt_memory and self.context != "section_only"

    @property
    def neighbor_positions(self) -> bool:
        """Whether the neighbour position tables exist: a position type, or
        MPT (mmgl_tpu/models/fusion.py:131, :141)."""
        return self.position_type != "none" or self.mpt

    @property
    def prompt_tuning(self) -> bool:
        return self.peft_type == "prompt" and not self.uses_mpt_memory

    @property
    def needs_vision_tower(self) -> bool:
        return self.context in ("section_all", "all")

    @property
    def graph_positions(self) -> bool:
        """Whether the neighbor block takes the Laplacian or GCN encodings:
        context all only, where the JAX package calls (and so creates)
        ``lpe_embeddings`` and ``gnn`` (fusion.py:324-331)."""
        return (self.needs_text_tower and not self.uses_mpt_memory
                and self.context == "all"
                and self.position_type in ("laplacian", "gnn"))

    @property
    def decoder_only(self) -> bool:
        return self.t5 is None

    @property
    def embed_dim(self) -> int:
        return self.t5.d_model if self.t5 is not None else self.opt.embed_dim

    @property
    def dtype(self) -> torch.dtype:
        """The LM's compute dtype."""
        return self.t5.dtype if self.t5 is not None else self.opt.dtype


class TextPooler(nn.Module):
    """First-token pool: dense + tanh (mmgl_tpu/models/fusion.py:84-97)."""

    def __init__(self, hidden_size: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size,
                            compute_dtype=compute_dtype)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden_states[:, 0]))


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


class MMGLModel(nn.Module):
    def __init__(self, cfg: FusionConfig):
        super().__init__()
        self.config = cfg
        # trainable parameters off the gradient path, which the train step
        # gives, and only these, a zero gradient as jax.grad does: the text
        # pooler, behind the text tower's stop_gradient, and MPT's prefix
        # table, which the JAX package creates and never hands its LM
        self.gradless_prefixes = ("text_pooler.",) + (
            ("prefix_tuning.",) if cfg.uses_mpt_memory else ())
        self.lm = (OPTForCausalLM(cfg.opt) if cfg.decoder_only
                   else T5ForConditionalGeneration(cfg.t5))
        dim, dt = cfg.embed_dim, cfg.dtype
        # the modules of mmgl_tpu/models/fusion.py:117-156 that the JAX
        # package calls, and so creates parameters for, in this config
        positions = cfg.neighbor_positions
        if cfg.needs_text_tower:
            text_dim = dim * cfg.n_text_tokens
            hidden = cfg.text.hidden_size
            if cfg.clip_text:
                self.text_model = CLIPTextModel(cfg.text)
            else:
                self.text_model = RobertaModel(cfg.text)
                self.text_pooler = TextPooler(hidden, compute_dtype=dt)
            self.text_embeddings = Linear(hidden, text_dim, compute_dtype=dt)
            if positions:
                # sized max_output_length + 1, as the JAX package sizes it
                self.text_position_embeddings = Embedding(
                    cfg.max_output_length + 1, text_dim, compute_dtype=dt)
        if cfg.needs_vision_tower:
            vis_dim = dim * cfg.n_visual_tokens
            self.visual_model = CLIPVisionModel(cfg.vision)
            self.visual_embeddings = Linear(cfg.vision.hidden_size, vis_dim,
                                            compute_dtype=dt)
            if cfg.neighbor_mode != "raw" and positions:
                self.visual_position_embeddings = Embedding(
                    cfg.max_output_length + 1, vis_dim, compute_dtype=dt)
        if cfg.graph_positions and cfg.position_type == "laplacian":
            # the assembler's k = node_num - 5 (modelling_self_attention.py
            # :137), node_num = 1 + max_text + max_image
            k = 1 + cfg.max_text_neighbors + cfg.max_image_neighbors - 5
            self.lpe_embeddings = Linear(k, dim * cfg.n_text_tokens,
                                         compute_dtype=dt)
        if cfg.graph_positions and cfg.position_type == "gnn":
            self.gnn = GCN(dim * cfg.n_text_tokens, dim * cfg.n_text_tokens,
                           cfg.text.hidden_size, compute_dtype=dt)
        if cfg.prompt_tuning:
            self.prompt_tuning = PromptTuning(cfg.num_virtual_tokens, dim)
        if cfg.peft_type == "prefix":
            # T5: the decoder's self-attention only (encoder-decoder prefix
            # tuning, mmgl_tpu/models/fusion.py:158-167)
            t5, opt = cfg.t5, cfg.opt
            layers, heads, head_dim = (
                (t5.num_decoder_layers, t5.num_heads, t5.d_kv) if t5
                else (opt.num_hidden_layers, opt.num_attention_heads,
                      opt.head_dim))
            self.prefix_tuning = PrefixTuning(
                layers, cfg.num_virtual_tokens, heads, head_dim)

    @property
    def device(self) -> torch.device:
        return next(self.lm.parameters()).device

    # ---- frozen towers (modelling_self_attention.py:154-200) ----

    def pool_text(self, input_ids, attention_mask) -> torch.Tensor:
        """(B*N, S) neighbor texts -> (B*N, tower_hidden): the Roberta
        tower, then ``text_pooler``, or the CLIP text tower's pooled output,
        without autograd (the JAX package's stop_gradient comes after the
        pooler), so the tower's activations are not kept for a backward."""
        with torch.no_grad():
            if self.config.clip_text:
                return self.text_model(input_ids.long(), attention_mask)[1]
            hidden = self.text_model(input_ids.long(), attention_mask)
            return self.text_pooler(hidden)

    def pool_images(self, pixel_values, valid=None) -> torch.Tensor:
        """(B*N, 3, H, W) uint8 -> (B*N, tower_hidden), normalized on the
        device; ``valid`` zeroes placeholder slots. No gradient flows into
        the frozen tower."""
        with torch.no_grad():
            pixels = normalize_pixels(pixel_values, valid,
                                      dtype=self.config.vision.dtype)
            _, pooled = self.visual_model(pixels)
        return pooled

    def project_text(self, pooled, pos_ids=None) -> torch.Tensor:
        """The trainable head over pooled text features: (B*N, n_tok*dim),
        plus the neighbor's position row where the table exists."""
        embs = self.text_embeddings(pooled)
        if pos_ids is not None and hasattr(self, "text_position_embeddings"):
            embs = embs + self.text_position_embeddings(
                pos_ids.reshape(-1).long())
        return embs

    def project_images(self, pooled, pos_ids=None) -> torch.Tensor:
        embs = self.visual_embeddings(pooled)
        if (pos_ids is not None
                and hasattr(self, "visual_position_embeddings")):
            embs = embs + self.visual_position_embeddings(
                pos_ids.reshape(-1).long())
        return embs

    def get_text_embs(self, input_ids, attention_mask, pos_ids=None,
                      pooled=None) -> torch.Tensor:
        """(B, N, S) neighbor texts -> (B, N, n_text_tokens, dim). With
        ``pooled`` (B, N, tower hidden), the neighbour cache's features
        (data/neighbor_cache.py), the frozen tower does not run
        (mmgl_tpu/models/fusion.py:210-224)."""
        if pooled is None:
            b, n, s = input_ids.shape
            pooled = self.pool_text(input_ids.reshape(b * n, s),
                                    attention_mask.reshape(b * n, s))
        else:
            b, n = pooled.shape[:2]
            pooled = pooled.reshape(b * n, -1)
        embs = self.project_text(pooled, pos_ids)
        return embs.reshape(b, n, self.config.n_text_tokens, -1)

    def get_visual_embs(self, pixel_values, pos_ids=None, valid=None,
                        pooled=None) -> torch.Tensor:
        """(B, N, 3, H, W) neighbor images -> (B, N, n_visual_tokens, dim);
        with ``pooled`` (B, N, tower hidden) from the cache, no CLIP
        (mmgl_tpu/models/fusion.py:226-239)."""
        if pooled is None:
            b, n = pixel_values.shape[:2]
            flat = pixel_values.reshape((b * n,)
                                        + tuple(pixel_values.shape[2:]))
            flat_valid = valid.reshape(b * n) if valid is not None else None
            pooled = self.pool_images(flat, flat_valid)
        else:
            b, n = pooled.shape[:2]
            pooled = pooled.reshape(b * n, -1)
        embs = self.project_images(pooled, pos_ids)
        return embs.reshape(b, n, self.config.n_visual_tokens, -1)

    # ---- fusion forward ----

    def forward(self, batch: Dict,
                generator: Optional[torch.Generator] = None,
                return_hidden: bool = False) -> Dict[str, torch.Tensor]:
        """Returns {"logits": (B, S, V), "labels": adjusted labels}, or with
        ``return_hidden`` {"hidden": the LM's pre-head states, "labels"}
        (OPT and MPT only: the vocab-chunked CE folds the tied head into the
        loss; mmgl_tpu/models/fusion.py:246-265, 460-484). ``generator`` is
        the dropout stream, needed in training mode."""
        if return_hidden and not self.config.decoder_only:
            raise ValueError("return_hidden (the chunked CE) is for OPT and "
                             "MPT only: T5's tied head rescales the hidden "
                             "states by d_model**-0.5")
        fused = self._fuse(batch)
        ids = (None if fused["inputs_embeds"] is not None
               else fused["input_ids"])
        if not self.config.decoder_only:
            logits = self.lm(
                input_ids=ids, inputs_embeds=fused["inputs_embeds"],
                attention_mask=fused["attention_mask"],
                labels=fused["labels"], generator=generator,
                prefix_kvs=fused["prefix_kvs"])
        else:
            logits, _ = self.lm(
                input_ids=ids, inputs_embeds=fused["inputs_embeds"],
                attention_mask=fused["attention_mask"], generator=generator,
                neighbor_embeds=fused["neighbor_embeds"],
                neighbor_mask=fused["neighbor_mask"],
                prefix_kvs=fused["prefix_kvs"], return_hidden=return_hidden)
        key = "hidden" if return_hidden else "logits"
        return {key: logits, "labels": fused["labels"]}

    def _fuse(self, batch: Dict) -> Dict[str, Optional[torch.Tensor]]:
        """Image splice (raw section_all / all), soft tokens appended
        (embedding), MPT's memory, or a plain LM call (raw section_only /
        text_only); then the virtual tokens of prompt or prefix tuning."""
        cfg = self.config
        with spans.span("batch_to_device"):
            batch = {k: _as_tensor(v, self.device) for k, v in batch.items()}
        input_ids = batch["input_ids"].long()
        attention_mask = batch["attention_mask"]
        labels = batch["labels"].long() if "labels" in batch else None
        inputs_embeds = neighbor_embeds = neighbor_mask = None

        if cfg.uses_mpt_memory:
            if cfg.has_memory:
                block, block_mask = self._build_neighbor_block(batch)
                b, total, n_tok = block.shape[:3]
                neighbor_embeds = block.reshape(b, total * n_tok, -1)
                neighbor_mask = block_mask.reshape(b, total * n_tok)
        elif (cfg.neighbor_mode == "embedding"
              and not cfg.needs_vision_tower):
            # text neighbors appended as soft tokens
            # (modelling_self_attention.py:263-280)
            text = self.get_text_embs(
                batch.get("neighbor_input_ids"),
                batch.get("neighbor_attention_mask"),
                batch["neighbor_pos_ids"],
                pooled=batch.get("neighbor_text_pooled"))
            b, n = text.shape[:2]
            soft = text.reshape(b, n * cfg.n_text_tokens, -1)
            soft_mask = torch.repeat_interleave(
                batch["neighbor_pos_ids"] > 0, cfg.n_text_tokens, dim=1)
            inputs_embeds, attention_mask, labels = self._append_neighbors(
                input_ids, attention_mask, labels, soft, soft_mask)
        elif cfg.neighbor_mode == "embedding":
            block, block_mask = self._build_neighbor_block(batch)
            b, total, n_tok = block.shape[:3]
            if cfg.graph_positions and cfg.position_type == "laplacian":
                lpe = self.lpe_embeddings(batch["lpe"])  # (B, total+1, nt*d)
                block = block + lpe.reshape(b, total + 1, n_tok, -1)[:, 1:]
            elif cfg.graph_positions:
                flat = block.reshape(b, total, -1)
                block = (flat + self.gnn(flat, batch["graph"])).reshape(
                    block.shape)
            inputs_embeds, attention_mask, labels = self._append_neighbors(
                input_ids, attention_mask, labels,
                block.reshape(b, total * n_tok, -1),
                block_mask.reshape(b, total * n_tok))
        elif cfg.needs_vision_tower:
            b, s = input_ids.shape
            inputs_embeds = self.lm.embed(input_ids.clamp(min=0))  # -1 slots
            visual = self.get_visual_embs(
                batch.get("images"), valid=batch.get("images_valid"),
                pooled=batch.get("images_pooled"))
            visual = visual.reshape(b, -1, visual.shape[-1])
            positions = batch["image_positions"].long()      # (B, N*vt)
            # Padded image slots point at position >= S (the assembler's
            # sacrificial slot, or past a prompt-only batch); JAX's scatter
            # drops them. Route them to one extra column and cut it off.
            keep = positions < s
            pos = torch.where(keep, positions, torch.full_like(positions, s))
            rows = torch.arange(b, device=self.device)[:, None].expand_as(pos)
            spill = inputs_embeds.new_zeros(b, 1, inputs_embeds.shape[-1])
            inputs_embeds = torch.cat([inputs_embeds, spill], dim=1)
            inputs_embeds[rows, pos] = visual.to(inputs_embeds.dtype)
            inputs_embeds = inputs_embeds[:, :s]
            if labels is not None and cfg.decoder_only:
                labels = torch.cat([labels, labels.new_zeros(b, 1)], dim=1)
                labels[rows, pos] = IGNORE_INDEX
                labels = labels[:, :s]

        if cfg.prompt_tuning:
            if inputs_embeds is None:
                inputs_embeds = self.lm.embed(input_ids.clamp(min=0))
            b = inputs_embeds.shape[0]
            virtual = self.prompt_tuning(b).to(inputs_embeds.dtype)
            inputs_embeds = torch.cat([virtual, inputs_embeds], dim=1)
            attention_mask = torch.cat([attention_mask.new_ones(
                b, cfg.num_virtual_tokens), attention_mask], dim=1)
            if cfg.decoder_only and labels is not None:
                labels = torch.cat([labels.new_full(
                    (b, cfg.num_virtual_tokens), IGNORE_INDEX), labels],
                    dim=1)

        return {"input_ids": input_ids, "inputs_embeds": inputs_embeds,
                "attention_mask": attention_mask, "labels": labels,
                "neighbor_embeds": neighbor_embeds,
                "neighbor_mask": neighbor_mask,
                # the prefix table is not handed to MPT's decoder
                # (mmgl_tpu/models/fusion.py:255-262)
                "prefix_kvs": (self.prefix_tuning()
                               if cfg.peft_type == "prefix"
                               and not cfg.uses_mpt_memory else None)}

    def _build_neighbor_block(self, batch: Dict
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Interleave text and image soft tokens by their page locations
        (mmgl_tpu/models/fusion.py:403-439): (B, total, n_tok, dim) and its
        (B, total, n_tok) mask, a padded neighbor slot masked. The
        assembler gives every slot a distinct location in [0, total)."""
        cfg = self.config
        text = self.get_text_embs(batch.get("neighbor_input_ids"),
                                  batch.get("neighbor_attention_mask"),
                                  batch["neighbor_pos_ids"],
                                  pooled=batch.get("neighbor_text_pooled"))
        b, tn, n_tok, dim = text.shape
        tmask = (batch["neighbor_pos_ids"] > 0)[..., None].expand(
            b, tn, n_tok)
        parts = [(batch["text_locations"], text, tmask)]
        if cfg.needs_vision_tower:
            pos = batch["neighbor_images_pos_ids"]
            visual = self.get_visual_embs(
                batch.get("neighbor_images"), pos, valid=pos > 0,
                pooled=batch.get("neighbor_image_pooled"))
            vmask = (pos > 0)[..., None].expand(b, visual.shape[1],
                                                cfg.n_visual_tokens)
            parts.append((batch["image_locations"], visual, vmask))
        total = sum(p[1].shape[1] for p in parts)
        rows = torch.arange(b, device=text.device)[:, None]
        block = text.new_zeros(b, total, n_tok, dim)
        mask = torch.zeros(b, total, n_tok, dtype=torch.bool,
                           device=text.device)
        for locations, embs, m in parts:
            index = (rows, locations.long())
            block = block.index_put(index, embs.to(block.dtype))
            mask = mask.index_put(index, m)
        return block, mask

    def _append_neighbors(self, input_ids, attention_mask, labels,
                          neighbor_embeds, neighbor_mask):
        """Concat the soft tokens after the input tokens; extend the mask
        and, for OPT, the labels with -100 (mmgl_tpu/models/fusion.py
        :441-457)."""
        inputs_embeds = self.lm.embed(input_ids.clamp(min=0))
        inputs_embeds = torch.cat(
            [inputs_embeds, neighbor_embeds.to(inputs_embeds.dtype)], dim=1)
        attention_mask = torch.cat(
            [attention_mask, neighbor_mask.to(attention_mask.dtype)], dim=1)
        if self.config.decoder_only and labels is not None:
            pad = labels.new_full(neighbor_mask.shape, IGNORE_INDEX)
            labels = torch.cat([labels, pad], dim=1)
        return inputs_embeds, attention_mask, labels

    # ---- generation support (train/generate.py) ----

    def prefill_inputs(self, batch: Dict):
        """(inputs_embeds, attention_mask, neighbor_embeds, neighbor_mask)
        for a prompt-only batch (mmgl_tpu/models/fusion.py:373-381): in the
        embedding mode the fused sequence [prompt; soft tokens] and the
        prompt mask extended by the neighbors'; with prompt tuning the
        virtual tokens in front; for MPT the prompt and its memory (else the
        memory is None). No prefix: generation runs without it."""
        fused = self._fuse(batch)
        inputs_embeds = fused["inputs_embeds"]
        if inputs_embeds is None:
            inputs_embeds = self.lm.embed(fused["input_ids"].clamp(min=0))
        return (inputs_embeds, fused["attention_mask"],
                fused["neighbor_embeds"], fused["neighbor_mask"])

    def lm_decode(self, input_ids=None, inputs_embeds=None,
                  attention_mask=None, neighbor_embeds=None,
                  neighbor_mask=None, caches: Optional[list] = None,
                  position_ids=None) -> Tuple[torch.Tensor, list]:
        """Direct decoder-only LM call with caches (generation steps),
        MPT's memory where given; no prefix (the JAX package's
        ``lm_decode`` takes none)."""
        return self.lm(input_ids=input_ids, inputs_embeds=inputs_embeds,
                       attention_mask=attention_mask, caches=caches,
                       position_ids=position_ids,
                       neighbor_embeds=neighbor_embeds,
                       neighbor_mask=neighbor_mask)

    def encode_t5(self, inputs_embeds=None, attention_mask=None
                  ) -> torch.Tensor:
        """T5's encoder over the fused prompt (generation)."""
        return self.lm.encode(inputs_embeds=inputs_embeds,
                              attention_mask=attention_mask)

    def decode_t5(self, decoder_input_ids=None, encoder_states=None,
                  attention_mask=None, caches: Optional[list] = None,
                  position_offset: int = 0) -> Tuple[torch.Tensor, list]:
        """One T5 decoder call with caches (generation steps)."""
        return self.lm.decode(decoder_input_ids, encoder_states,
                              attention_mask=attention_mask, caches=caches,
                              position_offset=position_offset)

