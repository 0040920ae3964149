"""Neighbor fusion: the MMGL model (counterpart of mmgl_tpu/models/fusion.py).

Ported for the decoder-only OPT LM in raw neighbor mode, all four contexts:
section_only and text_only are a plain LM call; section_all and all splice
the frozen CLIP tower's image soft tokens into the reserved token positions
(modelling_self_attention.py:248-261 in the reference). The tower runs
without autograd (``stop_gradient`` at mmgl_tpu/models/fusion.py:193); the
projection ``visual_embeddings`` after it trains. Embedding and
cross-attention modes, T5, MPT and PEFT are refused at model build
(models/factory.py).

Batches are the data layer's dicts of numpy arrays or tensors, with the same
keys and shapes as the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmgl_tpu_torch.models.clip import (CLIPVisionConfig, CLIPVisionModel,
                                        normalize_pixels)
from mmgl_tpu_torch.models.layers import Linear
from mmgl_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

IGNORE_INDEX = -100


CONTEXTS = ("section_only", "section_all", "text_only", "all")


@dataclass(frozen=True)
class FusionConfig:
    """Decoder-only OPT with raw neighbors (the ported fusion mode)."""
    context: str = "section_only"         # one of CONTEXTS
    n_visual_tokens: int = 4
    max_input_length: int = 512
    opt: Optional[OPTConfig] = None
    vision: Optional[CLIPVisionConfig] = None

    def __post_init__(self):
        if self.context not in CONTEXTS:
            raise ValueError(f"unknown context {self.context!r}")

    @property
    def needs_vision_tower(self) -> bool:
        return self.context in ("section_all", "all")

    @property
    def embed_dim(self) -> int:
        return self.opt.embed_dim


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


class MMGLModel(nn.Module):
    def __init__(self, cfg: FusionConfig):
        super().__init__()
        self.config = cfg
        self.lm = OPTForCausalLM(cfg.opt)
        if cfg.needs_vision_tower:
            self.visual_model = CLIPVisionModel(cfg.vision)
            self.visual_embeddings = Linear(
                cfg.vision.hidden_size, cfg.embed_dim * cfg.n_visual_tokens,
                compute_dtype=cfg.opt.dtype)

    @property
    def device(self) -> torch.device:
        return self.lm.decoder.embed_tokens.weight.device

    # ---- frozen image tower (modelling_self_attention.py:154-200) ----

    def pool_images(self, pixel_values, valid=None) -> torch.Tensor:
        """(B*N, 3, H, W) uint8 -> (B*N, tower_hidden), normalized on the
        device; ``valid`` zeroes placeholder slots. No gradient flows into
        the frozen tower."""
        with torch.no_grad():
            pixels = normalize_pixels(pixel_values, valid,
                                      dtype=self.config.vision.dtype)
            _, pooled = self.visual_model(pixels)
        return pooled

    def get_visual_embs(self, pixel_values, valid=None) -> torch.Tensor:
        """(B, N, 3, H, W) neighbor images -> (B, N, n_visual_tokens, dim)."""
        b, n = pixel_values.shape[:2]
        flat = pixel_values.reshape((b * n,) + tuple(pixel_values.shape[2:]))
        flat_valid = valid.reshape(b * n) if valid is not None else None
        embs = self.visual_embeddings(self.pool_images(flat, flat_valid))
        return embs.reshape(b, n, self.config.n_visual_tokens, -1)

    # ---- fusion forward ----

    def forward(self, batch: Dict,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Returns {"logits": (B, S, V), "labels": adjusted labels}.
        ``generator`` is the dropout stream, needed in training mode."""
        fused = self._fuse(batch)
        logits, _ = self.lm(
            input_ids=None if fused["inputs_embeds"] is not None
            else fused["input_ids"],
            inputs_embeds=fused["inputs_embeds"],
            attention_mask=fused["attention_mask"], generator=generator)
        return {"logits": logits, "labels": fused["labels"]}

    def _fuse(self, batch: Dict) -> Dict[str, Optional[torch.Tensor]]:
        """Image splice (raw section_all / all) or a plain LM call."""
        cfg = self.config
        batch = {k: _as_tensor(v, self.device) for k, v in batch.items()}
        input_ids = batch["input_ids"].long()
        attention_mask = batch["attention_mask"]
        labels = batch["labels"].long() if "labels" in batch else None
        inputs_embeds = None

        if cfg.needs_vision_tower:
            b, s = input_ids.shape
            inputs_embeds = self.lm.embed(input_ids.clamp(min=0))  # -1 slots
            visual = self.get_visual_embs(batch["images"],
                                          valid=batch.get("images_valid"))
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
            if labels is not None:
                labels = torch.cat([labels, labels.new_zeros(b, 1)], dim=1)
                labels[rows, pos] = IGNORE_INDEX
                labels = labels[:, :s]

        return {"input_ids": input_ids, "inputs_embeds": inputs_embeds,
                "attention_mask": attention_mask, "labels": labels}

    # ---- generation support (train/generate.py) ----

    def prefill_inputs(self, batch: Dict) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(inputs_embeds, attention_mask) for a prompt-only batch."""
        fused = self._fuse(batch)
        inputs_embeds = fused["inputs_embeds"]
        if inputs_embeds is None:
            inputs_embeds = self.lm.embed(fused["input_ids"].clamp(min=0))
        return inputs_embeds, fused["attention_mask"]

    def lm_decode(self, input_ids=None, inputs_embeds=None,
                  attention_mask=None, caches: Optional[list] = None,
                  position_ids=None) -> Tuple[torch.Tensor, list]:
        """Direct decoder-only LM call with caches (generation steps)."""
        return self.lm(input_ids=input_ids, inputs_embeds=inputs_embeds,
                       attention_mask=attention_mask, caches=caches,
                       position_ids=position_ids)

