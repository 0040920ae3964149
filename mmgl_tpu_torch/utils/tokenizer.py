"""Tokenization layer.

The reference uses HF AutoTokenizer (run_generation.py:289,294,300). This
framework accepts any HF tokenizer from a *local* path (no network), and ships
a deterministic byte-level tokenizer for tests/benchmarks so nothing depends
on downloaded vocabularies.

Both expose the minimal surface the data layer needs (the exact calls the
reference makes in wikiweb2m/data.py):
  tokenizer(text, max_length=, padding=, truncation=, ...) -> .input_ids/.attention_mask
  tokenizer.pad({"input_ids": [ids]}, max_length=, padding="max_length")
  tokenizer.batch_decode(ids, skip_special_tokens=True)
  .pad_token_id / .bos_token_id / .eos_token_id
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np


@dataclass
class Encoding:
    input_ids: np.ndarray
    attention_mask: np.ndarray

    def __getitem__(self, key):
        return getattr(self, key)


class ByteTokenizer:
    """Deterministic byte-level tokenizer (ids 4..259 are raw UTF-8 bytes).

    Conventions chosen so the reference's label handling carries over:
    pad=0 (T5-style: enc-dec label masking maps id 0 -> -100, data.py:284),
    bos=1 prepended (so the decoder-only BOS-strip at data.py:273 is exercised),
    eos=2, unk=3.
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    vocab_size = 260

    def encode(self, text: str) -> List[int]:
        return [self.bos_token_id] + [4 + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(int(i) - 4 for i in ids if 4 <= int(i) < 260)
        return data.decode("utf-8", errors="ignore")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(batch)]

    def __call__(
        self,
        text: Union[str, List[str]],
        max_length: Optional[int] = None,
        padding: str = "do_not_pad",
        truncation: bool = False,
        return_tensors: Optional[str] = None,
        **kw,
    ) -> Encoding:
        texts = [text] if isinstance(text, str) else list(text)
        seqs = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            seqs = [s[:max_length] for s in seqs]
        return self._pack(seqs, max_length if padding == "max_length" else None)

    def pad(self, inputs, max_length: Optional[int] = None,
            padding: str = "max_length", return_tensors: Optional[str] = None,
            **kw) -> Encoding:
        seqs = [list(np.asarray(s)) for s in inputs["input_ids"]]
        return self._pack(seqs, max_length if padding == "max_length" else None)

    def _pack(self, seqs: List[List[int]], pad_to: Optional[int]) -> Encoding:
        width = pad_to if pad_to is not None else max(len(s) for s in seqs)
        ids = np.full((len(seqs), width), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(seqs), width), dtype=np.int32)
        for i, s in enumerate(seqs):
            s = s[:width]
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return Encoding(ids, mask)


class HFTokenizerAdapter:
    """Wraps an HF tokenizer to always return numpy Encodings."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.pad_token_id = hf_tokenizer.pad_token_id
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id
        self.vocab_size = len(hf_tokenizer)

    def __call__(self, text, max_length=None, padding="do_not_pad",
                 truncation=False, return_tensors=None, **kw) -> Encoding:
        out = self._tok(text, max_length=max_length, padding=padding,
                        truncation=truncation, return_tensors="np", **kw)
        ids = np.atleast_2d(out["input_ids"]).astype(np.int32)
        mask = np.atleast_2d(out["attention_mask"]).astype(np.int32)
        return Encoding(ids, mask)

    def pad(self, inputs, max_length=None, padding="max_length",
            return_tensors=None, **kw) -> Encoding:
        out = self._tok.pad(inputs, max_length=max_length, padding=padding,
                            return_tensors="np", **kw)
        mask = out.get("attention_mask")
        if mask is None:
            mask = (out["input_ids"] != self.pad_token_id).astype(np.int32)
        return Encoding(out["input_ids"].astype(np.int32), np.asarray(mask, np.int32))

    def batch_decode(self, batch, skip_special_tokens=True):
        batch = np.asarray(batch)
        batch = np.where(batch < 0, self.pad_token_id, batch)  # -100 labels
        return self._tok.batch_decode(batch, skip_special_tokens=skip_special_tokens)

    def decode(self, ids, skip_special_tokens=True):
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)


def get_tokenizer(path: Optional[str] = None):
    """Local HF tokenizer if a path is given, else the byte tokenizer.

    `byte:<vocab>` (e.g. `byte:50272`) returns the byte tokenizer with its
    REPORTED vocab padded to <vocab>: ids above 259 are never emitted, but
    the model builds its embedding table and (B, T, V) logits at the
    production width — the knob the r5 soak uses to exercise step-time/RSS
    stability at the reference's 50,272-entry vocab
    (train_generation.sh:6-30) without a downloaded vocabulary.

    Fast tokenizers are preferred (a dir shipping only tokenizer.json has no
    slow class to fall back to); the reference's AutoTokenizer default is
    also fast (run_generation.py:289-300)."""
    if path is None:
        return ByteTokenizer()
    if path.startswith("byte:"):
        tok = ByteTokenizer()
        padded = int(path.split(":", 1)[1])
        assert padded >= 260, f"byte vocab pad {padded} < 260"
        tok.vocab_size = padded   # instance attr shadows the class attr
        return tok
    from transformers import AutoTokenizer

    try:
        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    except Exception:
        tok = AutoTokenizer.from_pretrained(path, use_fast=False,
                                            local_files_only=True)
    return HFTokenizerAdapter(tok)
