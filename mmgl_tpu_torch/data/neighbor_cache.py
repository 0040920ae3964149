"""Neighbour-embedding cache: the frozen towers' pooled outputs, computed
once per split (counterpart of mmgl_tpu/data/neighbor_cache.py).

The towers are frozen and have no dropout, so every epoch would re-encode
the same neighbour texts through Roberta (11 x 512 tokens a sample) and the
same images through CLIP. ``CachedNeighborDataset`` runs them once over a
split, under ``torch.no_grad()`` on the model's device, and keeps the
pooled features on the host as fp32 numpy arrays:

* ``neighbor_text_pooled`` (N, texts, text hidden) and
  ``neighbor_image_pooled`` (N, images, vision hidden) in the embedding
  mode (``model.pool_text``, ``model.pool_images``);
* ``images_pooled`` (N, images, vision hidden) in the raw mode's
  section_all and all, the spliced images' CLIP features.

Each sample is then served with those arrays in place of the raw ids and
pixels (the JAX package's ``__getitem__``); the fusion model reads them
through ``get_text_embs(pooled=...)`` and ``get_visual_embs(pooled=...)``.
The trainable projections and position tables still run every step, so the
gradients are unchanged; cached equals live up to the order of the
towers' sums (their batches differ).

With ``cache_dir`` the arrays are written to one ``.npz`` (atomically: a
partial file is never read as a warm cache) named by a fingerprint of the
split, its ids, the tower configs, the compute dtype, the shapes of a probed
sample and a checksum of the towers' weights; a start that finds it does no
tower work.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from mmgl_tpu_torch.data.loader import PrefetchLoader


def _every_rank_finds(path: str, group, device) -> bool:
    """Whether ``path`` exists for every rank of ``group`` (a mesh's
    ranks: their tensor-parallel towers build the cache together, so all
    load or all build)."""
    found = os.path.exists(path)
    if group is None:
        return found
    import torch.distributed as dist

    flag = torch.tensor([int(found)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


class CachedNeighborDataset:
    """Wraps an assembler; serves its samples with the cached pooled tower
    outputs in place of the neighbours' raw ids and pixels."""

    def __init__(self, dataset, model, batch_size: int = 16,
                 verbose: bool = True, cache_dir: Optional[str] = None,
                 split: str = "train", num_workers: int = 4, group=None):
        self.dataset = dataset
        cfg = model.config
        self._needs_text = cfg.needs_text_tower
        self._needs_vision = cfg.needs_vision_tower
        self._text_cache: Optional[np.ndarray] = None
        self._image_cache: Optional[np.ndarray] = None
        self._raw_image_cache: Optional[np.ndarray] = None

        path = None
        if cache_dir:
            key = self._fingerprint(model, split)
            path = os.path.join(cache_dir, f"neighbor_cache_{key}.npz")
            if _every_rank_finds(path, group, model.device):
                if verbose:
                    print(f"[neighbor-cache] warm: {path}")
                self._load(path)
                return
        self._build(model, batch_size, verbose, num_workers)
        if path is not None:
            self._save(path)
            if verbose:
                print(f"[neighbor-cache] saved: {path}")

    def __len__(self):
        return len(self.dataset)

    # ---- persistence -----------------------------------------------------

    def _fingerprint(self, model, split: str) -> str:
        """A key over everything the pooled outputs depend on."""
        h = hashlib.sha1()
        h.update(split.encode())
        h.update(str(len(self.dataset)).encode())
        ids = getattr(self.dataset, "id_list", None)
        if ids is not None:
            h.update(repr(list(ids)[:64]).encode())
            h.update(repr(list(ids)[-64:]).encode())
        cfg = model.config
        h.update(repr(cfg.text).encode())
        h.update(repr(cfg.vision).encode())
        h.update(repr(cfg.dtype).encode())
        # the neighbour counts, lengths and image size change the arrays'
        # shapes under the same split and towers: a probed sample's shapes
        # make such a change miss the cache
        if len(self.dataset):
            probe = self.dataset[0]
            h.update(repr(sorted((k, tuple(np.shape(v)))
                                 for k, v in probe.items())).encode())
        # the towers' weights (pretrained or seeded): a float64 sum of each
        # tensor, in the model's parameter order
        for tower in ("text_model", "visual_model"):
            if hasattr(model, tower):
                with torch.no_grad():
                    sums = torch.stack([p.detach().double().sum() for p in
                                        getattr(model, tower).parameters()])
                h.update(sums.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def _save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {name: arr for name, arr in (
            ("text", self._text_cache), ("image", self._image_cache),
            ("raw_image", self._raw_image_cache)) if arr is not None}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _load(self, path: str):
        with np.load(path) as z:
            self._text_cache = z["text"] if "text" in z else None
            self._image_cache = z["image"] if "image" in z else None
            self._raw_image_cache = (z["raw_image"] if "raw_image" in z
                                     else None)

    # ---- build -----------------------------------------------------------

    def _build(self, model, batch_size, verbose, num_workers):
        n = len(self.dataset)
        device = model.device
        loader = PrefetchLoader(self.dataset, batch_size=batch_size,
                                shuffle=False, drop_last=False, prefetch=4,
                                num_workers=num_workers)

        def on_device(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        def pooled_images(px, valid):
            b, nv = px.shape[:2]
            flat = on_device(px.reshape((b * nv,) + px.shape[2:]))
            got = model.pool_images(flat, on_device(valid.reshape(b * nv)))
            return got.float().cpu().numpy().reshape(b, nv, -1)

        def keep(cache, start, pooled):
            if cache is None:
                cache = np.zeros((n,) + pooled.shape[1:], np.float32)
            cache[start:start + pooled.shape[0]] = pooled
            return cache

        start = 0
        for batch in loader:
            b = batch["input_ids"].shape[0]
            if self._needs_text and "neighbor_input_ids" in batch:
                ids = batch["neighbor_input_ids"]
                _, nt, s = ids.shape
                pooled = model.pool_text(
                    on_device(ids.reshape(b * nt, s)),
                    on_device(batch["neighbor_attention_mask"].reshape(
                        b * nt, s)))
                self._text_cache = keep(
                    self._text_cache, start,
                    pooled.float().cpu().numpy().reshape(b, nt, -1))
            if self._needs_vision and "neighbor_images" in batch:
                self._image_cache = keep(
                    self._image_cache, start,
                    pooled_images(batch["neighbor_images"],
                                  batch["neighbor_images_pos_ids"] > 0))
            if self._needs_vision and "images" in batch:
                px = batch["images"]
                valid = batch.get("images_valid",
                                  np.ones(px.shape[:2], np.int32))
                self._raw_image_cache = keep(self._raw_image_cache, start,
                                             pooled_images(px, valid))
            if verbose and (start // batch_size) % 16 == 0:
                print(f"[neighbor-cache] {start}/{n}")
            start += b

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = dict(self.dataset[index])
        if self._text_cache is not None:
            sample["neighbor_text_pooled"] = self._text_cache[index]
            # the raw ids are no longer needed; the position ids and page
            # locations stay
            sample.pop("neighbor_input_ids", None)
            sample.pop("neighbor_attention_mask", None)
        if self._image_cache is not None:
            sample["neighbor_image_pooled"] = self._image_cache[index]
            sample.pop("neighbor_images", None)
        if self._raw_image_cache is not None:
            sample["images_pooled"] = self._raw_image_cache[index]
            sample.pop("images", None)
            sample.pop("images_valid", None)
        return sample
