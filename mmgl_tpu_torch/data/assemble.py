"""Sample assembly: page -> fixed-shape numpy training sample.

Pure-python/numpy port of the reference Dataset's per-item logic
(wikiweb2m/data.py:146-294 raw modes, :296-469 embedding mode) with exact
prompt strings — including the literal "conext: " typo (data.py:192,231) —
tokenizer call sequence, BOS-strip/EOS-append (:273), and padding rules, so
token streams are byte-identical given the same tokenizer.

TPU-shaped difference: every sample has FIXED shapes. In raw 'all' mode the
reference emits a variable number of images per sample (which torch's default
collate cannot even stack); here images are padded to (1 + max_image_neighbors)
and padded image_positions point at a sacrificial slot (= sequence length)
that the fusion model scatters into and drops (models/fusion.py).

Copy of mmgl_tpu/data/assemble.py for the PyTorch port, with its imports
rewritten to the port: the JAX package's data layer reaches flax through
models/graph.py, and the port imports no JAX. The code is otherwise
unchanged, so the two produce identical batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from mmgl_tpu_torch.data.store import Page, PageStore
from mmgl_tpu_torch.models.graph import (compute_laplacian_pe,
                                         edges_to_dense_adjacency,
                                         normalize_graph)

# (pixel_values (3,H,W) float32 | None, caption | None)
ImageProvider = Callable[[int, int, Page], Tuple[Optional[np.ndarray],
                                                 Optional[str]]]


def no_images(page_id: int, section_id: int, page: Page):
    return None, None


@dataclass
class AssemblerConfig:
    task: str = "section"
    context: str = "section_only"
    neighbor_mode: str = "raw"
    decoder_only: bool = True
    max_input_length: int = 512
    max_output_length: int = 128
    max_text_neighbors: int = 11
    max_image_neighbors: int = 5
    n_text_tokens: int = 4
    n_visual_tokens: int = 4
    position_type: str = "none"
    image_size: int = 224

    @classmethod
    def from_args(cls, args) -> "AssemblerConfig":
        return cls(task=args.task, context=args.context,
                   neighbor_mode=args.neighbor_mode,
                   decoder_only=args.decoder_only,
                   max_input_length=args.max_input_length,
                   max_output_length=args.max_output_length,
                   max_text_neighbors=args.max_text_neighbors,
                   max_image_neighbors=args.max_image_neighbors,
                   n_text_tokens=args.n_text_tokens,
                   n_visual_tokens=args.n_visual_tokens,
                   position_type=args.position_type)


def _clean(text: str) -> str:
    """' '.join(text.replace('\\n',' ').split()) — the reference normalizer."""
    return " ".join(text.replace("\n", " ").split())


class WikiWeb2MAssembler:
    """Counterpart of the reference WikiWeb2M Dataset (data.py:34-469)."""

    def __init__(self, cfg: AssemblerConfig, store: PageStore,
                 id_list: List[Tuple[int, int]], tokenizer,
                 image_provider: ImageProvider = no_images):
        self.cfg = cfg
        self.store = store
        self.id_list = list(id_list)
        self.tok = tokenizer
        self.images = image_provider

    def __len__(self) -> int:
        return len(self.id_list)

    # ---- text extraction (data.py:78-116) ----

    def get_page_info(self, page: Page) -> str:
        return _clean(", ".join([page.page_title, page.page_description]))

    def get_section_info(self, section_id: int, page: Page,
                         remove_summary: bool = True):
        summary = _clean(page.section_summary[section_id])
        rest = page.section_rest_sentence[section_id]
        if remove_summary:
            return _clean(", ".join([rest])), summary
        return _clean(", ".join([page.section_summary[section_id], rest]))

    def get_section_images(self, page_id: int, section_id: int, page: Page):
        img, caption = self.images(page_id, section_id, page)
        if img is None:
            return None, None
        return img, _clean(caption or "")

    # ---- per-sample assembly ----

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.cfg.neighbor_mode == "embedding":
            return self.get_embedding_item(index)
        return self.get_raw_item(index)

    def _encode(self, text: str, max_length=None, truncation=True):
        enc = self.tok(text, max_length=max_length,
                       padding="do_not_pad", truncation=truncation)
        return list(np.asarray(enc.input_ids[0]))

    def _zero_image(self) -> np.ndarray:
        # uint8 placeholder; the device-side normalizer zeroes invalid slots
        # back to the reference's normalized-space zeros (data.py:189)
        s = self.cfg.image_size
        return np.zeros((3, s, s), np.uint8)

    def get_raw_item(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        page_id, section_id = self.id_list[index]
        page = self.store.get(page_id)
        images: List[np.ndarray] = []
        images_valid: List[int] = []
        image_positions: List[np.ndarray] = []

        if cfg.context == "section_only":
            section_info, labels = self.get_section_info(section_id, page)
            input_ids = self._encode("summarize: " + section_info,
                                     cfg.max_input_length)

        elif cfg.context == "section_all":
            section_info, labels = self.get_section_info(section_id, page)
            image, caption = self.get_section_images(page_id, section_id, page)
            if image is None:
                inputs = "summarize: " + section_info
                visual_ids = [self.tok.pad_token_id] * cfg.n_visual_tokens
                images.append(self._zero_image())
                images_valid.append(0)
            else:
                inputs = "summarize: " + section_info + ", conext: " + caption
                visual_ids = [-1] * cfg.n_visual_tokens
                images.append(image)
                images_valid.append(1)
            max_text = cfg.max_input_length - cfg.n_visual_tokens
            input_ids = self._encode(inputs, max_text)
            image_positions.append(len(input_ids)
                                   + np.arange(cfg.n_visual_tokens))
            input_ids = input_ids + visual_ids

        elif cfg.context == "text_only":
            page_info = self.get_page_info(page)
            section_info, labels = self.get_section_info(section_id, page)
            context_info = ", ".join(
                self.get_section_info(cid, page, remove_summary=False)
                for cid in range(page.num_sections) if cid != section_id)
            inputs = ("summarize: " + section_info + ", context: "
                      + page_info + context_info)
            input_ids = self._encode(inputs, cfg.max_input_length)

        elif cfg.context == "all":
            page_info = self.get_page_info(page)  # built for parity (:217)
            section_info, labels = self.get_section_info(section_id, page)
            image, caption = self.get_section_images(page_id, section_id, page)
            if image is None:
                inputs = "summarize: " + section_info
                visual_ids = [self.tok.pad_token_id] * cfg.n_visual_tokens
                images.append(self._zero_image())
                images_valid.append(0)
            else:
                inputs = "summarize: " + section_info + ", conext: " + caption
                visual_ids = [-1] * cfg.n_visual_tokens
                images.append(image)
                images_valid.append(1)
            max_text = cfg.max_input_length - cfg.n_visual_tokens
            input_ids = self._encode(inputs, max_text)
            image_positions.append(len(input_ids)
                                   + np.arange(cfg.n_visual_tokens))
            input_ids = input_ids + visual_ids

            for cid in range(page.num_sections):
                if cid == section_id:
                    continue
                context_info = self.get_section_info(cid, page,
                                                     remove_summary=False)
                cimg, ccap = self.get_section_images(page_id, cid, page)
                if cimg is None:
                    context = context_info
                    visual_ids = [self.tok.pad_token_id] * cfg.n_visual_tokens
                    cimg = self._zero_image()
                    cvalid = 0
                else:
                    context = context_info + ccap
                    visual_ids = [-1] * cfg.n_visual_tokens
                    cvalid = 1
                context_ids = self._encode(context, truncation=False)
                if (len(input_ids) + len(context_ids) + len(visual_ids)
                        > cfg.max_input_length):
                    break
                if len(images) >= 1 + cfg.max_image_neighbors:
                    break  # fixed-shape budget (TPU-shaped divergence)
                images.append(cimg)
                images_valid.append(cvalid)
                image_positions.append(len(input_ids) + len(context_ids)
                                       + np.arange(cfg.n_visual_tokens))
                input_ids = input_ids + context_ids + visual_ids

            input_ids = input_ids[: cfg.max_input_length]
        else:
            raise ValueError(f"unknown context {cfg.context}")

        result = self._finalize_text(input_ids, labels)

        if cfg.context in ("section_all", "all"):
            total_len = result["input_ids"].shape[0]
            max_images = 1 if cfg.context == "section_all" else (
                1 + cfg.max_image_neighbors)
            while len(images) < max_images:
                images.append(self._zero_image())
                images_valid.append(0)
                # sacrificial slot: scattered then dropped by the model
                image_positions.append(
                    np.full((cfg.n_visual_tokens,), total_len, np.int64))
            result["images"] = np.stack(images)
            result["images_valid"] = np.asarray(images_valid, np.int32)
            result["image_positions"] = np.concatenate(
                image_positions).astype(np.int32)
        return result

    def _finalize_text(self, input_ids: List[int], labels: str):
        """Pad + label construction (data.py:267-285)."""
        cfg = self.cfg
        tok = self.tok
        inp = tok.pad({"input_ids": [np.asarray(input_ids)]},
                      max_length=cfg.max_input_length, padding="max_length")
        if cfg.decoder_only:
            label_text = ", summary: " + labels
            label_ids = self._encode(label_text, cfg.max_output_length)
            # strip BOS, append EOS (data.py:273)
            label_ids = label_ids[1:] + [tok.eos_token_id]
            out = tok.pad({"input_ids": [np.asarray(label_ids)]},
                          max_length=cfg.max_output_length,
                          padding="max_length")
            ids = np.concatenate([inp.input_ids[0], out.input_ids[0]])
            mask = np.concatenate([inp.attention_mask[0],
                                   out.attention_mask[0]])
            return {"input_ids": ids.astype(np.int32),
                    "attention_mask": mask.astype(np.int32),
                    "labels": ids.astype(np.int32).copy()}
        enc = self.tok(labels, max_length=cfg.max_output_length,
                       padding="max_length", truncation=True)
        lab = np.asarray(enc.input_ids[0], np.int32)
        lab = np.where(lab == 0, -100, lab)  # id 0 -> ignore (data.py:284)
        return {"input_ids": inp.input_ids[0].astype(np.int32),
                "attention_mask": inp.attention_mask[0].astype(np.int32),
                "labels": lab}

    # ---- embedding mode (data.py:296-469) ----

    def get_embedding_item(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        page_id, section_id = self.id_list[index]
        page = self.store.get(page_id)

        section_info, labels = self.get_section_info(section_id, page)
        inputs = "summarize: " + section_info
        enc = self.tok(inputs, max_length=cfg.max_input_length,
                       padding="max_length", truncation=True)
        if cfg.decoder_only:
            label_text = ", summary: " + labels
            label_ids = self._encode(label_text, cfg.max_output_length)
            label_ids = label_ids[1:] + [self.tok.eos_token_id]
            out = self.tok.pad({"input_ids": [np.asarray(label_ids)]},
                               max_length=cfg.max_output_length,
                               padding="max_length")
            ids = np.concatenate([enc.input_ids[0], out.input_ids[0]])
            mask = np.concatenate([enc.attention_mask[0],
                                   out.attention_mask[0]])
            result = {"input_ids": ids.astype(np.int32),
                      "attention_mask": mask.astype(np.int32),
                      "labels": ids.astype(np.int32).copy()}
        else:
            lab_enc = self.tok(labels, max_length=cfg.max_output_length,
                               padding="max_length", truncation=True)
            lab = np.asarray(lab_enc.input_ids[0], np.int32)
            lab = np.where(lab == 0, -100, lab)
            result = {"input_ids": enc.input_ids[0].astype(np.int32),
                      "attention_mask": enc.attention_mask[0].astype(np.int32),
                      "labels": lab}

        # --- neighbor packing + page graph (data.py:340-454) ---
        neighbor_texts: List[str] = []
        neighbor_images: List[np.ndarray] = []
        position_texts: List[int] = []
        position_images: List[int] = []
        location_texts: List[int] = []
        location_images: List[int] = []
        location = 0
        graph_index = {section_id: 0}
        edge_list: List[Tuple[int, int]] = []

        # (1) page info
        neighbor_texts.append(self.get_page_info(page))
        position_texts.append(0)
        location_texts.append(location)
        location += 1
        edge_list.append((0, location))

        # (2) target-section image + caption
        img, cap = self.get_section_images(page_id, section_id, page)
        if img is not None:
            neighbor_images.append(img)
            position_images.append(0)
            location_images.append(location)
            location += 1
            edge_list.append((0, location))
            prev_image = location
            neighbor_texts.append(cap)
            position_texts.append(len(position_texts))
            location_texts.append(location)
            location += 1
            edge_list.append((0, location))
            edge_list.append((prev_image, location))

        # (3) other sections
        prev_section = -1
        for cid in range(page.num_sections):
            if cid == section_id:
                continue
            if len(neighbor_texts) < cfg.max_text_neighbors:
                neighbor_texts.append(
                    self.get_section_info(cid, page, remove_summary=False))
                position_texts.append(len(position_texts))
                location_texts.append(location)
                location += 1
                if prev_section > -1:
                    edge_list.append((prev_section, location))
                graph_index[cid] = location
                prev_section = location
            if len(neighbor_images) < cfg.max_image_neighbors:
                cimg, ccap = self.get_section_images(page_id, cid, page)
                if cimg is not None:
                    neighbor_images.append(cimg)
                    position_images.append(len(position_images))
                    location_images.append(location)
                    location += 1
                    edge_list.append((prev_section, location))
                    prev_image = location
                    if len(neighbor_texts) < cfg.max_text_neighbors:
                        neighbor_texts.append(ccap)
                        position_texts.append(len(position_texts))
                        location_texts.append(location)
                        location += 1
                        edge_list.append((prev_section, location))
                        edge_list.append((prev_image, location))

        # hierarchy edges (data.py:423-426)
        for cid in range(len(page.section_parent_index)):
            parent = page.section_parent_index[cid]
            if cid in graph_index and parent in graph_index:
                edge_list.append((graph_index[cid], graph_index[parent]))

        node_num = 1 + cfg.max_text_neighbors + cfg.max_image_neighbors
        # +1 for padding id (data.py:440-442)
        position_texts = [p + 1 for p in position_texts]
        position_images = [p + 1 for p in position_images]
        while len(neighbor_texts) < cfg.max_text_neighbors:
            neighbor_texts.append("")
            position_texts.append(0)
            location_texts.append(location)
            location += 1
        while len(neighbor_images) < cfg.max_image_neighbors:
            neighbor_images.append(self._zero_image())
            position_images.append(0)
            location_images.append(location)
            location += 1

        ntok = self.tok(neighbor_texts, max_length=cfg.max_input_length,
                        padding="max_length", truncation=True)
        result["neighbor_input_ids"] = ntok.input_ids.astype(np.int32)
        result["neighbor_attention_mask"] = ntok.attention_mask.astype(np.int32)
        result["neighbor_pos_ids"] = np.asarray(position_texts, np.int32)
        result["text_locations"] = np.asarray(location_texts, np.int32)
        result["neighbor_images"] = np.stack(neighbor_images)
        result["neighbor_images_pos_ids"] = np.asarray(position_images,
                                                       np.int32)
        result["image_locations"] = np.asarray(location_images, np.int32)

        if cfg.position_type == "laplacian":
            adj = edges_to_dense_adjacency(edge_list, node_num)
            k = node_num - 5  # modelling_self_attention.py:137
            result["lpe"] = compute_laplacian_pe(adj, k)
        elif cfg.position_type == "gnn":
            adj = edges_to_dense_adjacency(edge_list, node_num)
            result["graph"] = normalize_graph(adj)
        return result
