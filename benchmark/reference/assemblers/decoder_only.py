"""The batches a training run should see, worked out from the corpus.

Plain Python and numpy, written from the reference dataset's rules
(WikiWeb2M ``data.py``: the prompt strings, the literal "conext: " of the
raw modes, BOS stripped from the summary and EOS appended, padding to the
fixed lengths, images padded to 1 + max_image_neighbors with the spare
slots' soft tokens aimed one past the sequence) and the byte tokenizer's
convention (pad 0, BOS 1, EOS 2, byte b as 4 + b). It covers the
decoder-only forms the benchmark runs: the raw ``all`` context and the
embedding mode without graph encodings. The loader's order is the
seeded shuffle of a distributed sampler: one permutation a pass, by
(seed + epoch * 1_000_003 + pass) mod 2**32, cut into whole batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2


def encode(text: str, max_length: Optional[int] = None) -> List[int]:
    ids = [BOS] + [4 + b for b in text.encode("utf-8")]
    return ids if max_length is None else ids[:max_length]


def pad(ids: Sequence[int], width: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = list(ids)[:width]
    out = np.zeros(width, np.int32)
    mask = np.zeros(width, np.int32)
    out[:len(ids)] = ids
    mask[:len(ids)] = 1
    return out, mask


def clean(text: str) -> str:
    return " ".join(text.replace("\n", " ").split())


class Assembler:
    """``item(index)``: the sample of ``ids[index]`` as a dict of arrays;
    ``batch(indices)``: those samples stacked."""

    def __init__(self, pages: List[Dict], ids: List[Tuple[int, int]],
                 images: Dict, s: Dict):
        self.pages = {p["page_id"]: p for p in pages}
        self.ids = list(ids)
        self.images = images
        self.s = s          # the run's settings (flag name -> value)

    def _image(self, pid: int, sid: int):
        got = self.images.get((pid, sid))
        if got is None:
            return None, None
        return got[0], clean(got[1])

    def _zero(self) -> np.ndarray:
        n = self.s["image_size"]
        return np.zeros((3, n, n), np.uint8)

    @staticmethod
    def _section(page: Dict, sid: int, with_summary: bool) -> str:
        if with_summary:
            return clean(", ".join([page["section_summary"][sid],
                                    page["section_rest_sentence"][sid]]))
        return clean(page["section_rest_sentence"][sid])

    def _text(self, prompt_ids: List[int], summary: str, in_len: int):
        """input_ids, attention_mask, labels of prompt + summary."""
        out_len = self.s["max_output_length"]
        inp, inp_mask = pad(prompt_ids, in_len)
        lab = encode(", summary: " + summary, out_len)[1:] + [EOS]
        out, out_mask = pad(lab, out_len)
        ids = np.concatenate([inp, out])
        return {"input_ids": ids, "attention_mask":
                np.concatenate([inp_mask, out_mask]), "labels": ids.copy()}

    def item(self, index: int) -> Dict[str, np.ndarray]:
        if self.s["neighbor_mode"] == "embedding":
            return self._embedding_item(index)
        if self.s["context"] != "all":
            raise ValueError(f"context {self.s['context']!r} is not covered")
        return self._raw_all_item(index)

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        items = [self.item(int(i)) for i in indices]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def _raw_all_item(self, index: int) -> Dict[str, np.ndarray]:
        s = self.s
        nv, in_len = s["n_visual_tokens"], s["max_input_length"]
        pid, sid = self.ids[index]
        page = self.pages[pid]
        summary = clean(page["section_summary"][sid])
        img, cap = self._image(pid, sid)
        prompt = "summarize: " + self._section(page, sid, False)
        if img is None:
            visual, images, valid = [PAD] * nv, [self._zero()], [0]
        else:
            prompt += ", conext: " + cap
            visual, images, valid = [-1] * nv, [img], [1]
        ids = encode(prompt, in_len - nv)
        positions = [len(ids) + np.arange(nv)]
        ids = ids + visual
        for cid in range(len(page["section_title"])):
            if cid == sid:
                continue
            context = self._section(page, cid, True)
            cimg, ccap = self._image(pid, cid)
            if cimg is None:
                cvis, cimg, cvalid = [PAD] * nv, self._zero(), 0
            else:
                context, cvis, cvalid = context + ccap, [-1] * nv, 1
            cids = encode(context)
            if len(ids) + len(cids) + nv > in_len:
                break
            if len(images) >= 1 + s["max_image_neighbors"]:
                break
            images.append(cimg)
            valid.append(cvalid)
            positions.append(len(ids) + len(cids) + np.arange(nv))
            ids = ids + cids + cvis
        out = self._text(ids[:in_len], summary, in_len)
        total = in_len + s["max_output_length"]
        while len(images) < 1 + s["max_image_neighbors"]:
            images.append(self._zero())
            valid.append(0)
            positions.append(np.full(nv, total))
        out["images"] = np.stack(images)
        out["images_valid"] = np.asarray(valid, np.int32)
        out["image_positions"] = np.concatenate(positions).astype(np.int32)
        return out

    def _embedding_item(self, index: int) -> Dict[str, np.ndarray]:
        s = self.s
        in_len = s["max_input_length"]
        max_t, max_i = s["max_text_neighbors"], s["max_image_neighbors"]
        pid, sid = self.ids[index]
        page = self.pages[pid]
        summary = clean(page["section_summary"][sid])
        prompt = encode("summarize: " + self._section(page, sid, False),
                        in_len)
        out = self._text(prompt, summary, in_len)

        texts = [clean(", ".join([page["page_title"],
                                  page["page_description"]]))]
        t_pos, t_loc, i_pos, i_loc, imgs = [0], [0], [], [], []
        location = 1
        img, cap = self._image(pid, sid)
        if img is not None:
            imgs.append(img)
            i_pos.append(0)
            i_loc.append(location)
            location += 1
            texts.append(cap)
            t_pos.append(len(t_pos))
            t_loc.append(location)
            location += 1
        for cid in range(len(page["section_title"])):
            if cid == sid:
                continue
            if len(texts) < max_t:
                texts.append(self._section(page, cid, True))
                t_pos.append(len(t_pos))
                t_loc.append(location)
                location += 1
            if len(imgs) < max_i:
                cimg, ccap = self._image(pid, cid)
                if cimg is not None:
                    imgs.append(cimg)
                    i_pos.append(len(i_pos))
                    i_loc.append(location)
                    location += 1
                    if len(texts) < max_t:
                        texts.append(ccap)
                        t_pos.append(len(t_pos))
                        t_loc.append(location)
                        location += 1
        t_pos = [p + 1 for p in t_pos]
        i_pos = [p + 1 for p in i_pos]
        while len(texts) < max_t:
            texts.append("")
            t_pos.append(0)
            t_loc.append(location)
            location += 1
        while len(imgs) < max_i:
            imgs.append(self._zero())
            i_pos.append(0)
            i_loc.append(location)
            location += 1
        enc = [pad(encode(t, in_len), in_len) for t in texts]
        out["neighbor_input_ids"] = np.stack([e[0] for e in enc])
        out["neighbor_attention_mask"] = np.stack([e[1] for e in enc])
        out["neighbor_pos_ids"] = np.asarray(t_pos, np.int32)
        out["text_locations"] = np.asarray(t_loc, np.int32)
        out["neighbor_images"] = np.stack(imgs)
        out["neighbor_images_pos_ids"] = np.asarray(i_pos, np.int32)
        out["image_locations"] = np.asarray(i_loc, np.int32)
        return out


def loader_order(n: int, batch: int, seed: int, epoch: int = 0,
                 data_pass: int = 0) -> List[np.ndarray]:
    """The indices of each batch of one pass, in order."""
    idx = np.arange(n)
    np.random.RandomState((seed + epoch * 1_000_003 + data_pass)
                          % 2**32).shuffle(idx)
    usable = (n // batch) * batch
    return [idx[i:i + batch] for i in range(0, usable, batch)]
