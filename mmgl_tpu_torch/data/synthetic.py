"""Synthetic WikiWeb2M fixtures for tests and benchmarks.

Generates deterministic pages with the reference's 12-column structure
(SURVEY §4a: "golden fixtures of a tiny synthetic WikiWeb2M"), an id list of
(page_id, section_id) pairs, and a matching image provider (some sections get
deterministic random images + captions).

Copy of mmgl_tpu/data/synthetic.py for the PyTorch port, with its imports
rewritten to the port: the JAX package's data layer reaches flax through
models/graph.py, and the port imports no JAX. The code is otherwise
unchanged, so the two produce identical batches.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mmgl_tpu_torch.data.store import Page, PageStore

_WORDS = ("graph learning neighbor section wikipedia summary image caption "
          "model multimodal context page title heading content text token "
          "attention layer encoder decoder neural network training data").split()


def _sentence(rng: np.random.RandomState, n: int) -> str:
    return " ".join(rng.choice(_WORDS, size=n))


def make_synthetic_corpus(num_pages: int = 8, max_sections: int = 5,
                          image_prob: float = 0.5, image_size: int = 32,
                          seed: int = 0):
    """Returns (PageStore, id_list, image_provider)."""
    rng = np.random.RandomState(seed)
    pages: List[Page] = []
    id_list: List[Tuple[int, int]] = []
    image_table = {}

    for pid in range(num_pages):
        n_sec = int(rng.randint(2, max_sections + 1))
        sections = []
        urls, caps = [], []
        for sid in range(n_sec):
            sections.append(sid)
            if rng.uniform() < image_prob:
                urls.append([f"http://img/{pid}_{sid}.jpg"])
                caps.append([_sentence(rng, 5)])
                image_table[(pid, sid)] = rng.randint(
                    0, 256, (3, image_size, image_size)).astype(np.uint8)
            else:
                urls.append([""])
                caps.append([""])
            id_list.append((pid, sid))
        pages.append(Page(
            page_id=pid,
            page_url=f"http://wiki/{pid}",
            page_title=_sentence(rng, 3),
            page_description=_sentence(rng, 10),
            section_title=[_sentence(rng, 2) for _ in range(n_sec)],
            section_depth=[0] * n_sec,
            section_heading=[1] * n_sec,
            section_parent_index=[max(-1, s - 1) for s in range(n_sec)],
            section_summary=[_sentence(rng, 8) for _ in range(n_sec)],
            section_rest_sentence=[_sentence(rng, 20) for _ in range(n_sec)],
            image_url=urls,
            image_caption=caps,
        ))

    def image_provider(page_id: int, section_id: int, page: Page):
        img = image_table.get((page_id, section_id))
        if img is None:
            return None, None
        return img, page.image_caption[section_id][0]

    return PageStore(pages), id_list, image_provider
