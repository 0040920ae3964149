"""Page store with O(1) page lookup.

Fixes the reference's biggest input-pipeline sin (SURVEY Q9): a full
dataframe scan `df[df['page_id'] == page_id]` per sample
(wikiweb2m/data.py:171,316). Here pages live in a dict keyed by page_id.

A page record mirrors the reference's 12 parquet columns
(preprocess_data.py:116-145); byte values are decoded to str once at load.

Copy of mmgl_tpu/data/store.py for the PyTorch port, with its imports
rewritten to the port: the JAX package's data layer reaches flax through
models/graph.py, and the port imports no JAX. The code is otherwise
unchanged, so the two produce identical batches.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass
class Page:
    page_id: int
    page_url: str = ""
    page_title: str = ""
    page_description: str = ""
    section_title: List[str] = field(default_factory=list)
    section_depth: List[int] = field(default_factory=list)
    section_heading: List[int] = field(default_factory=list)
    section_parent_index: List[int] = field(default_factory=list)
    section_summary: List[str] = field(default_factory=list)
    section_rest_sentence: List[str] = field(default_factory=list)
    # per-section lists of image urls / captions (reference reshapes flat
    # arrays to (num_sections, -1), data.py:129-131)
    image_url: List[List[str]] = field(default_factory=list)
    image_caption: List[List[str]] = field(default_factory=list)

    @property
    def num_sections(self) -> int:
        return len(self.section_title)


class PageStore:
    def __init__(self, pages: Sequence[Page]):
        self._index: Dict[int, Page] = {p.page_id: p for p in pages}

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, page_id) -> bool:
        return page_id in self._index

    def get(self, page_id: int) -> Page:
        return self._index[page_id]


def _dec(x) -> str:
    if isinstance(x, bytes):
        return x.decode()
    return str(x)


def pages_from_dataframe(df) -> PageStore:
    """pandas DataFrame (reference parquet schema) -> PageStore."""
    pages = []
    for row in df.itertuples(index=False):
        n = len(row.section_title)
        img_urls = [list(map(_dec, u)) for u in
                    _reshape_per_section(row.image_url, n)]
        img_caps = [list(map(_dec, c)) for c in
                    _reshape_per_section(row.image_caption, n)]
        pages.append(Page(
            page_id=int(row.page_id),
            page_url=_dec(row.page_url),
            page_title=_dec(row.page_title),
            page_description=_dec(row.page_description),
            section_title=[_dec(t) for t in row.section_title],
            section_depth=[int(d) for d in row.section_depth],
            section_heading=[int(h) for h in row.section_heading],
            section_parent_index=[int(i) for i in row.section_parent_index],
            section_summary=[_dec(s) for s in row.section_summary],
            section_rest_sentence=[_dec(s) for s in row.section_rest_sentence],
            image_url=img_urls,
            image_caption=img_caps,
        ))
    return PageStore(pages)


def _reshape_per_section(flat, num_sections: int):
    flat = list(flat)
    if num_sections == 0:
        return []
    per = max(1, len(flat) // num_sections)
    return [flat[i * per : (i + 1) * per] for i in range(num_sections)]


def load_wikiweb2m(task: str, data_dir: str) -> Tuple[PageStore, PageStore,
                                                      PageStore, dict]:
    """Load the three parquet splits + id pickle (parity with
    wikiweb2m/data.py:13-31), returning O(1) stores."""
    import pandas as pd

    stores = []
    for split in ("train", "val", "test"):
        df = pd.read_parquet(
            os.path.join(data_dir, f"wikiweb2m_{split}_large.parquet"))
        stores.append(pages_from_dataframe(df))
    with open(os.path.join(data_dir, f"{task}_id_split_large.pkl"), "rb") as f:
        id_list = pickle.load(f)
    return stores[0], stores[1], stores[2], id_list
