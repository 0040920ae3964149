"""The corpus a traffic mix describes, made from the run's seed.

A copy of the port's synthetic WikiWeb2M generator
(``mmgl_tpu_torch/data/synthetic.py``) with every length read from the
mix's file (``benchmark/traffic/<name>.json``) instead of fixed: pages of
the reference's 12-column structure, the (page, section) ids to train on,
and the images (uint8, channel first) with their captions. It returns
plain Python data (dicts, lists and numpy arrays), which the benchmark
hands to the program's assembler and to the plain reference alike.

Keys of a mix's ``corpus`` group, each a [low, high] range drawn uniformly
per item, inclusive:
  pages             number of pages (one int, not a range)
  sections          sections a page
  title_words, description_words, summary_words, rest_words, caption_words
  image_prob        share of sections with an image (one float)
  image_size        side of the square images (one int)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

WORDS = ("graph learning neighbor section wikipedia summary image caption "
         "model multimodal context page title heading content text token "
         "attention layer encoder decoder neural network training data").split()


def _sentence(rng: np.random.RandomState, span) -> str:
    n = int(rng.randint(span[0], span[1] + 1))
    return " ".join(rng.choice(WORDS, size=n))


def make_corpus(corpus: Dict, seed: int) -> Tuple[List[Dict],
                                                  List[Tuple[int, int]],
                                                  Dict[Tuple[int, int],
                                                       Tuple[np.ndarray, str]]]:
    """(pages, ids, images): ``pages`` a list of dicts with the 12 columns,
    ``ids`` every (page_id, section_id), ``images`` {(page_id,
    section_id): (uint8 (3, S, S), caption)}. The same (corpus, seed) give
    the same data."""
    rng = np.random.RandomState(seed % 2**32)
    size = int(corpus["image_size"])
    pages, ids, images = [], [], {}
    for pid in range(int(corpus["pages"])):
        n_sec = int(rng.randint(corpus["sections"][0],
                                corpus["sections"][1] + 1))
        urls, caps = [], []
        for sid in range(n_sec):
            if rng.uniform() < corpus["image_prob"]:
                cap = _sentence(rng, corpus["caption_words"])
                urls.append([f"http://img/{pid}_{sid}.jpg"])
                caps.append([cap])
                images[(pid, sid)] = (
                    rng.randint(0, 256, (3, size, size)).astype(np.uint8),
                    cap)
            else:
                urls.append([""])
                caps.append([""])
            ids.append((pid, sid))
        pages.append(dict(
            page_id=pid,
            page_url=f"http://wiki/{pid}",
            page_title=_sentence(rng, corpus["title_words"]),
            page_description=_sentence(rng, corpus["description_words"]),
            section_title=[_sentence(rng, corpus["title_words"])
                           for _ in range(n_sec)],
            section_depth=[0] * n_sec,
            section_heading=[1] * n_sec,
            section_parent_index=[max(-1, s - 1) for s in range(n_sec)],
            section_summary=[_sentence(rng, corpus["summary_words"])
                             for _ in range(n_sec)],
            section_rest_sentence=[_sentence(rng, corpus["rest_words"])
                                   for _ in range(n_sec)],
            image_url=urls,
            image_caption=caps,
        ))
    return pages, ids, images
