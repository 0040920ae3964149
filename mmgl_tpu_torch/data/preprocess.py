"""Offline WikiWeb2M ETL — counterpart of wikiweb2m/preprocess_data.py.

tfrecord -> parquet + id-split pickle + image download. TensorFlow is only
needed here (gated import); the training stack never touches it.

Parity notes:
  * context/sequence feature schema (preprocess_data.py:68-105)
  * split: is_section_summarization_sample filter, first 600K pages ->
    400/100/100K by page index (:147-181)
  * parquet columns: the 12-column page frame (:116-145)
  * images: first downloadable+openable image per section, UA header,
    404 skip, 1s retry on busy, corrupted-image delete (:183-233)
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict


class DataParser:
    def __init__(self, path: str = "./wikiweb2m/raw/",
                 filepath: str = "wikiweb2m-*", suffix: str = ".tfrecord*"):
        self.path = path
        self.filepath = filepath
        self.suffix = suffix
        self.data: Dict[str, list] = {}

    # ---- tfrecord parsing (preprocess_data.py:56-114) ----

    def parse_data(self):
        import tensorflow.compat.v1 as tf

        context_feature_description = {
            "split": tf.io.FixedLenFeature([], dtype=tf.string),
            "page_title": tf.io.FixedLenFeature([], dtype=tf.string),
            "page_url": tf.io.FixedLenFeature([], dtype=tf.string),
            "clean_page_description": tf.io.FixedLenFeature([], dtype=tf.string),
            "raw_page_description": tf.io.FixedLenFeature([], dtype=tf.string),
            "is_page_description_sample": tf.io.FixedLenFeature([], dtype=tf.int64),
            "page_contains_images": tf.io.FixedLenFeature([], dtype=tf.int64),
            "page_content_sections_without_table_list":
                tf.io.FixedLenFeature([], dtype=tf.int64),
        }
        sequence_feature_description = {
            "is_section_summarization_sample":
                tf.io.VarLenFeature(dtype=tf.int64),
            "section_title": tf.io.VarLenFeature(dtype=tf.string),
            "section_index": tf.io.VarLenFeature(dtype=tf.int64),
            "section_depth": tf.io.VarLenFeature(dtype=tf.int64),
            "section_heading_level": tf.io.VarLenFeature(dtype=tf.int64),
            "section_subsection_index": tf.io.VarLenFeature(dtype=tf.int64),
            "section_parent_index": tf.io.VarLenFeature(dtype=tf.int64),
            "section_text": tf.io.VarLenFeature(dtype=tf.string),
            "section_clean_1st_sentence": tf.io.VarLenFeature(dtype=tf.string),
            "section_raw_1st_sentence": tf.io.VarLenFeature(dtype=tf.string),
            "section_rest_sentence": tf.io.VarLenFeature(dtype=tf.string),
            "is_image_in_section": tf.io.VarLenFeature(dtype=tf.int64),
            "section_image_url": tf.io.VarLenFeature(dtype=tf.string),
            "section_image_mime_type": tf.io.VarLenFeature(dtype=tf.string),
            "section_image_width": tf.io.VarLenFeature(dtype=tf.int64),
            "section_image_height": tf.io.VarLenFeature(dtype=tf.int64),
            "section_image_in_wit": tf.io.VarLenFeature(dtype=tf.int64),
            "section_contains_table_or_list":
                tf.io.VarLenFeature(dtype=tf.int64),
            "section_image_captions": tf.io.VarLenFeature(dtype=tf.string),
            "section_image_alt_text": tf.io.VarLenFeature(dtype=tf.string),
            "section_image_raw_attr_desc": tf.io.VarLenFeature(dtype=tf.string),
            "section_image_clean_attr_desc":
                tf.io.VarLenFeature(dtype=tf.string),
            "section_image_raw_ref_desc": tf.io.VarLenFeature(dtype=tf.string),
            "section_image_clean_ref_desc":
                tf.io.VarLenFeature(dtype=tf.string),
            "section_contains_images": tf.io.VarLenFeature(dtype=tf.int64),
        }

        def _parse(example_proto):
            return tf.io.parse_single_sequence_example(
                example_proto,
                context_features=context_feature_description,
                sequence_features=sequence_feature_description)

        glob = os.path.join(self.path, self.filepath + self.suffix)
        ds = tf.data.TFRecordDataset(tf.io.gfile.glob(glob),
                                     compression_type="GZIP")
        self.dataset = ds.map(_parse)

    @staticmethod
    def _sparse_to_list(sparse, tf):
        dense = tf.sparse.to_dense(sparse).numpy()
        if dense.ndim == 2:
            # sequence VarLen parses as (steps, max_values); the reference
            # flattens before materializing (preprocess_data.py:27-29)
            dense = dense.reshape(-1)
        return dense.tolist()

    # ---- splits (preprocess_data.py:147-181) ----

    def split_ids(self, task: str = "section", max_pages: int = 600_000,
                  train_pages: int = 400_000, val_pages: int = 100_000):
        import tensorflow.compat.v1 as tf

        id_list = {"train": [], "val": [], "test": []}
        for page_id, (context, sequence) in enumerate(self.dataset):
            if page_id >= max_pages:
                break
            flags = self._sparse_to_list(
                sequence["is_section_summarization_sample"], tf)
            if page_id < train_pages:
                split = "train"
            elif page_id < train_pages + val_pages:
                split = "val"
            else:
                split = "test"
            for section_id, flag in enumerate(flags):
                if flag == 1:
                    id_list[split].append((page_id, section_id))
        out = os.path.join(self.path, f"{task}_id_split_large.pkl")
        with open(out, "wb") as f:
            pickle.dump(id_list, f)
        return id_list

    # ---- parquet materialization (preprocess_data.py:116-145) ----

    def save_parquet(self, max_pages: int = 600_000,
                     train_pages: int = 400_000, val_pages: int = 100_000):
        import pandas as pd
        import tensorflow.compat.v1 as tf

        columns = ["page_id", "page_url", "page_title", "page_description",
                   "section_title", "section_depth", "section_heading",
                   "section_parent_index", "section_summary",
                   "section_rest_sentence", "image_url", "image_caption"]
        rows = {"train": [], "val": [], "test": []}
        for page_id, (context, sequence) in enumerate(self.dataset):
            if page_id >= max_pages:
                break
            split = ("train" if page_id < train_pages else
                     "val" if page_id < train_pages + val_pages else "test")
            rows[split].append([
                page_id,
                context["page_url"].numpy(),
                context["page_title"].numpy(),
                context["clean_page_description"].numpy(),
                self._sparse_to_list(sequence["section_title"], tf),
                self._sparse_to_list(sequence["section_depth"], tf),
                self._sparse_to_list(sequence["section_heading_level"], tf),
                self._sparse_to_list(sequence["section_parent_index"], tf),
                self._sparse_to_list(sequence["section_clean_1st_sentence"],
                                     tf),
                self._sparse_to_list(sequence["section_rest_sentence"], tf),
                self._sparse_to_list(sequence["section_image_url"], tf),
                self._sparse_to_list(sequence["section_image_captions"], tf),
            ])
        for split, data in rows.items():
            df = pd.DataFrame(data, columns=columns)
            df.to_parquet(os.path.join(
                self.path, f"wikiweb2m_{split}_large.parquet"))

    # ---- image download (preprocess_data.py:183-233) ----

    def download_images(self, image_dir: str = None, timeout: float = 10.0):
        import requests
        from PIL import Image

        image_dir = image_dir or os.path.join(self.path, "images")
        os.makedirs(image_dir, exist_ok=True)
        headers = {"User-Agent":
                   "Mozilla/5.0 (research; WikiWeb2M image fetch)"}
        import tensorflow.compat.v1 as tf

        for page_id, (context, sequence) in enumerate(self.dataset):
            urls = self._sparse_to_list(sequence["section_image_url"], tf)
            for section_id, url in enumerate(urls):
                url = url.decode() if isinstance(url, bytes) else url
                if not url:
                    continue
                ext = os.path.splitext(url)[1][1:]
                fname = os.path.join(image_dir,
                                     f"{page_id}_{section_id}_0.{ext}")
                if os.path.exists(fname):
                    continue
                try:
                    r = requests.get(url, headers=headers, timeout=timeout)
                    if r.status_code == 404:
                        continue
                    if r.status_code != 200:
                        time.sleep(1.0)  # busy: retry-after-1s (:206-218)
                        r = requests.get(url, headers=headers, timeout=timeout)
                        if r.status_code != 200:
                            continue
                    with open(fname, "wb") as f:
                        f.write(r.content)
                    Image.open(fname).verify()  # validity check
                except Exception:
                    if os.path.exists(fname):
                        os.remove(fname)  # corrupted-image delete (:223-230)
                    continue


def main():
    parser = DataParser()
    parser.parse_data()
    parser.split_ids("section")
    parser.save_parquet()
    parser.download_images()


if __name__ == "__main__":
    main()
