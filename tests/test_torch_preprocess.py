"""The port's copy of the offline ETL (mmgl_tpu_torch/data/preprocess.py)
writes what the JAX package's module writes, on tests/test_etl.py's
synthetic GZIP SequenceExample tfrecords and its stand-in downloader.
(tests/test_torch_imports.py holds the copy to the original's text.)"""

import io
import os
import pickle
import shutil
import types

import pytest

pytest.importorskip("tensorflow")
pd = pytest.importorskip("pandas")

from mmgl_tpu.data import preprocess as jax_pp  # noqa: E402
from mmgl_tpu_torch.data import preprocess as port_pp  # noqa: E402
from test_etl import _page_example, tf  # noqa: E402

MODULES = {"jax": jax_pp, "port": port_pp}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """4 pages (3, 2, 2 and 1 sections) in one GZIP tfrecord."""
    root = tmp_path_factory.mktemp("tfrecords")
    opts = tf.io.TFRecordOptions(compression_type="GZIP")
    with tf.io.TFRecordWriter(str(root / "wikiweb2m-test.tfrecord.gz"),
                              opts) as w:
        for pid, n_sec in enumerate((3, 2, 2, 1)):
            w.write(_page_example(pid, n_sec).SerializeToString())
    return root


def _etl(module, records, out):
    """The module's parse, id split and parquet over a copy of the
    records in ``out``."""
    shutil.copytree(records, out)
    parser = module.DataParser(path=str(out) + "/")
    parser.parse_data()
    ids = parser.split_ids("section", max_pages=4, train_pages=2,
                           val_pages=1)
    parser.save_parquet(max_pages=4, train_pages=2, val_pages=1)
    return parser, ids


def test_split_and_parquet_are_the_jax_modules(records, tmp_path):
    """The id-split pickle (bytes and value) and the three parquet frames
    are the JAX module's."""
    got = {name: _etl(m, records, tmp_path / name)[1]
           for name, m in MODULES.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["train"] == [(0, 0), (0, 1), (1, 0)]
    pkl = "section_id_split_large.pkl"
    blobs = {name: (tmp_path / name / pkl).read_bytes() for name in MODULES}
    assert blobs["port"] == blobs["jax"]
    assert pickle.loads(blobs["port"]) == got["jax"]
    for split in ("train", "val", "test"):
        name = f"wikiweb2m_{split}_large.parquet"
        frames = {m: pd.read_parquet(tmp_path / m / name) for m in MODULES}
        pd.testing.assert_frame_equal(frames["port"], frames["jax"])
        assert len(frames["port"]) == {"train": 2, "val": 1, "test": 1}[split]


def test_image_download_is_the_jax_modules(records, tmp_path, monkeypatch):
    """The download loop under tests/test_etl.py's stand-in server (a
    JPEG, a 404, a busy answer then the JPEG, corrupt bytes): the same
    files with the same bytes, the same requests and backoffs, and a
    second pass that fetches nothing."""
    from PIL import Image

    import requests

    buf = io.BytesIO()
    Image.new("RGB", (4, 4), (10, 20, 30)).save(buf, format="JPEG")
    jpeg = buf.getvalue()
    log = {}

    def server(calls):
        def get(url, headers=None, timeout=None):
            calls.append(url)
            assert "User-Agent" in headers
            r = types.SimpleNamespace(status_code=404, content=b"")
            if "0_0" in url:
                r.status_code, r.content = 200, jpeg
            elif "0_2" in url:
                busy = sum("0_2" in c for c in calls) == 1
                r.status_code, r.content = (429 if busy else 200), jpeg
            elif "1_0" in url:
                r.status_code, r.content = 200, b"not an image"
            return r
        return get

    for name, module in MODULES.items():
        calls, slept = [], []
        monkeypatch.setattr(requests, "get", server(calls))
        monkeypatch.setattr(module.time, "sleep", slept.append)
        parser, _ = _etl(module, records, tmp_path / name)
        images = tmp_path / name / "images"
        parser.download_images(image_dir=str(images))
        first = len(calls)
        parser.download_images(image_dir=str(images))
        log[name] = {
            "files": {f: (images / f).read_bytes()
                      for f in sorted(os.listdir(images))},
            "calls": calls[:first], "again": calls[first:], "slept": slept}
    assert log["port"] == log["jax"]
    assert sorted(log["port"]["files"]) == ["0_0_0.jpg", "0_2_0.jpg"]
    assert log["port"]["slept"] == [1.0]
    assert not any("0_0" in c or "0_2" in c for c in log["port"]["again"])
