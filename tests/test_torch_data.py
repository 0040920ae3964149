"""The port's data layer (a copy of mmgl_tpu.data with its imports rewritten)
gives batches identical to the JAX package's, on the synthetic corpus."""

import numpy as np
import pytest

from mmgl_tpu.data.assemble import AssemblerConfig as JaxAssemblerConfig
from mmgl_tpu.data.assemble import WikiWeb2MAssembler as JaxAssembler
from mmgl_tpu.data.loader import PrefetchLoader as JaxLoader
from mmgl_tpu.data.synthetic import make_synthetic_corpus as jax_corpus
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch.data.assemble import AssemblerConfig, WikiWeb2MAssembler
from mmgl_tpu_torch.data.loader import PrefetchLoader
from mmgl_tpu_torch.data.synthetic import make_synthetic_corpus


def _assemblers(image_size=16, **cfg):
    tok = ByteTokenizer()
    store, ids, provider = make_synthetic_corpus(
        num_pages=6, image_size=image_size, seed=3)
    jstore, jids, jprovider = jax_corpus(num_pages=6, image_size=image_size,
                                         seed=3)
    assert ids == jids
    cfg.setdefault("max_input_length", 96)
    cfg.setdefault("max_output_length", 24)
    port = WikiWeb2MAssembler(AssemblerConfig(image_size=image_size, **cfg),
                              store, ids, tok, provider)
    ref = JaxAssembler(JaxAssemblerConfig(image_size=image_size, **cfg),
                       jstore, jids, tok, jprovider)
    return port, ref


def _assert_same_item(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("context", ["section_only", "section_all",
                                     "text_only", "all"])
def test_raw_items_identical(context):
    port, ref = _assemblers(context=context, neighbor_mode="raw")
    for i in range(len(port)):
        _assert_same_item(port[i], ref[i])


@pytest.mark.parametrize("position_type", ["none", "laplacian", "gnn"])
@pytest.mark.parametrize("decoder_only", [True, False])
def test_embedding_items_identical(position_type, decoder_only):
    port, ref = _assemblers(context="all", neighbor_mode="embedding",
                            position_type=position_type,
                            decoder_only=decoder_only,
                            max_text_neighbors=5, max_image_neighbors=3)
    for i in range(len(port)):
        _assert_same_item(port[i], ref[i])


def test_production_shaped_batches_identical():
    """The main path's shapes: 512 + 128 tokens, 1 + 5 image slots of
    224 px, batches of 4 through both loaders."""
    port, ref = _assemblers(image_size=224, context="all",
                            neighbor_mode="raw", max_input_length=512,
                            max_output_length=128)
    got = list(PrefetchLoader(port, batch_size=4, num_workers=2))
    want = list(JaxLoader(ref, batch_size=4, num_workers=2))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _assert_same_item(a, b)
    assert got[0]["images"].shape == (4, 6, 3, 224, 224)
    assert got[0]["input_ids"].shape == (4, 640)
