"""The yardstick's counts against hand arithmetic: allowed pairs under a
causal and a key mask, an attention launch's FLOPs and bytes, its bound
at the H100's peaks, and each family's model FLOPs of one micro-batch,
over its valid tokens, image slots and texts only."""

import numpy as np
import pytest

from benchmark import work


def test_allowed_pairs_causal_with_padding():
    # one sequence of 4 with the last key padded: rows see 1, 2, 3, 3 keys
    mask = np.array([[1, 1, 1, 0]])
    assert work.allowed_pairs(mask, causal=True) == 1 + 2 + 3 + 3
    # a model needs the valid queries' rows only
    assert work.allowed_pairs(mask, True, valid_queries=True) == 1 + 2 + 3


def test_allowed_pairs_key_mask_and_empty_row():
    # 2 of 3 keys valid: every row sees 2; an all-masked text sees all 3
    mask = np.array([[1, 1, 0], [0, 0, 0]])
    assert work.allowed_pairs(mask, causal=False) == 3 * 2 + 3 * 3
    assert work.allowed_pairs(mask, False, valid_queries=True) == 2 * 2


def test_attention_launch_flops_bytes_and_bound():
    launch = dict(kernel="attn_fwd", n=2, sq=128, sk=128, heads=4,
                  head_dim=64, pairs=1000.0)
    fwd = work.load("kernels", "attn_fwd")
    bwd = work.load("kernels", "attn_bwd")
    args = {k: v for k, v in launch.items() if k != "kernel"}
    assert fwd.flops(**args) == 4 * 1000 * 4 * 64
    assert fwd.nbytes(**args) == 4 * 2 * 128 * 4 * 64 * 2 + 2 * 128 * 4
    assert bwd.flops(**args) == 10 * 1000 * 4 * 64
    assert bwd.nbytes(**args) == 8 * 2 * 128 * 4 * 64 * 2 + 2 * 128 * 4
    # cross attention: q 16 rows, k/v 128; fwd reads q, k, v, writes o
    cross = dict(args, sq=16)
    assert fwd.nbytes(**cross) == 2 * (2 * 16 + 2 * 128) * 4 * 64 * 2 \
        + 2 * 128 * 4
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    # 1,024,000 FLOPs take 1.04 ns, 525,312 bytes 157 ns: bytes bound
    assert work.bound_s(launch, peak) == pytest.approx(525312 / 3.35e12)


CFG = dict(model=dict(hidden_size=8, ffn_dim=16, num_hidden_layers=1,
                      num_attention_heads=2, vocab_size=10,
                      word_embed_proj_dim=8),
           vision=dict(hidden_size=4, intermediate_size=8,
                       num_hidden_layers=1, num_attention_heads=2,
                       image_size=4, patch_size=2),
           text=dict(hidden_size=4, intermediate_size=8, num_hidden_layers=1,
                     num_attention_heads=2),
           parts=[dict(part="model", family="opt", trains=True)])


def test_opt_model_flops_of_a_micro_batch():
    settings = dict(neighbor_mode="raw", peft_type="none")
    # 2 valid tokens of 3; one next-token label (position 1 -> 2 is a pad)
    mb = dict(attention_mask=np.array([[1, 1, 0]]),
              labels=np.array([[5, 6, -100]]))
    got = work.load("families", "opt").flops(
        dict(part="model", trains=True), CFG, settings, mb)
    layer = 4 * 8 * 8 + 2 * 8 * 16          # q, k, v, out; fc1, fc2
    head = 10 * 8
    pairs = (1 + 2) * 2                     # valid causal rows, 2 heads
    assert got == 2 * 2 * layer * 3 + 2 * 1 * head * 3 + pairs * 4 * 12
    frozen = work.load("families", "opt").flops(
        dict(part="model", trains=False), CFG, settings, mb)
    assert frozen == 2 * 2 * layer * 2 + 2 * 1 * head * 2 + pairs * 4 * 12


def test_clip_vision_flops_count_valid_slots():
    settings = dict(n_visual_tokens=2)
    mb = dict(images_valid=np.array([[1, 0, 0]]))
    got = work.load("families", "clip_vision").flops(
        dict(part="vision"), CFG, settings, mb)
    s = 4 + 1                               # 2 x 2 patches and the class
    per_image = (2 * 4 * 3 * 2 * 2 * 4      # patch embedding
                 + 2 * s * (4 * 4 * 4 + 2 * 4 * 8)
                 + 4 * s * s * 4)           # attention, all pairs
    assert got == 1 * (per_image + 3 * 2 * 4 * 8 * 2)


def test_roberta_flops_count_valid_tokens():
    settings = dict(n_text_tokens=2)
    mb = dict(neighbor_attention_mask=np.array([[[1, 1, 0], [0, 0, 0]]]))
    got = work.load("families", "roberta").flops(
        dict(part="text"), CFG, settings, mb)
    layer = 4 * 4 * 4 + 2 * 4 * 8
    pairs = 2 * 2                           # one text of 2 valid tokens
    assert got == 2 * 2 * layer + 4 * pairs * 4 \
        + 1 * (2 * 4 * 4 + 3 * 2 * 4 * 8 * 2)
