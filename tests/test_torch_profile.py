"""mmgl_tpu_torch.profile_steps on the CPU: its interval arithmetic, and no
run without a card."""

import pytest
import torch

from mmgl_tpu_torch import profile_steps


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(5.0, 7.0), (0.0, 2.0)], 4.0),              # apart, unsorted
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 6.0)], 6.0),  # nested and overlapping
    ([(0.0, 1.0), (1.0, 3.0)], 3.0),              # touching
])
def test_busy_is_the_union_of_intervals(intervals, want):
    assert profile_steps.busy_us(intervals) == want


def test_kernel_kinds():
    # K4 and K5 run in K1's and K3's sources; K6 in K3's tile kernels and
    # its own delta pass
    assert profile_steps._kind("void attention_bwd_dkdv_kernel<__nv_"
                               "bfloat16>(...)") == "K3+K5+K6"
    assert profile_steps._kind("void (anonymous namespace)::attention_delta_"
                               "kernel<float>(...)") == "K3+K5+K6"
    assert profile_steps._kind("void attention_fwd_kernel<float>(...)") == (
        "K1+K2+K4")
    assert profile_steps._kind("void (anonymous namespace)::attention_bias_"
                               "fwd_kernel<__nv_bfloat16, float>") == "K7"
    for name in ("stats", "dkdv", "dq", "reduce"):
        assert profile_steps._kind(f"void (anonymous namespace)::bias_bwd_"
                                   f"{name}_kernel<float>") == "K8/K9"
    assert profile_steps._kind("void at::native::vectorized_layer_norm_"
                               "kernel<c10::BFloat16, float>") == "layer_norm"
    assert profile_steps._kind("Memcpy HtoD (Pageable -> Device)") == (
        "copies and casts")


@pytest.mark.parametrize("name,kind", [
    # K4 and K5's stats pass: no bias, no dropout
    ("attention_fwd_tc_kernel<64, false, 4, 2, 3, false, false, "
     "__nv_bfloat16>", "K1+K2+K4"),
    ("attention_fwd_tc_kernel<64, true, 4, 2, 3, false, false, "
     "__nv_bfloat16>", "K1+K2+K4"),
    ("attention_bwd_dkdv_tc_kernel<64, 4, 2, 3, false, false, "
     "__nv_bfloat16>", "K3+K5+K6"),
    # K7 with its bias, or dropout alone (the training cross-attention)
    ("attention_fwd_tc_kernel<64, false, 4, 2, 3, true, true, "
     "__nv_bfloat16>", "K7"),
    ("attention_fwd_tc_kernel<64, false, 4, 2, 3, false, true, "
     "__nv_bfloat16>", "K7"),
    # K8/K9: the stats-only pass with the bias, and the tile bodies
    ("attention_fwd_tc_kernel<64, true, 4, 2, 3, true, false, float>",
     "K8/K9"),
    ("attention_bwd_dq_tc_kernel<64, 4, 2, 3, false, true, "
     "__nv_bfloat16>", "K8/K9"),
    ("attention_bwd_dkdv_tc_kernel<64, 4, 2, 3, true, true, "
     "__nv_bfloat16>", "K8/K9"),
    # with the element type last (bf16 or fp16)
    ("attention_fwd_tc_kernel<64, false, 4, 2, 3, false, false, __half, "
     "__half>", "K1+K2+K4"),
    ("attention_fwd_tc_kernel<64, false, 4, 2, 3, true, false, float, "
     "__half>", "K7"),
    ("attention_fwd_tc_kernel<64, true, 4, 2, 3, true, false, "
     "__nv_bfloat16, __nv_bfloat16>", "K8/K9"),
    ("attention_bwd_dq_tc_kernel<64, 4, 2, 3, false, false, __half, "
     "__half>", "K3+K5+K6"),
    ("attention_bwd_dkdv_tc_kernel<64, 4, 2, 3, true, false, float, "
     "__half>", "K8/K9"),
])
def test_tensor_core_body_kinds(name, kind):
    """The tensor-core bodies are told apart by their template flags: the
    bias form (kBias or kDropout) is K7's forward and K8/K9's backward."""
    assert profile_steps._kind(f"void mmgl::{name}(__nv_bfloat16 const*, "
                               f"int, mmgl::BiasArgs<float>)") == kind


@pytest.mark.parametrize("name,kind", [
    # K1 and K4, and the stats passes of K3 and K5 (stats-only)
    ("wg::allheads_fwd_kernel<64, false, mmgl::wg::Shape<1, 64, 2, 2, "
     "false>, __nv_bfloat16, false, false, __nv_bfloat16>", "K1+K2+K4"),
    ("wg::allheads_fwd_kernel<128, true, mmgl::wg::Shape<1, 64, 2, 2, "
     "false>, __half, false, false, __half>", "K3+K5+K6"),
    # K7 in its bias form (the bias, or dropout alone), and K8/K9's stats
    # pass
    ("wg::allheads_fwd_kernel<64, false, mmgl::wg::Shape<1, 64, 2, 2, "
     "false>, __nv_bfloat16, true, true, float>", "K7"),
    ("wg::allheads_fwd_kernel<64, false, mmgl::wg::Shape<1, 64, 2, 2, "
     "false>, __half, false, true, __half>", "K7"),
    ("wg::allheads_fwd_kernel<64, true, mmgl::wg::Shape<1, 64, 2, 2, "
     "false>, __nv_bfloat16, true, false, __nv_bfloat16>", "K8/K9"),
    # K3's dK/dV and dQ
    ("wg::allheads_dkdv_kernel<80, mmgl::wg::Shape<1, 64, 2, 1, false>, "
     "__nv_bfloat16>", "K3+K5+K6"),
    ("wg::allheads_dq_kernel<64, mmgl::wg::Shape<1, 64, 2, 3, false>, "
     "__half>", "K3+K5+K6"),
    # K8/K9: the same bodies in their bias form (the bias, or dropout
    # alone); with both flags off they are K3's
    ("wg::allheads_dq_kernel<64, mmgl::wg::Shape<1, 64, 2, 3>, "
     "__nv_bfloat16, true, true, __nv_bfloat16>", "K8/K9"),
    ("wg::allheads_dkdv_kernel<64, mmgl::wg::Shape<1, 64, 2, 2>, __half, "
     "false, true, __half>", "K8/K9"),
    ("wg::allheads_dkdv_kernel<64, mmgl::wg::Shape<1, 64, 2, 2>, "
     "__nv_bfloat16, true, false, float>", "K8/K9"),
    ("wg::allheads_dq_kernel<64, mmgl::wg::Shape<1, 64, 2, 3>, "
     "__nv_bfloat16, false, false, __nv_bfloat16>", "K3+K5+K6"),
    # K8/K9's library launch: both bodies in one grid
    ("wg::allheads_dq_dkdv_kernel<64, mmgl::wg::Shape<1, 64, 2, 2>, "
     "mmgl::wg::Shape<1, 64, 2, 2>, __nv_bfloat16, true, true, "
     "__nv_bfloat16>", "K8/K9"),
    # K5's at T5's cross-attention: the same grid without the bias form
    ("wg::allheads_dq_dkdv_kernel<64, mmgl::wg::Shape<1, 64, 2, 2>, "
     "mmgl::wg::Shape<1, 64, 2, 2>, __half, false, false, __half>",
     "K3+K5+K6"),
])
def test_wgmma_body_kinds(name, kind):
    """The wgmma bodies are told apart by their template flags: stats-only
    forms are the backward's stats passes, the bias form (kBias or
    kDropout) K7's forward, K8/K9's stats pass and K8/K9's dK/dV and dQ."""
    assert profile_steps._kind(f"void mmgl::{name}(CUtensorMap_st, "
                               f"int, mmgl::BiasArgs<float>)") == kind


def test_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_steps.main(["--decode"])
