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
    assert profile_steps._kind("void attention_bwd_dkdv_kernel<__nv_"
                               "bfloat16>(...)") == "K3"
    assert profile_steps._kind("void attention_fwd_kernel<float>(...)") == (
        "K1+K2")
    assert profile_steps._kind("void at::native::vectorized_layer_norm_"
                               "kernel<c10::BFloat16, float>") == "layer_norm"
    assert profile_steps._kind("Memcpy HtoD (Pageable -> Device)") == (
        "copies and casts")


def test_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_steps.main(["--decode"])
