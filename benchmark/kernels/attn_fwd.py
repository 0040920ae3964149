"""An attention forward launch (K1, K2, K4): QK^T and PV over the
allowed pairs, 2 x 2 x D FLOPs a pair and head; q, k and v read and the
output written once in bf16, the int32 key mask read once. ``WRAPPERS``:
the port's wrappers whose launch counters it stands for; ``KIND``: its
kernels' kind in the trace (benchmark/trace.py)."""

WRAPPERS = ("flash_attention_allheads", "fused_heads_attention",
            "flash_attention")
KIND = "K1+K2+K4"


def flops(n, sq, sk, heads, head_dim, pairs):
    return 4.0 * pairs * heads * head_dim


def nbytes(n, sq, sk, heads, head_dim, pairs):
    return 2.0 * n * (2 * sq + 2 * sk) * heads * head_dim + n * sk * 4
