"""An attention backward launch (K3, K5, K6): the logits recomputed, then
dV, dP, dQ and dK, 10 x D FLOPs a pair and head; q, k, v, the output and
its gradient read and dq, dk and dv written once in bf16, the int32 key
mask read once. ``WRAPPERS``: the port's wrappers whose launch counters
it stands for; ``KIND``: its kernels' kind in the trace."""

WRAPPERS = ("flash_attention_allheads_bwd", "flash_attention_bwd",
            "flash_attention_blocked_bwd")
KIND = "K3+K5+K6"


def flops(n, sq, sk, heads, head_dim, pairs):
    return 10.0 * pairs * heads * head_dim


def nbytes(n, sq, sk, heads, head_dim, pairs):
    # read q, o, do and k, v; write dq and dk, dv
    return 2.0 * n * (4 * sq + 4 * sk) * heads * head_dim + n * sk * 4
