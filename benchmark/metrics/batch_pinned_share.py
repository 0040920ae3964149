"""Loop and loader: the share, in %, of the batch's bytes copied to the
card from page-locked memory without a wait (the program's
``batch_copy_pinned`` counter) of all it copied there, pinned and
pageable (``batch_copy_pageable``), over the profiled updates; None
where the program counted neither."""

from benchmark.spans import counted_mb


def read(ctx):
    pinned = counted_mb(ctx, "batch_copy_pinned")
    if pinned is None:
        return None
    total = pinned + counted_mb(ctx, "batch_copy_pageable")
    return None if total == 0 else 100.0 * pinned / total
