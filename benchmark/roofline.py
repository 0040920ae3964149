"""A kernel file's share of its roofline over the profiled updates: the
summed least time of its launches over the device time the trace gives
its kind. The launches come from the configuration's families (a family's
``launches`` for each micro-batch of the profiled updates); the program's
launch counters of the kernel's wrappers are printed beside them for a
reader to compare."""

import sys

from benchmark import work


def share(ctx, kernel):
    tr, peak = ctx.get("trace"), ctx.get("peak")
    if tr is None or not peak:
        return None
    launches = [x for update in ctx["traced_launches"] for x in update
                if x["kernel"] == kernel]
    k = work.load("kernels", kernel)
    seconds = tr.seconds_by_kind().get(k.KIND)
    if not launches or not seconds:
        return None
    counted = sum(ctx["counted_launches"].get(w, 0) for w in k.WRAPPERS)
    if counted != len(launches):
        print(f"{kernel}: {len(launches)} launches from the configuration, "
              f"{counted} counted by the program", file=sys.stderr)
    bound = sum(work.bound_s(x, peak) for x in launches)
    return 100.0 * bound / seconds
