"""Device step: the share of the profiled sub-window's wall in which no
kernel or copy ran on the device, in percent."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.wall_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
