"""Device step: the model FLOPs of the window's updates (each part's
family file, benchmark/families/, from each batch: the valid tokens,
image slots and texts only) over the window's seconds and the card's
published bf16 peak (benchmark/peaks.json), in percent."""


def read(ctx):
    peak = ctx["peak"].get("flops")
    if not peak or not ctx["updates"]:
        return None
    return 100.0 * sum(ctx["flops"]) / (ctx["window_s"] * peak)
