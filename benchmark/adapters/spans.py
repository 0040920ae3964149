"""The program side of the span readers: the port's own spans and counters
of the profiled updates (``mmgl_tpu_torch/utils/spans.py``'s ``drain``),
or None where the program records none (a tree without the recorder)."""


def drain():
    try:
        from mmgl_tpu_torch.utils import spans as recorder
    except ImportError:
        return None
    return recorder.drain()
