"""Console/observability meters.

TPU-native counterpart of the reference's AverageMeter/ProgressMeter
(language_modelling/utils.py:66-137). Cross-device reduction happens inside
the jitted step via jax.lax.psum (parallel/mesh.py) rather than an explicit
NCCL all_reduce on host tensors, so `all_reduce` here merges values that were
already summed across the mesh (a no-op fold kept for API familiarity).
"""

from __future__ import annotations

from enum import Enum


class Summary(Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def all_reduce(self):
        # metric sums are already psum'd on-device in the step fn; keep the
        # reference surface without a host-side collective.
        if self.count:
            self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)

    def summary(self):
        if self.summary_type is Summary.NONE:
            return ""
        if self.summary_type is Summary.AVERAGE:
            return f"{self.name} {self.avg:.3f}"
        if self.summary_type is Summary.SUM:
            return f"{self.name} {self.sum:.3f}"
        if self.summary_type is Summary.COUNT:
            return f"{self.name} {self.count:.3f}"
        raise ValueError(f"invalid summary type {self.summary_type!r}")


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        num_digits = len(str(num_batches))
        fmt = "{:" + str(num_digits) + "d}"
        self.batch_fmtstr = "[" + fmt + "/" + fmt.format(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))

    def display_summary(self):
        entries = [" *"] + [m.summary() for m in self.meters]
        print(" ".join(entries))
