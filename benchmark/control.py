"""The readings the check's limits are set from, on the card at the cell's
size; not part of a benchmark run.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \\
        [--controls 11,12,13] [--out chiprun_out/control.jsonl]

For each seed: the port's training loop is built and runs its first
updates, as in a run (no window follows), then the plain reference works
them out in float32 and the check's numbers are read (``program``). For
the seeds in ``--controls`` it also reads the numbers of the control, the
reference in the program's place computed with its products' operands
rounded to float8 e4m3 (one step below the configuration's bfloat16),
and of three planted faults, each the reference in the program's place:
"half of each micro-batch left out, the mean over the rest" (``half``),
"no weight decay" (``no_decay``) and "beta2 0.999 for the
configuration's" (``beta2``); the last two read ``optim_diff`` 1, as the
program's optimizer set so would. A state left unchanged reads 1 on
``change_gap`` by that number's definition and needs no run. One JSON
line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    cell = run.load_cell(a.workload)
    run._environment()
    import torch

    from benchmark import check
    from benchmark.reference import model as ref_model
    from benchmark.reference import train as reference
    from benchmark import weights

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = {int(s) for s in a.controls.split(",") if s}
    out = Path(a.out) if a.out else None
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        prog, corpus, readings = run.setup_program(cell, seed, device)
        prog.close()
        del prog
        run.free(device)
        numbers, ref = run.reference_check(cell, seed, device, corpus,
                                           readings)
        line = dict(workload=a.workload, seed=seed, program=numbers)
        if seed in controls:
            batches = readings["reference_batches"]
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            settings = cell["settings"]
            for name, changed, kw in (
                    ("control_fp8", {},
                     dict(prec=ref_model.Precision(fp8=True))),
                    ("fault_half", {}, dict(half=True)),
                    ("fault_no_decay", dict(weight_decay=0.0), {}),
                    ("fault_beta2", dict(adam_beta2=0.999), {})):
                other = reference.run(cell["cfg"], dict(settings, **changed),
                                      weights.make_weights(cell["cfg"],
                                                           settings, seed,
                                                           device),
                                      batches, seed, device, **kw)
                line[name] = check.numbers(
                    check.as_readings(other, batches, float(len(changed))),
                    ref)
                del other
                run.free(device)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            with out.open("a") as f:
                f.write(text + "\n")
        run.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
