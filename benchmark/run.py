"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A run builds the cell's configuration (``benchmark/configs/``), makes the
corpus of its traffic mix (``benchmark/traffic/``) and the weights from
the seed, builds the port's training loop (``benchmark/program.py``),
runs its first updates as set-up (they build and warm every kernel of the
cell's fixed shapes, and are the updates the check compares), then
measures the loop for ``--seconds``: each update is the next batch of the
port's loader and the port's update, issued as soon as the one before is,
the loss read at ``print_freq``; the window starts and ends at a device
synchronize. ``--trace 1`` also profiles a few updates after the window
and reports the per-layer metrics in place of the end-to-end ones. Once
the window has closed, the peak memory has been read and the program is
freed, the plain reference (``benchmark/reference/``) works the first
updates out again and the check (``benchmark/check.py``) decides
``correct``. The last line of standard output is the result, as JSON.

A run needs a CUDA card (none: exit 2, no result); it exits 3, with no
result, if JAX or the JAX package is loaded. Builds and kernel caches stay
in ``build/`` inside the checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mmgl_tpu")
CHECK_UPDATES = 3


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (Linux)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_IMPORTED = time.perf_counter()
_AGE_AT_IMPORT = process_age_s() or 0.0


def since_start() -> float:
    return _AGE_AT_IMPORT + time.perf_counter() - _IMPORTED


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# The cell, by name
# ---------------------------------------------------------------------------

def load_cell(name: str, root: Path = ROOT.parent) -> Dict:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its
    configuration, traffic mix, check settings, metrics and readers."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (here / "traffic" / f"{cell['traffic']}.json").read_text())
    check = json.loads((here / "workloads" / f"{name}.json").read_text())
    settings = dict(cfg["settings"], **traffic["settings"],
                    image_size=traffic["corpus"]["image_size"])

    def mine(metric):
        return name in metric.get("workloads", [name])

    return dict(name=name, chips=cell["chips"], cfg=cfg, traffic=traffic,
                check=check, settings=settings, root=root,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def corpus_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 2]).generate_state(
        1, np.uint32)[0])


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_updates(prog, cfg: Dict, settings: Dict, n: int) -> Dict:
    """The first ``n`` updates, read as the check needs them: the
    batches, each tower's pooled outputs in the first update, each
    update's loss, the first gradient's norms, each trainable leaf's
    change, and how far the optimizer departs from the configuration."""
    import torch

    from benchmark import work

    optim = work.load("optimizers", cfg["optimizer"])
    start = {name: p.detach().clone() for name, p in prog.trainable()}
    tower: Dict[str, List] = {}
    hooks = []
    for part in cfg["parts"]:
        if part["part"] == "model":
            continue
        outs = tower.setdefault(part["part"], [])
        hooks.append(prog.pooled_into(part).register_forward_pre_hook(
            lambda module, args, outs=outs: outs.append(
                args[0].detach().float().clone())))
    batches, losses, grad_norms = [], [], {}
    for i in range(n):
        batch, metrics, _, _ = prog.update()
        if i == 0:
            for hook in hooks:
                hook.remove()
            grad_norms = optim.first_gradient_norms(
                prog.optimizer, prog.trainable(), settings)
        batches.append(batch)
        losses.append(metrics["loss"])
    with torch.no_grad():
        names = list(start)
        params = dict(prog.trainable())
        change = torch.stack([(params[k].detach() - start[k]).norm()
                              for k in names]).tolist()
    return dict(batches=batches, tower=tower,
                losses=[float(x) for x in losses], grad_norms=grad_norms,
                change_norms=dict(zip(names, change)),
                optim_diff=float(optim.settings_diff(
                    prog.optimizer, prog.trainable(), settings)))


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool,
             device) -> Dict:
    """One run of ``cell``: {"output": the result line, "reference_s":
    the reference's and check's seconds, "ctx": what the readers read}."""
    import torch

    from benchmark import check, program, trace as tracing, work

    cfg, settings = cell["cfg"], cell["settings"]
    prog, corpus, readings = setup_program(cell, seed, device)
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    sections = settings["per_device_train_batch_size"] * settings[
        "grad_accumulation_steps"]
    waits, cpus, losses, ends, masks = [], [], [], [], []
    _sync(device)
    setup_s = since_start()
    start = time.perf_counter()
    if cuda:
        first = torch.cuda.Event(enable_timing=True)
        first.record()
    host_ends = []
    while time.perf_counter() - start < seconds:
        batch, metrics, waited, cpu = prog.update()
        if cuda:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
        host_ends.append(time.perf_counter())
        waits.append(waited)
        cpus.append(cpu)
        losses.append(metrics["loss"])
        masks.append(_counted(batch))
    _sync(device)
    window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        marks = [first] + ends
        update_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        update_ms = list(np.diff([start] + host_ends) * 1e3)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    updates = len(losses)

    ctx = dict(cfg=cfg, settings=settings, window_s=window_s,
               updates=updates, waits=waits, cpus=cpus, update_ms=update_ms,
               flops=[work.update_flops(cfg, settings, m) for m in masks],
               card=torch.cuda.get_device_name(device) if cuda else "cpu")
    ctx["peak"] = work.peaks(ctx["card"])
    device_info = dict(platform="gpu" if cuda else "cpu", kind=ctx["card"],
                       count=cell["chips"],
                       memory_peak_bytes=int(max(setup_peak, window_peak)))
    out: Dict = {}
    if trace:
        wrappers = [w for k in work.kernels()
                    for w in work.load("kernels", k).WRAPPERS]
        before = program.launches(wrappers)
        traced_masks: List = []

        def run(mark):
            for _ in range(cell["check"]["trace_updates"]):
                batch = prog.update(mark)[0]
                traced_masks.append(_counted(batch))
            return len(traced_masks)

        tr, t0, t1 = tracing.profile(run, device)
        after = program.launches(wrappers)
        ctx.update(trace=tr,
                   traced_launches=[work.launches(cfg, settings, m)
                                    for m in traced_masks],
                   counted_launches={k: after[k] - before[k]
                                     for k in after})
        metrics_out = {}
        for m in cell["per_layer"]:
            value = work.load("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.wall_s)
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in
                           list(tr.seconds_by_kind().items())[:10]],
            "idle_gaps": [[k, v] for k, v in
                          list(tr.idle_by_host(t0, t1).items())[:10]]}
    else:
        values = dict(train_sections_per_s=updates * sections / window_s,
                      peak_mem_gib=window_peak / 2**30, setup_s=setup_s)
        metrics_out = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell["end_to_end"]}
    prog.close()
    del prog
    free(device)

    # the reference, once the program is gone
    ref_start = time.perf_counter()
    numbers = reference_check(cell, seed, device, corpus, readings)[0]
    limits = cell["check"]["limits"]
    result = dict(correct=check.verdict(numbers, limits), attempted=updates,
                  failed=failed, metrics=metrics_out, device=device_info)
    result.update(out)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in check.NAMES}
    return dict(output=result, reference_s=time.perf_counter() - ref_start,
                ctx=ctx)


def setup_program(cell: Dict, seed: int, device):
    """(the port's training loop after its first updates, the corpus, the
    check's readings of those updates)."""
    from benchmark import program, weights
    from benchmark.traffic.generator import make_corpus

    cfg, settings = cell["cfg"], cell["settings"]
    corpus = make_corpus(cell["traffic"]["corpus"], corpus_seed(seed))
    made = weights.make_weights(cfg, settings, seed, device)
    prog = program.Program(cfg, settings, seed, device, corpus, made)
    del made
    readings = _check_updates(prog, cfg, settings, CHECK_UPDATES)
    _sync(device)
    return prog, corpus, readings


def reference_check(cell: Dict, seed: int, device, corpus, readings: Dict,
                    prec=None, half: bool = False):
    """(the check's numbers, the reference's run): the reference's
    batches assembled from the corpus in the loader's order, its first
    updates from the seed's weights in float32 with TF32 off (or at
    ``prec``; ``half``: half of each micro-batch)."""
    import torch

    from benchmark import check, weights, work
    from benchmark.reference import model as ref_model
    from benchmark.reference import train as reference

    cfg, settings = cell["cfg"], cell["settings"]
    sections = settings["per_device_train_batch_size"] * settings[
        "grad_accumulation_steps"]
    assemble = work.load("reference/assemblers", cfg["assembler"])
    order = assemble.loader_order(len(corpus[1]), sections, seed)
    asm = assemble.Assembler(*corpus, settings)
    readings["reference_batches"] = [asm.batch(ix)
                                     for ix in order[:CHECK_UPDATES]]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference.run(cfg, settings,
                            weights.make_weights(cfg, settings, seed, device),
                            readings["reference_batches"], seed, device,
                            prec or ref_model.Precision(), half=half)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return check.numbers(readings, ref), ref


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _counted(batch: Dict) -> Dict:
    """What the work counts read of a batch: every array but the pixels,
    which stand in by their slots' shape."""
    out = {k: v for k, v in batch.items() if k != "images"}
    if "images" in batch:
        out["images"] = np.empty(batch["images"].shape[:2] + (0,), np.uint8)
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _environment() -> None:
    """The run's environment, before the program is imported: the default
    attention route (no blocked backward), the kernel caches at fixed
    paths inside the checkout, no JAX through a library."""
    os.environ.pop("MMGL_BLOCKED_BWD", None)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT.parent / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    _environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell[
            "chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    got = run_cell(cell, a.seed, a.seconds, bool(a.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result = got["output"]
    print(f"reference and check: {got['reference_s']:.1f} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
