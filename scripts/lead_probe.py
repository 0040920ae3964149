"""How far the host runs ahead of the card in a benchmark cell's training
loop, untraced, and what the host does in each update.

After the harness's set-up (``benchmark/run.py`` ``setup_program``) and
five updates more, N turns of the loop's body (``Program.update``: the
next batch, the update, the loss read at ``print_freq``). Each records a
CUDA event and reads the host clock at its start and end, at every
micro-batch's forward (a pre-hook on the model) and at the optimizer's
step (a step pre-hook). After one synchronize every event's device time is
read on one clock with the host's: a point's lead is the device time at
which its event ran less the host time at which it was recorded. A lead
near 0 means the card had run dry there and waited for the host.

Per update it prints the card's ms (from the previous update's end to
this one's), the host's wall ms, its ms waiting for the loader, the update
thread's CPU ms, the other threads' CPU ms (the loader's), whether it
read the loss (a synchronize, every ``print_freq`` updates), the garbage
collections that ran (count, oldest generation, ms) and the smallest
lead. The card's idle in an update is its ms less the busy ms a trace of
the cell reads, which this probe does not take.

    python3 scripts/lead_probe.py <cell> <seed> <updates> [--gc-freeze]

``--gc-freeze`` collects once after set-up and moves every object then
alive out of the collector's reach (``gc.freeze()``), so that an older
generation's collection walks only what the loop itself made. Run it from
the root of a checkout, on a machine with a CUDA card.
"""

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
from benchmark import run  # noqa: E402

STALL_MS = 5.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("updates", type=int)
    ap.add_argument("--gc-freeze", action="store_true")
    a = ap.parse_args()

    cell = run.load_cell(a.cell)
    run._environment()
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    prog, _, _ = run.setup_program(cell, a.seed, device)
    now = {"update": -1, "gc_start": 0.0}
    points = []      # (update, label, host s, event)
    collected = {}   # update -> [count, oldest generation, ms]

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        points.append((now["update"], label, time.perf_counter(), ev))

    def on_gc(phase, info):
        if phase == "start":
            now["gc_start"] = time.perf_counter()
            return
        got = collected.setdefault(now["update"], [0, 0, 0.0])
        got[0] += 1
        got[1] = max(got[1], info["generation"])
        got[2] += (time.perf_counter() - now["gc_start"]) * 1e3

    prog.model.register_forward_pre_hook(lambda *_: mark("forward"))
    prog.optimizer.register_step_pre_hook(lambda *_: mark("optimizer"))
    for _ in range(5):
        prog.update()
    if a.gc_freeze:
        gc.collect()
        gc.freeze()
    torch.cuda.synchronize()
    origin = torch.cuda.Event(enable_timing=True)
    origin.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    points.clear()
    gc.callbacks.append(on_gc)
    host = []
    for i in range(a.updates):
        now["update"] = i
        mark("update_start")
        wall, cpu, proc = (time.perf_counter(), time.thread_time(),
                           time.process_time())
        _, _, waited, _ = prog.update()
        cpu = time.thread_time() - cpu
        read = prog.steps == 1 or prog.steps % prog.args.print_freq == 0
        host.append(dict(loss_read=int(read),
                         host_ms=(time.perf_counter() - wall) * 1e3,
                         wait_ms=waited * 1e3, cpu_ms=cpu * 1e3,
                         other_cpu_ms=(time.process_time() - proc - cpu)
                         * 1e3))
        mark("update_end")
    gc.callbacks.remove(on_gc)
    torch.cuda.synchronize()

    leads, rows, labels = {}, [], {}
    for i, label, t, ev in points:
        lead = origin.elapsed_time(ev) - (t - t0) * 1e3
        leads.setdefault(i, []).append(lead)
        labels.setdefault(label, []).append(lead)
    ends = [origin.elapsed_time(ev) for _, label, _, ev in points
            if label == "update_end"]
    for i, h in enumerate(host):
        count, gen, gc_ms = collected.get(i, [0, 0, 0.0])
        rows.append(dict(update=i, device_ms=ends[i] - (ends[i - 1] if i
                                                         else 0.0),
                         **h, gc=count, gc_gen=gen, gc_ms=gc_ms,
                         min_lead_ms=min(leads[i])))
    # the first update's card ms runs from the origin, before its start
    steady = rows[1:]
    stalls = [r for r in steady if r["min_lead_ms"] < STALL_MS]

    def mean(key, of=steady):
        return statistics.fmean(r[key] for r in of) if of else None

    print(json.dumps({
        "cell": a.cell, "seed": a.seed, "updates": a.updates,
        "gc_freeze": a.gc_freeze,
        "device_ms_per_update": mean("device_ms"),
        "device_ms_median": statistics.median(r["device_ms"]
                                              for r in steady),
        "host_ms_mean": mean("host_ms"), "wait_ms_mean": mean("wait_ms"),
        "cpu_ms_mean": mean("cpu_ms"),
        "other_cpu_ms_mean": mean("other_cpu_ms"),
        "gc_ms_total": sum(r["gc_ms"] for r in steady),
        "gen2_collections": sum(r["gc_gen"] == 2 and r["gc"] > 0
                                for r in steady),
        "stalls": len(stalls),
        "device_ms_in_stalls": mean("device_ms", stalls),
        "device_ms_elsewhere": mean("device_ms", [r for r in steady
                                                  if r not in stalls]),
        "lead_ms": {k: [round(min(v), 1), round(statistics.median(v), 1),
                        round(max(v), 1)] for k, v in labels.items()}}))
    keys = ("device_ms", "host_ms", "wait_ms", "cpu_ms", "other_cpu_ms",
            "loss_read", "gc", "gc_gen", "gc_ms", "min_lead_ms")
    print("update " + " ".join(f"{k:>12s}" for k in keys))
    for r in rows:
        print(f"{r['update']:6d} " + " ".join(
            f"{r[k]:12.1f}" if isinstance(r[k], float) else f"{r[k]:12d}"
            for k in keys))
    prog.close()


if __name__ == "__main__":
    main()
