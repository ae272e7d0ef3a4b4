"""Readings the benchmark's limits and per-layer metrics were set from.
The benchmark's own runs do not run this; it is run on the card when a
cell or a limit is set, and its readings are kept in ``PERF.md``.

    python3 -m perfbench.calibrate control --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3] [--seconds 2]
    python3 -m perfbench.calibrate trace-probe --workload <cell> --seed 1

``control``, in one process: the program's runs of the cell (set-up,
a short window, the comparison, as the benchmark makes them) on each of
``--seeds``, then on each of ``--control-seeds`` the control, the plain
reference put in the program's place and computed with TF32 on (the
precision below the configurations' float32 with TF32 off), and the
plain reference in float32, each held to the float64 reference by the
cell's numbers over the seed's first ``CONTROL_SETS`` input sets. The
lower reading of a limit is the largest the program gives; the upper
the smallest the control gives.

``trace-probe``: whether the profiler sees a CUDA graph replay's
kernels. One request of input set 0 runs eagerly (its first call,
which then captures), one replays; both under ``torch.profiler``, and
the device operations of each are counted and summed.

Each line printed is one JSON object; the last sums them up.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List


#: the input sets of a seed the control is read on: as many as the
#: benchmark's runs compare (``workloads/<cell>.json``'s sample)
CONTROL_SETS = 4


def _seeds(text: str) -> List[int]:
    return [int(s) for s in text.split(",") if s]


def control(man, cell_name: str, seeds: List[int], control_seeds: List[int],
            seconds: float, device: str = "cuda") -> dict:
    import torch

    from perfbench import judge, manifest, run, traffic

    program = []
    for seed in seeds:
        t = time.time()
        r = run.measure(man, cell_name, seed, seconds, False, device)
        row = {"seed": seed, "correct": r["correct"],
               "attempted": r["attempted"],
               **{k: c["value"] for k, c in r["checks"].items()},
               "metrics": {k: m["value"] for k, m in r["metrics"].items()},
               "memory_peak_bytes": r["device"]["memory_peak_bytes"],
               "run_s": time.time() - t}
        print(json.dumps({"program": row}), flush=True)
        program.append(row)
    cell = man.cell(cell_name)
    config = man.config(cell["config"])
    mix = traffic.validate(man.traffic(cell["traffic"]))
    kind = manifest.kind(config["kind"])
    controls = []
    for seed in control_seeds:
        data = kind.make_data(config, mix["shape"], mix["input_sets"], seed,
                              torch.device(device))
        row = {"seed": seed}
        for mode in ("tf32", "f32"):
            worst = 0.0
            for x in data["inputs"][:CONTROL_SETS]:
                ref = kind.reference(config, data["weights"], x, "f64")
                got = kind.reference(config, data["weights"], x, mode)
                worst = max(worst, judge.max_abs_err(got, ref))
                del ref, got
            row[f"{mode}_max_abs_err"] = worst
        print(json.dumps({"control": row}), flush=True)
        controls.append(row)
        del data
    summary = {
        "cell": cell_name,
        "program_max_abs_err_max": max((p["max_abs_err"] for p in program),
                                       default=None),
        "program_all_correct": all(p["correct"] for p in program),
        "control_tf32_max_abs_err_min": min(
            (c["tf32_max_abs_err"] for c in controls), default=None),
        "plain_f32_max_abs_err_max": max(
            (c["f32_max_abs_err"] for c in controls), default=None)}
    return summary


def trace_probe(man, cell_name: str, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import devtrace, manifest, systems, traffic
    from perfbench.run import open_client

    cell = man.cell(cell_name)
    config = man.config(cell["config"])
    mix = traffic.validate(man.traffic(cell["traffic"]))
    kind = manifest.kind(config["kind"])
    dev = torch.device("cuda")
    data = kind.make_data(config, mix["shape"], mix["input_sets"], seed, dev)
    client = open_client(dev)
    sut = manifest.system(config["kind"]).open(client, config, data)
    out = {}
    for label in ("eager", "warm", "replay"):
        before = systems.program_counters()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sut.request(0)
            torch.cuda.synchronize()
        after = systems.program_counters()
        device_iv, _ = devtrace.intervals(prof)
        device_iv = [d for d in device_iv
                     if not d[2].startswith("Activity Buffer")]
        names = {}
        for s, e, n in device_iv:
            names[n] = names.get(n, 0) + 1
        out[label] = {"ops": len(device_iv),
                      "device_ms": sum(e - s for s, e, _ in device_iv) * 1e3,
                      "counters": {k: after[k] - before[k] for k in after},
                      "op_counts": names}
        print(json.dumps({label: out[label]}), flush=True)
    return {"cell": cell_name,
            "eager_ops": out["eager"]["ops"],
            "replay_ops": out["replay"]["ops"],
            "eager_device_ms": out["eager"]["device_ms"],
            "replay_device_ms": out["replay"]["device_ms"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    sub = p.add_subparsers(dest="what", required=True)
    c = sub.add_parser("control")
    c.add_argument("--workload", required=True)
    c.add_argument("--seeds", type=_seeds, required=True)
    c.add_argument("--control-seeds", type=_seeds, default=[])
    c.add_argument("--seconds", type=float, default=2.0)
    t = sub.add_parser("trace-probe")
    t.add_argument("--workload", required=True)
    t.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    from perfbench import manifest, run

    run.set_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    man = manifest.Manifest()
    if args.what == "control":
        summary = control(man, args.workload, args.seeds,
                          args.control_seeds, args.seconds)
    else:
        summary = trace_probe(man, args.workload, args.seed)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
