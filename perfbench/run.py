"""The benchmark of ``netsdb_tpu_torch``: one run of one cell.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes the cell's weights and input sets on the card from
``--seed``, stores them through the client's set API, runs every input
set twice (the first call of a DAG captures its CUDA graph, the second
replays it), and counts all of that as set-up. Then, for ``--seconds``,
one client sends requests in a closed loop: each is one call of
``Client.execute_computations`` over the next input set, ended by a
synchronise. With ``--trace 0`` the result carries the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` and
the result carries its per-layer metrics.

Once the window has closed the run reads the peak of device memory, as
reserved (a captured graph's private pool holds its memory between
replays, whatever of it is allocated at the moment), frees the program,
and holds a sample of the window's outputs to the plain float64
reference (``judge.py``). The numbers compared, each with
its limit, are the last lines of standard error and the last key of the
result, the one JSON line that ends standard output.

The run fails, and prints no result, without a CUDA card (or with fewer
than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
``netsdb_tpu`` is loaded once the window has closed. Kernel builds and
the CUDA driver's code cache live in fixed directories under
``perfbench/.cache``; the client's files under the temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, Iterable, List, Optional

from perfbench import judge, manifest, traffic
from perfbench.manifest import PKG_DIR

CACHE_DIR = PKG_DIR / ".cache"
#: the top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "netsdb_tpu")
WARM_CALLS = 2


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` as a whole word."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout, set before CUDA
    starts: Triton's, and the CUDA driver's code cache."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE_DIR / "nv")


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    config: dict
    mix: dict
    kind: object
    seed: int
    device: object
    peaks: dict
    window: Dict[str, float]
    counters: Dict[str, int]
    trace: Optional[dict]


class _Clock:
    """Times one request: CUDA events on the card (a request is a few
    milliseconds, below what the host's clock resolves reliably), the
    host's clock on the CPU."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        if self.cuda:
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end.record()

    def ms(self) -> float:
        """After the synchronise."""
        if self.cuda:
            return self.start.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1e3


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def open_client(dev):
    """A client of the program on ``dev``: its files under the temporary
    directory, the kernels built into and loaded from the checkout."""
    from perfbench import systems

    return systems.client(dev, os.path.join(tempfile.gettempdir(),
                                            "perfbench-root"),
                          str(CACHE_DIR / "kernels"))


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _trace_summary(prof) -> Optional[dict]:
    """The traced window's device time and breakdown; the window runs
    from the first request's span to the last synchronise's."""
    from perfbench import devtrace

    device_iv, host_iv = devtrace.intervals(prof)
    starts = devtrace.span_range(host_iv, devtrace.SPAN_REQUEST)
    ends = devtrace.span_range(host_iv, devtrace.SPAN_SYNC)
    if not (starts and ends):
        return None
    return devtrace.summarize(device_iv, host_iv, (starts[0], ends[1]))


def _window(sut, dev, order, kept, seconds: float) -> dict:
    """The closed loop: one request after another, each ended by a
    synchronise, until ``seconds`` have passed. A request that raises is
    counted as failed and the loop goes on. ``kept`` samples the
    ``(input set, output)`` pairs."""
    from torch.profiler import record_function

    from perfbench import devtrace

    clock = _Clock(dev)
    latencies: List[float] = []
    attempted = failed = 0
    w0 = time.perf_counter()
    while True:
        i = next(order)
        attempted += 1
        out = None
        try:
            clock.begin()
            with record_function(devtrace.SPAN_REQUEST):
                out = sut.request(i)
            clock.stop()
            with record_function(devtrace.SPAN_SYNC):
                _sync(dev)
            latencies.append(clock.ms())
            kept.offer((i, out))
        except Exception:  # noqa: BLE001 — a failed request is counted
            failed += 1
            traceback.print_exc(file=sys.stderr)
        del out
        if time.perf_counter() - w0 >= seconds:
            break
    return {"attempted": attempted, "failed": failed,
            "completed": attempted - failed,
            "seconds": time.perf_counter() - w0, "latencies": latencies,
            "kept": kept.items}


def measure(man: manifest.Manifest, cell_name: str, seed: int,
            seconds: float, trace: bool, device: str = "cuda",
            t0: Optional[float] = None,
            wrap: Optional[Callable[[object], object]] = None,
            phases: Optional[Dict[str, float]] = None) -> dict:
    """One run of ``cell_name``; returns the result object (``checks``
    last). ``t0`` is the process's start (default: now). ``wrap`` takes
    the program under test and returns what the window drives in its
    place (tests plant faults with it). ``phases``: the set-up's phases
    already timed since ``t0``, in seconds."""
    import torch

    from perfbench import arithmetic, systems

    t0 = time.time() if t0 is None else t0
    phases = dict(phases or {})
    phases["start"] = time.time() - t0 - sum(phases.values())
    cell = man.cell(cell_name)
    config = man.config(cell["config"])
    mix = traffic.validate(man.traffic(cell["traffic"]))
    spec = man.cell_file(cell_name)
    kind = manifest.kind(config["kind"])
    system = manifest.system(config["kind"])
    dev = torch.device(device)

    # --- set-up: data from the seed, stored through the client, warmed
    def phase(name):
        _sync(dev)
        phases[name] = time.time() - t0 - sum(phases.values())

    if dev.type == "cuda":
        torch.cuda.init()
    phase("device")
    data = kind.make_data(config, mix["shape"], mix["input_sets"], seed, dev)
    phase("data")
    client = open_client(dev)
    sut = system.open(client, config, data)
    if wrap is not None:
        sut = wrap(sut)
    dense = sut.dense
    phase("store")
    at_start = systems.program_counters()
    for _ in range(WARM_CALLS):
        for i in range(mix["input_sets"]):
            sut.request(i)
    phase("warm")
    setup_s = time.time() - t0

    # --- the window
    before = systems.program_counters()
    prof = _profiler(dev) if trace else contextlib.nullcontext()
    with prof:
        window = _window(sut, dev, traffic.input_order(mix),
                         judge.Reservoir(spec["sample"], seed), seconds)
    counters = {k: v - before[k]
                for k, v in systems.program_counters().items()}
    # the card's memory the process held at its peak: what PyTorch's
    # allocator reserved, the graphs' private pools whole among it
    memory_peak = (torch.cuda.max_memory_reserved(dev)
                   if dev.type == "cuda" else 0)
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")

    result: Dict[str, object] = {"correct": False,
                                 "attempted": window["attempted"],
                                 "failed": window["failed"], "metrics": {}}
    summary = None
    if trace:
        summary = _trace_summary(prof) if dev.type == "cuda" else None
        del prof
        ctx = Context(config=config, mix=mix, kind=kind, seed=seed,
                      device=dev, peaks=arithmetic.H100_SXM,
                      window={"completed": window["completed"],
                              "seconds": window["seconds"]},
                      counters=counters, trace=summary)
        for m in man.per_layer(cell_name):
            value = man.reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    else:
        lat = window["latencies"] + [math.inf] * window["failed"]
        values = {"setup_s": setup_s,
                  f"{kind.UNIT}_per_s": kind.units_per_request(mix["shape"])
                  * window["completed"] / window["seconds"],
                  "request_ms_p95": percentile(lat, 95) if lat else math.inf}
        for m in man.end_to_end(cell_name):
            if m["name"] not in values:
                raise KeyError(f"the harness computes no end-to-end "
                               f"metric {m['name']!r}")
            v = values[m["name"]]
            result["metrics"][m["name"]] = {
                "value": v if math.isfinite(v) else None, "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": device_name, "count": cell["chips"],
                        "memory_peak_bytes": int(memory_peak)}
    if dev.type == "cuda":
        result["device"]["memory_peak_allocated_bytes"] = int(
            torch.cuda.max_memory_allocated(dev))
        result["device"]["power_limit"] = _power_limit()
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_phases_s"] = phases
    result["program_counters"] = {
        "setup": {k: before[k] - at_start[k] for k in before},
        "window": counters}
    lat = window["latencies"]
    result["request_ms"] = ({f"p{q}": percentile(lat, q)
                             for q in (50, 90, 95, 99, 100)} if lat else {})

    # --- correctness, once the program's state is freed
    samples = window["kept"]
    del window, sut, client
    systems.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    weights, inputs = data["weights"], data["inputs"]
    values = judge.readings(
        samples, dense,
        lambda i: kind.reference(config, weights, inputs[i], "f64"))
    values["failed"] = result["failed"]
    ok, checks = judge.verdict(values, {**spec["limits"], "failed": 0})
    result["correct"] = ok
    result["checks"] = checks
    return result


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m perfbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         t0: Optional[float] = None) -> int:
    t0 = time.time() if t0 is None else t0
    args = parse_args(sys.argv[1:] if argv is None else argv)
    set_cache_env()
    import torch

    phases = {"imports": time.time() - t0}
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card is available; the benchmark runs "
              "only on one", file=sys.stderr)
        return 2
    man = manifest.Manifest()
    chips = man.cell(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    phases["cuda_probe"] = time.time() - t0 - phases["imports"]
    result = measure(man, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", t0, phases=phases)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"perfbench: modules that no run may load are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    print("request ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["request_ms"].items()),
        file=sys.stderr)
    print("program counters: " + json.dumps(result["program_counters"]),
          file=sys.stderr)
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_phases_s"].items()),
        file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
