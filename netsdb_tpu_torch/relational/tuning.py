"""Physical-strategy thresholds keyed on the device kind — counterpart
of ``netsdb_tpu/relational/tuning.py``.

Three-level lookup, first hit wins:

1. the port's own autotune file, ``<root_dir>/autotune.json`` under the
   port's default ``Configuration().root_dir``, written by
   :func:`autotune` after it measured the crossovers on the live device;
2. a table of measured values per device kind (:data:`_MEASURED`);
3. defaults.

The races run on more rows than the reference's (4 M rows; a 1 M-row
build side probed by 4 M rows, not 128 k by 512 k): at the reference's
sizes a race on the H100 times kernel launches rather than the
strategies, and chose the sort join at every key-space factor. A device
kind is ``torch.cuda.get_device_name`` of the card or ``"cpu"``;
callers pass the device their data lives on, so a CPU client on a
machine with a card plans for the CPU. The reference's measured TPU
row does not carry over: it was taken on another chip. The measured
table starts empty, and the defaults are the reference's defaults
except the device-memory fallback, which is read from the device
(:func:`netsdb_tpu_torch.relational.planner.device_memory_bytes`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# measured crossovers per device kind (none yet; `autotune` measures the
# live card, and a value written here names the card and its power limit)
_MEASURED: Dict[str, Dict[str, float]] = {}

_DEFAULTS: Dict[str, float] = {
    # largest group count where the broadcast-compare reduce runs
    "segment_dense_limit": 64,
    # largest group count where the one-hot grid count runs
    "count_grid_limit": float(1 << 18),
    # the LUT join while key_space <= factor * (build + probe rows)
    "join_lut_factor": 32.0,
    # absolute LUT size cap
    "join_lut_max_bytes": 1 << 28,
}

_cache: Dict[str, Dict[str, float]] = {}


def _tuning_path() -> str:
    from netsdb_tpu_torch.config import Configuration

    return os.path.join(Configuration().root_dir, "autotune.json")


def device_kind(device=None) -> str:
    """The kind of ``device`` (a device, a string, or None for the
    default device: the first card if there is one, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _load(kind: str) -> Dict[str, float]:
    if kind in _cache:
        return _cache[kind]
    table = dict(_DEFAULTS)
    table.update(_MEASURED.get(kind, {}))
    try:
        with open(_tuning_path()) as f:
            persisted = json.load(f)
        table.update(persisted.get(kind, {}))
    except (OSError, ValueError):
        pass
    _cache[kind] = table
    return table


def get(name: str, kind: Optional[str] = None) -> float:
    """Threshold ``name`` for ``kind`` (default: the default device)."""
    return _load(kind or device_kind())[name]


def set_override(name: str, value: float,
                 kind: Optional[str] = None) -> None:
    """In-process override (tests force strategies through this). Plans
    are made per call, so the next query sees it."""
    _load(kind or device_kind())[name] = value


def clear_overrides() -> None:
    _cache.clear()


def state_token() -> tuple:
    """Every threshold in force, by device kind (the default device's
    loaded first): compiled programs key on it, since a plan's strategy
    choices are baked into a captured graph."""
    _load(device_kind())
    return tuple(sorted((kind, tuple(sorted(table.items())))
                        for kind, table in _cache.items()))


# --------------------------------------------------------------- autotune

def _time_ms(fn: Callable[[], object], device, iters: int = 5) -> float:
    """Milliseconds a call of ``fn`` takes on ``device``: CUDA events
    around ``iters`` calls after a warm-up on a card, the host clock
    around them on the CPU."""
    dev = torch.device(device)
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _largest_win(candidates, race) -> int:
    """The largest candidate at which ``race(c)`` (True: the first
    strategy won) still holds, scanning upward and stopping at the first
    loss; 0 when it loses at the smallest."""
    best = 0
    for c in candidates:
        if not race(c):
            break
        best = c
    return best


def measure_segment_crossover(device=None, n_rows: int = 1 << 22,
                              candidates=(8, 16, 32, 64, 128, 256, 512),
                              timer=_time_ms) -> int:
    """The largest group count where the dense segment sum still beats
    the scatter one on ``device``."""
    from netsdb_tpu_torch.relational import kernels as K

    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal(n_rows).astype(np.float32)
                            ).to(dev)

    def race(g):
        seg = torch.from_numpy(rng.integers(0, g, n_rows).astype(np.int32)
                               ).to(dev)
        return (timer(lambda: K.segment_sum(vals, seg, g, method="dense"),
                      dev)
                <= timer(lambda: K.segment_sum(vals, seg, g,
                                               method="scatter"), dev))

    return _largest_win(candidates, race)


def measure_count_grid_crossover(device=None, n_rows: int = 1 << 22,
                                 candidates=(1 << 12, 1 << 14, 1 << 16,
                                             1 << 18, 1 << 20),
                                 timer=_time_ms) -> int:
    """The largest group count where the grid count still beats the
    scatter count."""
    from netsdb_tpu_torch.relational import kernels as K

    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    rng = np.random.default_rng(0)

    def race(g):
        seg = torch.from_numpy(rng.integers(0, g, n_rows).astype(np.int32)
                               ).to(dev)
        return (timer(lambda: K.segment_count(seg, g, method="grid"), dev)
                <= timer(lambda: K.segment_count(seg, g, method="scatter"),
                         dev))

    return _largest_win(candidates, race)


def measure_join_crossover(device=None, n_build: int = 1 << 20,
                           n_probe: int = 1 << 22,
                           factors=(2, 4, 8, 16, 32, 64, 128),
                           timer=_time_ms) -> float:
    """The largest ``key_space / (build + probe)`` ratio where the LUT
    join still beats the sort join (factors whose LUT would pass the
    byte cap are not tried)."""
    from netsdb_tpu_torch.relational import kernels as K
    from netsdb_tpu_torch.relational.planner import JoinPlan

    dev = torch.device(device or ("cuda" if torch.cuda.is_available()
                                  else "cpu"))
    rng = np.random.default_rng(0)
    cap = _load(device_kind(dev))["join_lut_max_bytes"]
    factors = [f for f in factors if f * (n_build + n_probe) * 4 <= cap]

    def race(f):
        ks = int(f * (n_build + n_probe))
        # unique build keys without a ks-sized permutation
        draw = rng.integers(0, ks, int(n_build * 1.3) + 16)
        pk_u = np.unique(draw)[:n_build]
        while len(pk_u) < n_build:
            pk_u = np.unique(np.concatenate(
                [pk_u, rng.integers(0, ks, n_build)]))[:n_build]
        pk = torch.from_numpy(rng.permutation(pk_u).astype(np.int32)).to(dev)
        fk = torch.from_numpy(rng.integers(0, ks, n_probe).astype(np.int32)
                              ).to(dev)
        return (timer(lambda: K.pk_fk_join(pk, fk, plan=JoinPlan("lut", ks)),
                      dev)
                <= timer(lambda: K.pk_fk_join(pk, fk,
                                              plan=JoinPlan("sort", ks)),
                         dev))

    return float(_largest_win(factors, race))


def autotune(device=None, persist: bool = True) -> Dict[str, float]:
    """Measure the three crossovers on ``device`` (default: the first
    card, else the CPU), install them for its kind in this process and,
    with ``persist``, write them to the port's autotune file."""
    kind = device_kind(device)
    measured = {
        "segment_dense_limit": float(measure_segment_crossover(device)),
        "count_grid_limit": float(measure_count_grid_crossover(device)),
        "join_lut_factor": measure_join_crossover(device),
        "join_lut_max_bytes": float(_load(kind)["join_lut_max_bytes"]),
    }
    _load(kind).update(measured)
    if persist:
        path = _tuning_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[kind] = measured
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
    return measured
