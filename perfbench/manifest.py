"""Finds what a cell needs by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- a configuration: the ``file`` its entry names (sizes, ``kind``), whose
  ``kind`` names ``kinds/<kind>.py`` (data, plain reference, counts) and
  ``systems/<kind>.py`` (the program driven through its client);
- a traffic mix: ``traffic/<traffic>.json``, read by ``traffic.py``;
- a cell: ``workloads/<cell>.json``, its correctness limits and sample;
- a per-layer metric: ``metrics/<stem>.py``, where the stem is the name
  up to its first dot (``mfu.ff`` → ``mfu.py``), with ``read(ctx)``; its
  entry lists the cells that report it under ``workloads``.

So a later change adds a configuration, a cell or a metric by adding
files and entries, and edits nothing that is here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent


class Manifest:
    """``BENCHMARK.json`` and the benchmark's files under ``pkg_dir``."""

    def __init__(self, bench_path: Optional[Path] = None,
                 pkg_dir: Optional[Path] = None):
        self.pkg_dir = Path(pkg_dir) if pkg_dir is not None else PKG_DIR
        self.bench_path = (Path(bench_path) if bench_path is not None
                           else self.pkg_dir.parent / "BENCHMARK.json")
        with open(self.bench_path) as f:
            self.bench = json.load(f)
        self.root = self.bench_path.parent

    @staticmethod
    def _named(entries: List[dict], name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.bench["configs"], name, "config")
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.pkg_dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def cell_file(self, name: str) -> dict:
        with open(self.pkg_dir / "workloads" / f"{name}.json") as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics whose ``workloads`` list ``cell``."""
        return [m for m in self.bench["per_layer"]
                if cell in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        """The reader module of per-layer metric ``metric``:
        ``metrics/<stem>.py``."""
        stem = metric.split(".", 1)[0]
        path = self.pkg_dir / "metrics" / f"{stem}.py"
        if not path.exists():
            raise KeyError(f"no reader for per-layer metric {metric!r}: "
                           f"{path} is missing")
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + stem.replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def kind(name: str) -> ModuleType:
    """``kinds/<name>.py``: the data, reference and counts of a kind."""
    return importlib.import_module(f"perfbench.kinds.{name}")


def system(name: str) -> ModuleType:
    """``systems/<name>.py``: the program under test for a kind."""
    return importlib.import_module(f"perfbench.systems.{name}")
