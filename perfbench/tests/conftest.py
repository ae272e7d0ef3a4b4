"""Fixtures of the benchmark's own tests: a benchmark of tiny cells on
the CPU, built in a temporary directory as ``BENCHMARK.json`` and the
benchmark's files are in a checkout, and the ``chip`` marker of tests
that need a CUDA card (each decides inside itself whether one is
there, and skips with a reason where none is)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from perfbench.manifest import PKG_DIR, Manifest

#: Limits of the tiny cells, set like the real ones: between the
#: program's largest reading over seeds 1-12 on the CPU (FF 6.4e-7, the
#: layer 4.3e-6) and the TF32 control's smallest (FF 2.9e-4, the layer
#: 2.7e-3).
TINY_LIMITS = {"ff.tiny": 1e-5, "layer.tiny": 1e-4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (H100); skips without one. Run "
        "on the card with python3 -m pytest perfbench/tests -m chip")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is available here")
    return torch.device("cuda")


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_benchmark(root: Path) -> Manifest:
    """``root/BENCHMARK.json`` and ``root/perfbench/`` with two tiny cells
    (FF 100 rows of 64 features; the layer 2 × 48 × 64, 4 heads) and the
    real metric readers."""
    pkg = root / "perfbench"
    shutil.copytree(PKG_DIR / "metrics", pkg / "metrics")
    write_json(pkg / "configs" / "ff-tiny.json",
               {"name": "ff-tiny", "kind": "ff", "features": 64,
                "hidden": 128, "labels": 32, "block": [32, 32],
                "dtype": "float32"})
    write_json(pkg / "configs" / "layer-tiny.json",
               {"name": "layer-tiny", "kind": "transformer_layer",
                "n_embd": 64, "n_head": 4, "n_inner": None,
                "layer_norm_epsilon": 1e-5, "causal": True,
                "dtype": "float32"})
    mix = {"loop": "closed", "clients": 1, "input_sets": 2,
           "order": "cycle"}
    write_json(pkg / "traffic" / "rows100.json",
               dict(mix, shape={"rows": 100}))
    write_json(pkg / "traffic" / "seq48.json",
               dict(mix, shape={"batch": 2, "seq": 48}))
    for cell, limit in TINY_LIMITS.items():
        write_json(pkg / "workloads" / f"{cell}.json",
                   {"sample": 4, "limits": {"max_abs_err": limit}})
    cells = {"ff.tiny": ("ff-tiny", "rows100"),
             "layer.tiny": ("layer-tiny", "seq48")}
    bench = json.loads((PKG_DIR.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": c, "source": "tiny", "file": f"perfbench/configs/{c}.json",
         "reduced": [], "why": "tiny"} for c in ("ff-tiny", "layer-tiny")]
    bench["workloads"] = [
        {"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
        for n, (c, t) in cells.items()]
    rename = {"ff.score16k": "ff.tiny", "xformer.s16k": "layer.tiny"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    write_json(root / "BENCHMARK.json", bench)
    return Manifest(root / "BENCHMARK.json", pkg)


@pytest.fixture
def tiny(tmp_path) -> Manifest:
    return tiny_benchmark(tmp_path)
