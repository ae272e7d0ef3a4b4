"""A configuration, a traffic mix, a cell and a per-layer metric are
added by adding files and entries: nothing that is there is edited."""

import hashlib
import json

import pytest

from perfbench import run, traffic
from perfbench.manifest import Manifest

READER = '''
"""A metric no real cell has: requests the window completed."""


def read(ctx):
    return float(ctx.window["completed"]) or None
'''


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_files_are_found_by_their_names(tiny):
    pkg, bench_path = tiny.pkg_dir, tiny.bench_path
    before = _hashes(pkg)
    # new files only
    (pkg / "configs" / "ff-wide.json").write_text(json.dumps(
        {"name": "ff-wide", "kind": "ff", "features": 96, "hidden": 64,
         "labels": 8, "block": [32, 32], "dtype": "float32"}))
    (pkg / "traffic" / "rows33x3.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "input_sets": 3,
         "order": "cycle", "shape": {"rows": 33}}))
    (pkg / "workloads" / "ff.wide.json").write_text(json.dumps(
        {"sample": 3, "limits": {"max_abs_err": 1e-5}}))
    (pkg / "metrics" / "requests_done.py").write_text(READER)
    # new entries only
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "ff-wide", "source": "test",
                             "file": "perfbench/configs/ff-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ff.wide", "config": "ff-wide",
                               "traffic": "rows33x3", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "ff.tiny" in m.get("workloads", []):
            m["workloads"].append("ff.wide")
    bench["per_layer"].append(
        {"name": "requests_done.ff", "unit": "requests", "better": "higher",
         "source": "host_clock", "layer": "entry and program cache",
         "moves": "rows_per_s", "workloads": ["ff.wide"]})
    bench_path.write_text(json.dumps(bench))
    after = _hashes(pkg)
    assert all(after[p] == h for p, h in before.items())

    man = Manifest(bench_path, pkg)
    assert man.config("ff-wide")["features"] == 96
    assert [m["name"] for m in man.per_layer("ff.wide")] == \
        ["requests_done.ff"]
    assert [m["name"] for m in man.end_to_end("ff.wide")] == \
        ["setup_s", "rows_per_s", "request_ms_p95"]
    r = run.measure(man, "ff.wide", 77, 0.2, False, "cpu")
    assert r["correct"] is True and "rows_per_s" in r["metrics"]
    r = run.measure(man, "ff.wide", 77, 0.2, True, "cpu")
    assert r["correct"] is True
    assert r["metrics"]["requests_done.ff"]["value"] == r["attempted"]
    assert r["metrics"]["requests_done.ff"]["unit"] == "requests"


def test_a_reader_is_found_by_its_stem(tiny):
    assert tiny.reader("mfu.ff").__name__ == "perfbench_metric_mfu"
    assert tiny.reader("mfu.xformer").__name__ == "perfbench_metric_mfu"
    assert tiny.reader("flash_attention_roofline").__name__ == \
        "perfbench_metric_flash_attention_roofline"
    with pytest.raises(KeyError):
        tiny.reader("nothing.here")


def test_a_metric_is_reported_by_the_cells_it_lists(tiny):
    assert [m["name"] for m in tiny.per_layer("ff.tiny")] == [
        m["name"] for m in tiny.bench["per_layer"]
        if "ff.tiny" in m["workloads"]]
    assert "flash_attention_roofline" not in {
        m["name"] for m in tiny.per_layer("ff.tiny")}
    assert all("workloads" in m for m in tiny.bench["per_layer"])


def test_unknown_names_raise(tiny):
    for lookup in (tiny.cell, tiny.config):
        with pytest.raises(KeyError):
            lookup("no-such-name")


def test_the_real_manifest_names_files_that_exist():
    man = Manifest()
    for cell in man.bench["workloads"]:
        config = man.config(cell["config"])
        assert config["name"] == cell["config"]
        traffic.validate(man.traffic(cell["traffic"]))
        spec = man.cell_file(cell["name"])
        assert spec["sample"] >= 1 and spec["limits"]
        for m in man.per_layer(cell["name"]):
            assert hasattr(man.reader(m["name"]), "read")


@pytest.mark.parametrize("bad", [
    {"loop": "open"}, {"clients": 2}, {"order": "random"},
    {"input_sets": 0}, {"shape": {}}])
def test_traffic_that_the_generator_cannot_send_is_refused(bad):
    mix = dict({"loop": "closed", "clients": 1, "input_sets": 2,
                "order": "cycle", "shape": {"rows": 4}}, **bad)
    with pytest.raises(ValueError):
        traffic.validate(mix)


def test_requests_cycle_over_the_input_sets():
    mix = {"loop": "closed", "clients": 1, "input_sets": 3,
           "order": "cycle", "shape": {"rows": 4}}
    order = traffic.input_order(mix)
    assert [next(order) for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]
