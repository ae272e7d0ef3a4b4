"""Public names the port lacked against the reference (ROADMAP.md C3),
each held to the reference's behaviour on the CPU: the native package's
re-exports, ``config.DEFAULT_CONFIG`` and ``Configuration.catalog_path``,
``SetStore.exists`` and ``CacheStats.as_dict``, ``Catalog.drop_database``
/ ``list_sets`` / ``close``, ``plan/planner.JobStage`` with
``LogicalPlan.stages``, and ``obs/operators.render_shard_forest`` (byte
for byte). The names that belong to JAX stay out of the port."""

import dataclasses
import sqlite3

import pytest

import netsdb_tpu.native as ref_native
from netsdb_tpu import config as ref_config
from netsdb_tpu import obs as jobs
from netsdb_tpu.catalog.catalog import Catalog as JCatalog
from netsdb_tpu.plan import computations as jcomp
from netsdb_tpu.plan import planner as jplanner
from netsdb_tpu.storage import store as jstore
import netsdb_tpu_torch.native as native
from netsdb_tpu_torch import config, obs
from netsdb_tpu_torch.catalog.catalog import Catalog
from netsdb_tpu_torch.plan import computations as comp
from netsdb_tpu_torch.plan import planner
from netsdb_tpu_torch.storage import store


def test_native_package_reexports_the_reference_names():
    assert native.__all__ == ref_native.__all__
    assert native.NativePageStore.__name__ == "NativePageStore"
    assert native.native_available() is ref_native.native_available()


def test_default_config_and_catalog_path(tmp_path):
    assert isinstance(config.DEFAULT_CONFIG, config.Configuration)
    fields = {f.name for f in dataclasses.fields(config.Configuration)}
    assert fields == {f.name for f in
                      dataclasses.fields(ref_config.Configuration)}
    for name in fields - {"root_dir"}:
        assert getattr(config.DEFAULT_CONFIG, name) == \
            getattr(ref_config.DEFAULT_CONFIG, name), name
    root = str(tmp_path)
    assert config.Configuration(root_dir=root).catalog_path == \
        ref_config.Configuration(root_dir=root).catalog_path


def test_set_store_exists_and_cache_stats_as_dict(tmp_path):
    ref = jstore.SetStore(ref_config.Configuration(
        root_dir=str(tmp_path / "ref")))
    port = store.SetStore(config.Configuration(
        root_dir=str(tmp_path / "port")), device="cpu")
    ident = ("d", "s")
    seen = []
    for st, sid in ((ref, jstore.SetIdentifier(*ident)),
                    (port, store.SetIdentifier(*ident))):
        row = [st.exists(sid)]
        st.create_set(sid)
        row.append(st.exists(sid))
        st.remove_set(sid)
        row.append(st.exists(sid))
        st.stats.hits += 2
        st.stats.loads += 1
        row.append(st.stats.as_dict())
        seen.append(row)
    assert seen[0] == seen[1] == [False, True, False, {
        "hits": 2, "misses": 0, "evictions": 0, "spills": 0, "loads": 1}]


def test_catalog_drop_database_list_sets_and_close(tmp_path):
    out = []
    for cls, path in ((JCatalog, tmp_path / "ref.sqlite"),
                      (Catalog, tmp_path / "port.sqlite")):
        cat = cls(str(path))
        for db in ("a", "b"):
            cat.create_database(db)
            for s in ("x", "y"):
                cat.create_set(db, s)
        row = [sorted(map(str, cat.list_sets())), cat.list_sets("b")]
        cat.drop_database("a")
        row += [cat.list_databases(), cat.list_sets("a"),
                sorted(map(str, cat.list_sets()))]
        cat.close()
        with pytest.raises(sqlite3.ProgrammingError):
            cat.list_databases()
        out.append(row)
    assert out[0] == out[1]
    assert out[1][2] == ["b"] and out[1][3] == []


@pytest.mark.parametrize("n_sinks", [1, 2])
def test_logical_plan_stages_match_the_reference(n_sinks):
    def build(c):
        scan = c.ScanSet("db", "a")
        ap = c.Apply(scan, lambda t: t, label="ident")
        sinks = [c.WriteSet(ap, "db", f"out{i}") for i in range(n_sinks)]
        return scan, sinks

    jscan, jsinks = build(jcomp)
    scan, sinks = build(comp)
    jplan = jplanner.plan_from_sinks(jsinks)
    plan = planner.plan_from_sinks(sinks)
    assert len(plan.stages) == len(jplan.stages) == n_sinks
    for st, jst in zip(plan.stages, jplan.stages):
        assert isinstance(st, planner.JobStage)
        assert st.stage_id == jst.stage_id
        assert st.sink is sinks[st.stage_id]
        assert [n.op_kind for n in st.nodes] == \
            [n.op_kind for n in jst.nodes]
        assert st.scans == [scan] and jst.scans == [jscan]


FORESTS = [
    None, {},
    {"10.0.0.2:9": {"job": "s", "mode": "streamed", "total_wall_s": 0.01,
                    "nodes": [{"id": 0, "kind": "Scan", "label": "d:x",
                               "inputs": [], "wall_s": 0.0,
                               "rows_out": 7},
                              {"id": 1, "kind": "Apply", "label": "f",
                               "inputs": [0], "wall_s": 0.01,
                               "region": 0, "counters": {"chunks": 2}}]},
     "10.0.0.1:9": {"job": "s", "mode": "eager", "total_wall_s": 0.0,
                    "nodes": []},
     "10.0.0.3:9": None}]


@pytest.mark.parametrize("i", range(len(FORESTS)))
@pytest.mark.parametrize("total_s", [None, 0.05])
def test_render_shard_forest_is_the_references_text(i, total_s):
    got = obs.operators.render_shard_forest(FORESTS[i], total_s)
    assert got == jobs.operators.render_shard_forest(FORESTS[i], total_s)
    if FORESTS[i]:
        assert "-- shard 10.0.0.1:9\n" in got and "-- shard 10.0.0.1:9:" \
            not in got


@pytest.mark.parametrize("module,name", [
    ("netsdb_tpu_torch.ops.common", "on_tpu"),
    ("netsdb_tpu_torch.plan.staging", "fold_donate_argnums")])
def test_names_that_belong_to_jax_stay_out(module, name):
    import importlib

    assert not hasattr(importlib.import_module(module), name)
