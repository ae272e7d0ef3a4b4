"""The port's relational DAGs through ``Client(device="cpu")`` against the
JAX package's same DAGs through its ``Client``, on the CPU.

Both clients ingest the same rows (``workloads.tpch.generate(scale=2,
seed=3)``) or the same numpy columns with the same validity masks, with
``send_table``; the sinks run through ``execute_computations``. Covered:
``send_table`` (replace and append, with the dictionary remap),
``get_table``, ``analyze_set`` and the catalog's meta; ``q01_sink``,
``q06_sink``, ``q03_sink_for``, the two-stage build/probe pair and
``q03_probe_fold``'s ``merge``; ``suite_sink_for`` for all ten queries,
over plain tables and over tables with invalid rows (whose key columns
the DAG folds to -1) and orphan foreign keys. Thresholds are forced
identically on both sides. Integers exactly, floats within rtol 1e-5
(atol 1e-5 for sums near 0)."""

import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational import tuning as JT
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.workloads import tpch
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational import tuning as T
from netsdb_tpu_torch.relational.queries import _SUITE_CORES
from netsdb_tpu_torch.relational.stats import ColumnStats
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage.store import SetIdentifier

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
QUERIES = sorted(_SUITE_CORES)
THRESHOLDS = {
    "plain": dict(segment_dense_limit=1e9, count_grid_limit=1e9,
                  join_lut_factor=1e9, join_lut_max_bytes=1 << 30),
    "masked": dict(segment_dense_limit=0, count_grid_limit=1e9,
                   join_lut_factor=0.0, join_lut_max_bytes=1 << 30),
}


def force(name):
    for k, v in THRESHOLDS[name].items():
        JT.set_override(k, v, kind="cpu")
        T.set_override(k, v, kind="cpu")


@pytest.fixture(autouse=True)
def _clean():
    # the JAX executor caches a compiled plan per job name and plan shape
    clear_compiled_cache()
    yield
    JT.clear_overrides()
    T.clear_overrides()


@pytest.fixture(scope="module")
def data():
    return tpch.generate(scale=2, seed=3)


def same(ours, ref):
    got = ours.detach().cpu().numpy()
    want = np.asarray(ref)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def rows_close(ours, ref):
    """Decoded rows: keys, strings and ints exactly, floats within
    RTOL/ATOL."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], float):
                assert a[k] == pytest.approx(b[k], rel=RTOL, abs=ATOL)
            else:
                assert a[k] == b[k]


def same_table(ours: ColumnTable, ref):
    assert set(ours.cols) == set(ref.cols) and ours.dicts == ref.dicts
    for col in ref.cols:
        same(ours[col], ref[col])
    same(ours.mask(), ref.mask())


def clients(tmp_path):
    port = Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")
    ref = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    for c in (port, ref):
        c.create_database("tpch")
    return port, ref


def load_rows(port, ref, data):
    for name, rows in data.items():
        for c in (port, ref):
            c.create_set("tpch", name, type_name="table")
            c.send_table("tpch", name, rows)


def damaged(data, seed=42):
    """The same data with orphan foreign keys (lineitems of no order and
    of no part, orders of no customer, partsupps of no supplier) as JAX
    tables, each with about an eighth of its rows invalid."""
    rows = {n: [dict(r) for r in rs] for n, rs in data.items()}
    for i, r in enumerate(rows["lineitem"]):
        if i % 17 == 3:
            r["l_orderkey"] = 5000 + i
        if i % 23 == 5:
            r["l_partkey"] = 4000 + i
    last_cust = max(r["c_custkey"] for r in rows["customer"])
    for i, r in enumerate(rows["orders"]):
        if i % 13 == 2:
            r["o_custkey"] = 3000 + i
        elif i % 9 == 4:
            # the last customer (where a -1 key wraps to) gets many
            # orders, so a gather that clamped -1 to row 0 would differ
            r["o_custkey"] = last_cust
    for i, r in enumerate(rows["partsupp"]):
        if i % 11 == 1:
            r["ps_suppkey"] = 900 + i
    rng = np.random.default_rng(seed)
    out = {}
    for name, rs in rows.items():
        table = JTable.from_rows(rs)
        out[name] = table.filter(
            np.asarray(rng.random(table.num_rows) > 0.125))
    return out


def load_tables(port, ref, tables):
    """JAX tables into the JAX client; their numpy columns, dictionaries
    and masks into the port's."""
    for name, table in tables.items():
        for c in (port, ref):
            c.create_set("tpch", name, type_name="table")
        ref.send_table("tpch", name, table)
        port.send_table("tpch", name, ColumnTable.from_columns(
            {n: np.asarray(c) for n, c in table.cols.items()}, table.dicts,
            valid=np.asarray(table.valid), device="cpu"))


# ---------------------------------------------------------------- ingest
def test_send_get_and_analyze_match_the_reference(tmp_path, data):
    port, ref = clients(tmp_path)
    load_rows(port, ref, data)
    for name in data:
        ours, want = port.get_table("tpch", name), ref.get_table("tpch", name)
        same_table(ours, want)
        assert ours.device.type == "cpu"
        a, b = port.analyze_set("tpch", name), ref.analyze_set("tpch", name)
        assert a["num_rows"] == b["num_rows"] and a["dicts"] == b["dicts"]
        assert a["stats"] == {c: ColumnStats(s.n_rows, s.min_val, s.max_val,
                                             s.n_distinct)
                              for c, s in b["stats"].items()}
        assert port.catalog.get_set("tpch", name)["meta"] == \
            ref.catalog.get_set("tpch", name)["meta"]
    # a re-send replaces the relation
    for c in (port, ref):
        c.send_table("tpch", "region", data["region"][:2])
    same_table(port.get_table("tpch", "region"),
               ref.get_table("tpch", "region"))
    assert port.catalog.get_set("tpch", "region")["meta"]["num_rows"] == 2


def test_send_table_append_remaps_dictionaries(tmp_path, data):
    port, ref = clients(tmp_path)
    rows = data["orders"]
    first, second = rows[:60], rows[60:]
    for c in (port, ref):
        c.create_set("tpch", "orders", type_name="table")
        c.send_table("tpch", "orders", first)
        c.send_table("tpch", "orders", second, append=True)
    ours, want = port.get_table("tpch", "orders"), ref.get_table("tpch",
                                                                 "orders")
    same_table(ours, want)
    assert ours.num_rows == len(rows)
    assert ours.to_rows(date_cols=("o_orderdate",)) == rows
    a, b = port.analyze_set("tpch", "orders"), ref.analyze_set("tpch",
                                                               "orders")
    assert {c: tuple(s.__dict__.values())[:3] for c, s in a["stats"].items()} \
        == {c: (s.n_rows, s.min_val, s.max_val)
            for c, s in b["stats"].items()}
    assert port.catalog.get_set("tpch", "orders")["meta"] == \
        ref.catalog.get_set("tpch", "orders")["meta"]
    # an append into an empty set makes the relation
    port.create_set("tpch", "fresh", type_name="table")
    port.send_table("tpch", "fresh", first, append=True)
    assert port.get_table("tpch", "fresh").num_rows == 60


def test_table_sets_flush_and_load(tmp_path, data):
    cfg = Configuration(root_dir=str(tmp_path / "port"))
    c = Client(cfg, device="cpu")
    c.create_database("tpch")
    c.create_set("tpch", "customer", type_name="table",
                 persistence="persistent")
    table = c.send_table("tpch", "customer", data["customer"])
    c.flush_data()
    c2 = Client(cfg, device="cpu")
    c2.store.load_set(SetIdentifier("tpch", "customer"))
    back = c2.store.get_items(SetIdentifier("tpch", "customer"))[0]
    assert back.to_rows() == table.to_rows()
    assert back.device.type == "cpu"


def test_out_of_slice_relations_raise(tmp_path, data):
    """A paged relation is ported (``tests/test_torch_paged_relations.py``),
    but a paged and placed one is ROADMAP.md A4, and so is a placed
    (row-sharded) one when data arrives; a paged object set is ported
    (``tests/test_torch_paged_objects.py``); an append to a set holding
    other items refuses."""
    port, _ = clients(tmp_path)
    port.create_set("tpch", "p", type_name="table", storage="paged")
    port.send_table("tpch", "p", data["region"])
    assert port.analyze_set("tpch", "p")["num_rows"] == len(data["region"])
    # a paged and placed relation and a placed one (once ROADMAP.md A4)
    # are ported: tests/test_torch_sharded_relational.py
    port.create_set("tpch", "pp", type_name="table", storage="paged",
                    placement=Placement.data_parallel(ndim=1))
    port.send_table("tpch", "pp", data["region"])
    assert port.analyze_set("tpch", "pp")["num_rows"] == len(data["region"])
    port.create_set("tpch", "po", type_name="object", storage="paged")
    port.send_data("tpch", "po", data["region"])
    assert list(port.get_set_iterator("tpch", "po")) == data["region"]
    port.create_set("tpch", "placed", type_name="table",
                    placement=Placement.data_parallel(ndim=1))
    port.send_table("tpch", "placed", data["region"])
    assert port.get_table("tpch", "placed").to_rows() == \
        port.get_table("tpch", "p").to_rows()
    port.create_set("tpch", "objs", type_name="object")
    port.send_data("tpch", "objs", [1, 2])
    with pytest.raises(ValueError, match="single-relation"):
        port.send_table("tpch", "objs", data["region"], append=True)
    with pytest.raises(ValueError, match="tables"):
        port.get_table("tpch", "objs")
    with pytest.raises(KeyError, match="unknown suite query"):
        dag.suite_sink_for(port, "tpch", "q99")


# ------------------------------------------------------------------ sinks
def test_q01_and_q06_sinks(tmp_path, data):
    force("plain")
    port, ref = clients(tmp_path)
    load_rows(port, ref, data)
    for sink, jsink in ((dag.q01_sink("tpch"), jdag.q01_sink("tpch")),
                        (dag.q06_sink("tpch"), jdag.q06_sink("tpch")),
                        (dag.q06_sink("tpch", d0="1995-01-01",
                                      d1="1996-01-01", disc=0.05, qty=30),
                         jdag.q06_sink("tpch", d0="1995-01-01",
                                       d1="1996-01-01", disc=0.05, qty=30))):
        ours = dag.run_query(port, sink)
        want = jdag.run_query(ref, jsink)
        same_table(ours, want)
        rows_close(ours.to_rows(), want.to_rows())
        # the result is materialised as its output set's relation
        same_table(port.get_table("tpch", sink.set_name), want)
    assert dag.q01_sink("tpch").inputs[0].fold is not None


@pytest.mark.parametrize("segment", ["BUILDING", "MACHINERY", "NOPE"])
def test_q03_sink_for(tmp_path, data, segment):
    force("plain")
    port, ref = clients(tmp_path)
    load_rows(port, ref, data)
    ours = dag.run_query(port, dag.q03_sink_for(port, "tpch", segment))
    want = jdag.run_query(ref, jdag.q03_sink_for(ref, "tpch", segment))
    same_table(ours, want)
    rows_close(dag.q03_rows(ours), jdag.q03_rows(want))
    assert (len(dag.q03_rows(ours)) == 0) == (segment == "NOPE")


def test_q03_build_probe_pair(tmp_path, data):
    force("plain")
    port, ref = clients(tmp_path)
    load_rows(port, ref, data)
    res = []
    for c, d in ((port, dag), (ref, jdag)):
        info = c.analyze_set("tpch", "orders")
        cust = c.analyze_set("tpch", "customer")
        code = cust["dicts"]["c_mktsegment"].index("BUILDING")
        d.run_query(c, d.q03_build_sink(
            "tpch", cust["stats"]["c_custkey"].key_space, code))
        res.append(d.run_query(c, d.q03_probe_sink(
            "tpch", info["stats"]["o_orderkey"].key_space)))
    same_table(*res)
    # the staged pair equals the one-DAG sink
    one = dag.run_query(port, dag.q03_sink_for(port, "tpch"))
    assert dag.q03_rows(res[0]) == dag.q03_rows(one)
    # the build stage is stored as a filtered relation
    built = port.get_table("tpch", "q03_build")
    same(built.mask(), ref.get_table("tpch", "q03_build").mask())


def test_q03_probe_fold_merge(tmp_path):
    """``merge`` re-takes the top k of two partitions' outputs: ties to
    the lower position, invalid and non-positive revenues dropped."""
    import jax.numpy as jnp

    from netsdb_tpu.relational.planner import JoinPlan as JJoinPlan
    from netsdb_tpu_torch.relational.planner import JoinPlan

    rng = np.random.default_rng(77)
    parts = []
    for n in (6, 9):
        parts.append(dict(okey=rng.integers(0, 100, n).astype(np.int32),
                          odate=rng.integers(19920101, 19981231,
                                             n).astype(np.int32),
                          revenue=rng.integers(-2, 5, n).astype(np.float32),
                          valid=rng.random(n) > 0.2))
    ours = dag.q03_probe_fold(19950315, 4, JoinPlan("lut", 100)).merge(
        *[ColumnTable({k: torch.from_numpy(v) for k, v in p.items()
                       if k != "valid"}, valid=torch.from_numpy(p["valid"]))
          for p in parts])
    want = jdag.q03_probe_fold(19950315, 4, JJoinPlan("lut", 100)).merge(
        *[JTable({k: jnp.asarray(v) for k, v in p.items() if k != "valid"},
                 valid=jnp.asarray(p["valid"])) for p in parts])
    same_table(ours, want)


# ------------------------------------------------------------ the suite
def run_suite(port, ref, qname, tag):
    got = dag.run_query(port, dag.suite_sink_for(port, "tpch", qname),
                        job_name=f"{tag}-{qname}")
    want = jdag.run_query(ref, jdag.suite_sink_for(ref, "tpch", qname),
                          job_name=f"{tag}-{qname}")
    assert isinstance(got, tuple) and len(got) == len(want)
    for a, b in zip(got, want):
        same(a, b)
    return got


@pytest.mark.parametrize("qname", QUERIES)
def test_suite_sink(tmp_path, data, qname):
    force("plain")
    port, ref = clients(tmp_path)
    load_rows(port, ref, data)
    got = run_suite(port, ref, qname, "plain")
    # the output set holds the core's raw tensors
    stored = port.store.get_items(SetIdentifier("tpch", f"{qname}_out"))
    assert len(stored) == len(got)


@pytest.mark.parametrize("qname", QUERIES)
def test_suite_sink_over_invalid_rows_and_orphan_keys(tmp_path, data, qname):
    """Invalid rows fold to -1 keys and 0 measures; the reference then
    gathers with those -1 keys (wrapping to the last element, or the
    fill past the end) and the port reproduces each value, reading
    clamped indices."""
    force("masked")
    port, ref = clients(tmp_path)
    load_tables(port, ref, damaged(data))
    run_suite(port, ref, qname, "masked")


def test_suite_label_carries_the_statistics(tmp_path, data):
    port, ref = clients(tmp_path)
    load_rows(port, ref, data)
    first = dag.suite_sink_for(port, "tpch", "q03").inputs[0].label
    port.send_table("tpch", "orders", data["orders"][:50])
    assert dag.suite_sink_for(port, "tpch", "q03").inputs[0].label != first
    assert first.startswith("suite:q03:{}:")
