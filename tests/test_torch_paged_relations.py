"""Paged relation sets through the port's ``Client`` against the JAX
package's paged sets, on the CPU.

Both clients page the facts of ``workloads.tpch.generate(scale=8,
seed=3)`` (lineitem, orders and partsupp, as the reference's
``tests/test_paged_sets.py``) under the reference tests' arena,
``page_size_bytes=4096, page_pool_bytes=16384`` — about 25 times smaller
than the data, so every query streams and the arena spills — and run
the same DAGs: ``suite_sink_for`` for all ten queries, ``q01_sink``,
``q06_sink``, ``q03_sink_for`` and the Q03 build/probe pair. Each result
is held to the reference's paged run and to the port's resident run:
integers exactly, floats at the reference tests' ``rtol=1e-4,
atol=1e-3``. Also covered: the one-pass grace hash with both sides
paged, a paged dimension without a merge, the fold-less consumer,
``analyze_set``/``get_table``, ``remove_set``, flush and reload, appends
(their split invariance, new dictionary entries, the atomic rollback),
the dirty-range log and its bound."""

import contextlib

import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational import tuning as JT
from netsdb_tpu.relational.queries import tables_from_rows as jax_tables
from netsdb_tpu.workloads import tpch
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational import tuning as T
from netsdb_tpu_torch.relational.outofcore import PagedColumns
from netsdb_tpu_torch.relational.queries import (COLUMNAR_QUERIES, cq01,
                                                 cq03, cq06,
                                                 tables_from_rows)
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage.paged import PagedTensorStore
from netsdb_tpu_torch.storage.store import SetIdentifier

torch.set_num_threads(2)

SCALE = 8
PAGED_FACTS = ("lineitem", "orders", "partsupp")
ALL_PAGED = PAGED_FACTS + ("customer", "part", "supplier")
ARENA = dict(page_size_bytes=4096, page_pool_bytes=16384)
TOL = dict(rtol=1e-4, atol=1e-3)
PLAIN = dict(segment_dense_limit=1e9, count_grid_limit=1e9,
             join_lut_factor=1e9, join_lut_max_bytes=1 << 30)


@pytest.fixture(autouse=True)
def _plain_plans():
    # both packages plan LUT joins and dense reductions alike
    clear_compiled_cache()
    for k, v in PLAIN.items():
        JT.set_override(k, v, kind="cpu")
        T.set_override(k, v, kind="cpu")
    yield
    JT.clear_overrides()
    T.clear_overrides()


@pytest.fixture(scope="module")
def data():
    return tpch.generate(scale=SCALE, seed=3)


@pytest.fixture(scope="module")
def tables(data):
    return tables_from_rows(data, device="cpu")


@pytest.fixture(scope="module")
def jtables(data):
    return jax_tables(data)


def _port(tmp_path, tables, facts=PAGED_FACTS, name="paged", **arena):
    c = Client(Configuration(root_dir=str(tmp_path / name),
                             **{**ARENA, **arena}), device="cpu")
    c.create_database("d")
    for n, t in tables.items():
        c.create_set("d", n, type_name="table",
                     storage="paged" if n in facts else "memory")
        c.send_table("d", n, t)
    return c


def _jax(tmp_path, jtables, facts=PAGED_FACTS, **arena):
    c = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax"),
                                   **{**ARENA, **arena}))
    c.create_database("d")
    for n, t in jtables.items():
        c.create_set("d", n, type_name="table",
                     storage="paged" if n in facts else "memory")
        c.send_table("d", n, t)
    return c


@pytest.fixture()
def paged(tmp_path, tables):
    return _port(tmp_path, tables)


@pytest.fixture(scope="module")
def resident(tmp_path_factory, tables):
    return _port(tmp_path_factory.mktemp("resident"), tables, facts=())


def same(ours, ref):
    got = ours.detach().cpu().numpy() if torch.is_tensor(ours) \
        else np.asarray(ours)
    want = ref.detach().cpu().numpy() if torch.is_tensor(ref) \
        else np.asarray(ref)
    assert got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def spilled(client):
    st = client.store.page_store().stats()
    assert st["spills"] > 0 and st["loads"] > 0, st


def suite(client, q, ref=False):
    d = jdag if ref else dag
    return d.run_query(client, d.suite_sink_for(client, "d", q),
                       job_name=f"suite-{q}")


# ------------------------------------------------ the same sinks, paged
@pytest.mark.parametrize("qname", sorted(COLUMNAR_QUERIES))
def test_suite_sink_runs_paged(qname, tmp_path, paged, resident, jtables):
    """All ten suite queries over paged facts stream through their folds
    and match the reference's paged run and the port's resident run."""
    jc = _jax(tmp_path, jtables)
    ours, ref, res = (suite(paged, qname), suite(jc, qname, ref=True),
                      suite(resident, qname))
    assert len(ours) == len(ref) == len(res)
    for a, b, r in zip(ours, ref, res):
        same(a, b)
        same(a, r)
    spilled(paged)
    assert staging.active_count() == 0


def test_q01_q06_q03_sinks_run_paged(tmp_path, paged, tables, jtables):
    jc = _jax(tmp_path, jtables)
    out = dag.run_query(paged, dag.q01_sink("d"))
    jout = jdag.run_query(jc, jdag.q01_sink("d"))
    assert out.dicts == jout.dicts
    for col in jout.cols:
        same(out[col], jout[col])
    got = {(r["l_returnflag"], r["l_linestatus"]): r for r in out.to_rows()}
    for key, v in cq01(tables):
        assert got[key]["count"] == v["count"]
        assert got[key]["sum_charge"] == pytest.approx(v["sum_charge"],
                                                       rel=1e-4)
    assert set(paged.get_table("d", "q01_out").cols) == set(out.cols)
    q6 = dag.run_query(paged, dag.q06_sink("d"))
    same(q6["revenue"], jdag.run_query(jc, jdag.q06_sink("d"))["revenue"])
    assert float(q6["revenue"][0]) == pytest.approx(cq06(tables)[0][1],
                                                    rel=1e-4)
    rows = dag.q03_rows(dag.run_query(paged, dag.q03_sink_for(paged, "d")))
    jrows = jdag.q03_rows(jdag.run_query(jc, jdag.q03_sink_for(jc, "d")))
    assert [r["okey"] for r in rows] == [r["okey"] for r in jrows] == \
        [r["okey"] for r in cq03(tables)]
    np.testing.assert_allclose([r["revenue"] for r in rows],
                               [r["revenue"] for r in jrows], rtol=1e-4)
    spilled(paged)


def test_q03_unknown_segment_returns_empty(paged):
    out = dag.run_query(paged, dag.q03_sink_for(paged, "d",
                                                segment="NO SUCH"))
    assert dag.q03_rows(out) == []


# ----------------------------------------------- the build side paged
def test_q03_paged_build_set_and_probe(tmp_path, tables, jtables):
    """Stage 1 writes the filtered build side into a paged set of several
    pages; stage 2 probes it through the one-pass grace hash (the probe
    fold declares its keys and a merge). Matches the reference's run and
    the resident engine."""
    rows = {}
    for name, c, d in ((
            "port", _port(tmp_path, tables, facts=("lineitem",),
                          page_size_bytes=1024), dag),
            ("jax", _jax(tmp_path, jtables, facts=("lineitem",),
                         page_size_bytes=1024), jdag)):
        c.create_set("d", "q03_build", type_name="table", storage="paged")
        cust, orders = c.analyze_set("d", "customer"), \
            c.analyze_set("d", "orders")
        c.execute_computations(d.q03_build_sink(
            "d", n_customers=cust["stats"]["c_custkey"].key_space,
            segment_code=cust["dicts"]["c_mktsegment"].index("BUILDING")),
            job_name=f"build-{name}")
        if name == "port":
            bpc = c.store.paged_relation(SetIdentifier("d", "q03_build"))
            assert bpc.num_pages() > 1
            li = c.store.paged_relation(SetIdentifier("d", "lineitem"))
            before = li.pages_streamed
        out = d.run_query(c, d.q03_probe_sink(
            "d", n_orders=orders["stats"]["o_orderkey"].key_space),
            job_name=f"probe-{name}")
        rows[name] = d.q03_rows(out)
        if name == "port":
            assert li.pages_streamed - before == li.num_pages()
            spilled(c)
    want = cq03(tables)
    assert [r["okey"] for r in rows["port"]] == \
        [r["okey"] for r in rows["jax"]] == [r["okey"] for r in want]
    np.testing.assert_allclose([r["revenue"] for r in rows["port"]],
                               [r["revenue"] for r in want], rtol=1e-4)


@pytest.mark.parametrize("qname", ["q02", "q12", "q13"])
def test_suite_queries_with_both_sides_paged(qname, tmp_path, tables,
                                             jtables, resident):
    """Dimensions paged too: the folds' declared join keys take the
    one-pass grace hash (q02 over part, q12 over orders, q13 over
    customer); the results match the reference's and the resident
    run."""
    c, jc = _port(tmp_path, tables, facts=ALL_PAGED), \
        _jax(tmp_path, jtables, facts=ALL_PAGED)
    ours, ref, res = (suite(c, qname), suite(jc, qname, ref=True),
                      suite(resident, qname))
    for a, b, r in zip(ours, ref, res):
        same(a, b)
        same(a, r)
    spilled(c)
    assert staging.active_count() == 0


def test_grace_hash_is_one_pass_over_the_probe(tmp_path, tables):
    """The probe's own pages are read exactly once (the partition pass),
    not once per build page; the spill partitions are freed after."""
    c = _port(tmp_path, tables, facts=ALL_PAGED)
    li = c.store.paged_relation(SetIdentifier("d", "lineitem"))
    orders = c.store.paged_relation(SetIdentifier("d", "orders"))
    assert orders.num_pages() > 1
    used = c.store.page_store().stats()["bytes_allocated"]
    before = li.pages_streamed
    suite(c, "q12")
    assert (li.pages_streamed - before) / li.num_pages() == 1.0
    assert c.store.page_store().stats()["bytes_allocated"] <= used


def test_paged_dim_without_merge_is_assembled(tmp_path, tables, resident):
    """A paged resident of a fold without a merge (q04's orders) is
    assembled on the device once, and a warm request replays it from
    the device cache without reading a page."""
    c = _port(tmp_path, tables, facts=("lineitem", "orders"))
    for a, r in zip(suite(c, "q04"), suite(resident, "q04")):
        same(a, r)
    reads = c.store.page_store().stats()["page_reads"]
    for a, r in zip(suite(c, "q04"), suite(resident, "q04")):
        same(a, r)
    assert c.store.page_store().stats()["page_reads"] == reads


def test_q02_with_only_supplier_paged_assembles_it(tmp_path, tables,
                                                   resident):
    """supplier is not q02's declared build side (p_partkey): it must not
    be partitioned — the winner merge is only right for partitions of
    part — and is assembled instead."""
    c = _port(tmp_path, tables, facts=("partsupp", "supplier"))
    for a, r in zip(suite(c, "q02"), suite(resident, "q02")):
        same(a, r)


def test_foldless_consumer_assembles_once(paged, tables, monkeypatch):
    """A node without a fold over a paged set gets the relation assembled
    once per request however many consumers it has."""
    calls = {"n": 0}
    orig = PagedColumns.to_host_table

    def counting(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(PagedColumns, "to_host_table", counting)
    scan = ScanSet("d", "lineitem")
    s1 = WriteSet(Apply(scan, lambda t: t.select(["l_orderkey"]),
                        label="proj_a"), "d", "out_a")
    s2 = WriteSet(Apply(scan, lambda t: t.select(["l_quantity"]),
                        label="proj_b"), "d", "out_b")
    res = paged.execute_computations(s1, s2, job_name="fallback")
    vals = {i.set: v for i, v in res.items()}
    assert calls["n"] == 1
    np.testing.assert_array_equal(
        vals["out_a"]["l_orderkey"].numpy(),
        tables["lineitem"]["l_orderkey"].numpy())
    assert vals["out_b"].num_rows == tables["lineitem"].num_rows


# ------------------------------------------------- surfaces around paging
def test_analyze_and_get_table_of_a_paged_set(paged, tables, monkeypatch):
    monkeypatch.setattr(PagedColumns, "_raw_unlocked", None)  # no stream
    info = paged.analyze_set("d", "lineitem")
    monkeypatch.undo()
    li = tables["lineitem"]
    assert info["num_rows"] == li.num_rows
    assert info["stats"]["l_orderkey"].max_val == int(li["l_orderkey"].max())
    assert info["dicts"]["l_returnflag"] == li.dicts["l_returnflag"]
    t = paged.get_table("d", "lineitem")
    assert t.device.type == "cpu"
    for name in li.cols:
        np.testing.assert_array_equal(t[name].numpy(), li[name].numpy())
    meta = paged.catalog.get_set("d", "lineitem")["meta"]
    assert meta["num_rows"] == li.num_rows
    with pytest.raises(ValueError, match="paged relation"):
        paged.get_set_iterator("d", "lineitem")


def test_remove_paged_set_frees_arena_pages(tmp_path, tables):
    c = _port(tmp_path, tables, facts=("lineitem",))
    store = c.store.page_store()
    used = store.stats()["bytes_allocated"]
    assert used > 0
    c.remove_set("d", "lineitem")
    assert store.stats()["bytes_allocated"] < used // 4
    assert not c.set_exists("d", "lineitem")


def test_flush_and_reload_comes_back_paged(tmp_path, tables):
    c = _port(tmp_path, tables, facts=("lineitem",))
    ident = SetIdentifier("d", "lineitem")
    c.store.flush(ident)
    c2 = Client(Configuration(root_dir=str(tmp_path / "paged"), **ARENA),
                device="cpu")
    c2.store.load_set(ident)
    assert c2.store.set_stats(ident)["storage"] == "paged"
    pc = c2.store.paged_relation(ident)
    assert isinstance(pc, PagedColumns) and pc.devcache is not None
    t = c2.get_table("d", "lineitem")
    np.testing.assert_array_equal(t["l_orderkey"].numpy(),
                                  tables["lineitem"]["l_orderkey"].numpy())
    out = dag.run_query(c2, dag.q06_sink("d"))
    assert float(out["revenue"][0]) == pytest.approx(cq06(tables)[0][1],
                                                     rel=1e-4)
    # an empty paged set stays paged through a snapshot
    c.create_set("d", "empty", type_name="table", storage="paged")
    c.store.flush(SetIdentifier("d", "empty"))
    c2.store.load_set(SetIdentifier("d", "empty"))
    assert c2.store.storage_of(SetIdentifier("d", "empty")) == "paged"


def test_flush_data_snapshots_persistent_paged_sets(tmp_path, tables):
    c = _port(tmp_path, tables, facts=())
    c.create_set("d", "keep", type_name="table", storage="paged",
                 persistence="persistent")
    c.send_table("d", "keep", tables["orders"])
    c.flush_data()
    c2 = Client(Configuration(root_dir=str(tmp_path / "paged"), **ARENA),
                device="cpu")
    c2.store.load_set(SetIdentifier("d", "keep"))
    assert c2.analyze_set("d", "keep")["num_rows"] == \
        tables["orders"].num_rows


# ------------------------------------------------------------- appends
def test_append_paged_matches_one_ingest(tmp_path, tables):
    li = tables["lineitem"]
    cols = {k: v.numpy() for k, v in li.cols.items()}
    n = li.num_rows
    c = _port(tmp_path, {k: v for k, v in tables.items()
                         if k != "lineitem"}, facts=())
    c.create_set("d", "lineitem", type_name="table", storage="paged")
    c.send_table("d", "lineitem", ColumnTable.from_columns(
        {k: v[:n // 2] for k, v in cols.items()}, li.dicts, device="cpu"))
    c.send_table("d", "lineitem", ColumnTable.from_columns(
        {k: v[n // 2:] for k, v in cols.items()}, li.dicts, device="cpu"),
        append=True)
    info = c.analyze_set("d", "lineitem")
    assert info["num_rows"] == n
    assert info["stats"]["l_orderkey"].key_space == \
        int(cols["l_orderkey"].max()) + 1
    out = dag.run_query(c, dag.q01_sink("d"))
    got = {(r["l_returnflag"], r["l_linestatus"]): r for r in out.to_rows()}
    for key, v in cq01(tables):
        assert got[key]["count"] == v["count"]
        assert got[key]["sum_charge"] == pytest.approx(v["sum_charge"],
                                                       rel=1e-4)
    rows = dag.q03_rows(dag.run_query(c, dag.q03_sink_for(c, "d")))
    assert [r["okey"] for r in rows] == [r["okey"] for r in cq03(tables)]
    spilled(c)
    dirty = c.store.set_stats(SetIdentifier("d", "lineitem"))["dirty_ranges"]
    assert dirty[-1] == (n // 2, n)


def test_append_remaps_new_dictionary_entries(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "a"), **ARENA),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "ev", type_name="table", storage="paged")
    c.send_table("d", "ev", [{"kind": "x", "n": i} for i in range(100)])
    c.send_table("d", "ev", [{"kind": "y", "n": i} for i in range(50)],
                 append=True)
    t = c.get_table("d", "ev")
    kinds = [t.dicts["kind"][int(code)] for code in t["kind"].numpy()]
    assert kinds.count("x") == 100 and kinds.count("y") == 50
    with pytest.raises(ValueError, match="dict-encoded in the stored"):
        c.send_table("d", "ev", ColumnTable(
            {"kind": torch.tensor([7], dtype=torch.int32),
             "n": torch.tensor([2], dtype=torch.int32)}), append=True)


def test_append_failure_rolls_back_atomically(tmp_path, monkeypatch):
    c = Client(Configuration(root_dir=str(tmp_path / "rb"), **ARENA),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "ev", type_name="table", storage="paged")
    c.send_table("d", "ev", [{"kind": "x", "n": i, "w": float(i)}
                             for i in range(100)])
    pc = c.store.paged_relation(SetIdentifier("d", "ev"))
    dicts, stats, rows = ({k: list(v) for k, v in pc.dicts.items()},
                          dict(pc.stats), pc.num_rows)
    orig = PagedTensorStore.put

    def failing(self, name, dense, row_block=None, append=False):
        if append and name.endswith(".float"):
            raise MemoryError("synthetic arena exhaustion")
        return orig(self, name, dense, row_block=row_block, append=append)

    monkeypatch.setattr(PagedTensorStore, "put", failing)
    with pytest.raises(MemoryError):
        c.send_table("d", "ev", [{"kind": "z", "n": 7, "w": 7.0}],
                     append=True)
    monkeypatch.setattr(PagedTensorStore, "put", orig)
    assert (pc.num_rows, pc.dicts, pc.stats) == (rows, dicts, stats)
    t = c.get_table("d", "ev")
    assert t.num_rows == rows
    assert {t.dicts["kind"][int(k)] for k in t["kind"].numpy()} == {"x"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_split_invariance_property(tmp_path, tables, seed):
    """lineitem sent as four batches of random sizes gives the same Q06
    and Q01 as one ingest, whatever the split."""
    rng = np.random.default_rng(seed)
    li = tables["lineitem"]
    n = li.num_rows
    cuts = np.sort(rng.choice(np.arange(1, n), size=3, replace=False))
    bounds = [0, *cuts.tolist(), n]
    cols = {k: v.numpy() for k, v in li.cols.items()}
    c = Client(Configuration(root_dir=str(tmp_path / f"p{seed}"), **ARENA),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "lineitem", type_name="table", storage="paged")
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        c.send_table("d", "lineitem", ColumnTable.from_columns(
            {k: v[lo:hi] for k, v in cols.items()}, li.dicts, device="cpu"),
            append=i > 0)
    assert c.analyze_set("d", "lineitem")["num_rows"] == n
    out = dag.run_query(c, dag.q06_sink("d"))
    assert float(out["revenue"][0]) == pytest.approx(cq06(tables)[0][1],
                                                     rel=1e-4)
    q1 = dag.run_query(c, dag.q01_sink("d"))
    got = {(r["l_returnflag"], r["l_linestatus"]): r["count"]
           for r in q1.to_rows()}
    assert got == {k: v["count"] for k, v in cq01(tables)}


def test_dirty_log_is_bounded(tmp_path):
    """Appends log their row ranges (creating and replacing the set log
    whole-set entries); past ``device_cache_dirty_log`` entries the log
    folds into one whole-set entry and every cached block of the set
    drops."""
    c = Client(Configuration(root_dir=str(tmp_path / "dl"),
                             device_cache_dirty_log=5, **ARENA),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "t", type_name="table", storage="paged")
    ident = SetIdentifier("d", "t")
    batch = lambda i: [{"k": i * 1000 + j, "v": float(j)}  # noqa: E731
                       for j in range(1000)]
    c.send_table("d", "t", batch(0))
    c.send_table("d", "t", batch(1), append=True)
    assert c.store.set_stats(ident)["dirty_ranges"][-1] == (1000, 2000)
    pc = c.store.paged_relation(ident)
    with contextlib.closing(pc.stream_tables()) as s:
        list(s)  # installs every block
    cache = c.store.device_cache()
    cached = cache.stats()["entries"]
    c.send_table("d", "t", batch(2), append=True)
    assert cache.stats()["entries"] == cached  # the tail was not cached
    assert c.store.set_stats(ident)["dirty_ranges"] == [
        (0, None)] * 3 + [(1000, 2000), (2000, 3000)]
    c.send_table("d", "t", batch(3), append=True)
    assert c.store.set_stats(ident)["dirty_ranges"] == [(0, None)]
    assert cache.stats()["entries"] == 0
    assert c.analyze_set("d", "t")["num_rows"] == 4000


def test_append_waits_for_streams_and_appends_serialise(tmp_path):
    """An append waits for the relation's open stream (its pages must not
    grow under it), and concurrent appends on several threads all land:
    no lost batch, no torn dictionary."""
    import sys
    import threading

    c = Client(Configuration(root_dir=str(tmp_path / "s"), **ARENA),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "t", type_name="table", storage="paged")
    ident = SetIdentifier("d", "t")
    c.send_table("d", "t", [{"kind": "a", "n": j} for j in range(2000)])
    pc = c.store.paged_relation(ident)
    stream = pc.stream_tables()
    first = next(stream)
    assert first.num_rows > 0
    done = threading.Event()
    t = threading.Thread(target=lambda: (c.send_table(
        "d", "t", [{"kind": "b", "n": 1}], append=True), done.set()))
    t.start()
    assert not done.wait(0.3)  # held back by the open stream
    rows = first.mask().sum().item() + sum(
        int(ch.mask().sum()) for ch in stream)
    stream.close()
    t.join(timeout=30)
    assert not t.is_alive() and done.is_set() and rows == 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=c.send_table, args=(
            "d", "t", [{"kind": f"k{i}", "n": j} for j in range(50)]),
            kwargs={"append": True}) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    t = c.get_table("d", "t")
    assert t.num_rows == pc.num_rows == 2001 + 8 * 50
    kinds = [t.dicts["kind"][k] for k in t["kind"].tolist()]
    assert all(kinds.count(f"k{i}") == 50 for i in range(8))
    assert staging.active_count() == 0


def test_update_columns_logs_column_ranges(tmp_path):
    """An update in place through the store rewrites the column's pages,
    logs a column-keyed dirty range and refreshes the statistics; a
    projected stream of the other column keeps its cached blocks."""
    c = Client(Configuration(root_dir=str(tmp_path / "u"), **ARENA),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "t", type_name="table", storage="paged")
    ident = SetIdentifier("d", "t")
    c.send_table("d", "t", [{"k": j % 50, "v": float(j)}
                            for j in range(3000)])
    pc = c.store.paged_relation(ident)
    with contextlib.closing(pc.stream_tables(columns=["v"])) as s:
        list(s)
    cached = c.store.device_cache().stats()["entries"]
    c.store.update_columns(ident, {"k": np.full(3000, 7, np.int32)})
    assert c.store.set_stats(ident)["dirty_ranges"][-1] == (0, 3000, ("k",))
    assert c.store.device_cache().stats()["entries"] == cached
    assert c.analyze_set("d", "t")["stats"]["k"].max_val == 7
    assert set(c.get_table("d", "t")["k"].tolist()) == {7}
    with pytest.raises(ValueError, match="paged table set"):
        c.create_set("d", "m", type_name="table")
        c.store.update_columns(SetIdentifier("d", "m"), {"k": []})


def test_paged_placed_relation_and_fusion_raise(tmp_path):
    from netsdb_tpu_torch.parallel.placement import Placement

    c = Client(Configuration(root_dir=str(tmp_path / "x")), device="cpu")
    c.create_database("d")
    # a paged and placed relation (once ROADMAP.md A4) is ported
    c.create_set("d", "t", type_name="table", storage="paged",
                 placement=Placement.replicated())
    assert c.store.placement_of(SetIdentifier("d", "t")) == \
        Placement.replicated()
    # fusion is ported and on by default, as in the reference
    assert Configuration().plan_fusion
    assert not Configuration(plan_fusion=False).plan_fusion
