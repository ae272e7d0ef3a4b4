"""Paged record sets of the port (``storage.paged.PagedObjects``) against
the JAX package: host records paged as pickled batches in a spilling
arena, the row TPC-H DAGs streaming over them, appends that never wait
on a live stream, a raising predicate that releases the set's read lock,
flush and reload, and ``objects`` sets that columnarise at ingest."""

import pickle
import threading

import numpy as np
import pytest

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.workloads import tpch as jtpch
from netsdb_tpu_torch import Client, Configuration
from netsdb_tpu_torch.plan.computations import Filter, ScanSet, WriteSet
from netsdb_tpu_torch.storage.paged import PagedObjects, PagedTensorStore
from netsdb_tpu_torch.storage.store import SetIdentifier, SetStore
from netsdb_tpu_torch.workloads import tpch

ARENA = dict(page_size_bytes=4096, page_pool_bytes=16384)
JOIN_TIMEOUT = 30


@pytest.fixture(scope="module")
def data():
    return tpch.generate(scale=3, seed=11)


def _port(tmp_path, **kw):
    return Client(Configuration(root_dir=str(tmp_path / "port"), **ARENA,
                                **kw), device="cpu")


def _load(client, data, paged):
    client.create_database("tpch")
    for name, rows in data.items():
        client.create_set("tpch", name, type_name="object",
                          storage="paged" if name in paged else "memory")
        client.send_data("tpch", name, rows)


@pytest.mark.parametrize("query", sorted(tpch.QUERIES))
def test_row_queries_over_paged_sets_match_the_reference(tmp_path, data,
                                                         query):
    """Every row DAG over lineitem, orders, customer and partsupp paged in a
    spilling 16 KiB arena equals the reference's (with its own paged
    sets) and the port's over memory sets, in order."""
    paged = ("lineitem", "orders", "customer", "partsupp")
    port = _port(tmp_path)
    _load(port, data, paged)
    jax_c = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax"),
                                       **ARENA))
    _load(jax_c, data, paged)
    mem = Client(Configuration(root_dir=str(tmp_path / "mem")), device="cpu")
    _load(mem, data, ())
    got = tpch.run_query(port, query)
    assert got == jtpch.run_query(jax_c, query)
    assert got == tpch.run_query(mem, query)
    stats = port.store.page_store().stats()
    assert stats["spills"] > 0 and stats["page_reads"] > 0
    po = port.store.paged_objects(SetIdentifier("tpch", "lineitem"))
    assert isinstance(po, PagedObjects) and len(po) == len(data["lineitem"])


def test_scan_streams_records_and_set_iterator_matches(tmp_path, data):
    port = _port(tmp_path)
    _load(port, data, ("lineitem",))
    assert list(port.get_set_iterator("tpch", "lineitem")) == \
        data["lineitem"]
    out = port.execute_computations(WriteSet(ScanSet("tpch", "lineitem"),
                                             "tpch", "copy"))
    assert out[SetIdentifier("tpch", "copy")].to_list() == data["lineitem"]
    assert list(port.get_set_iterator("tpch", "copy")) == data["lineitem"]


def test_appends_add_pages_in_order_and_flush_reloads(tmp_path, data):
    c = _port(tmp_path)
    c.create_database("d")
    c.create_set("d", "r", type_name="object", storage="paged",
                 persistence="persistent")
    rows = data["orders"]
    c.send_data("d", "r", rows[:100])
    c.send_data("d", "r", [])
    c.send_data("d", "r", rows[100:])
    ident = SetIdentifier("d", "r")
    assert list(c.get_set_iterator("d", "r")) == rows
    assert c.store.set_stats(ident)["version"] > 0
    c.flush_data()
    c2 = _port(tmp_path)
    c2.store.load_set(ident)
    assert c2.store.storage_of(ident) == "paged"
    assert c2.store.paged_objects(ident).to_list() == rows


def test_pages_respect_the_page_size_as_the_reference(tmp_path):
    from netsdb_tpu.storage.paged import PagedObjects as JaxPagedObjects
    from netsdb_tpu.storage.paged import PagedTensorStore as JaxStore

    page = 1 << 16
    records = [{"blob": bytes(20_000), "i": i} for i in range(40)]
    rec_bytes = len(pickle.dumps(records[0],
                                 protocol=pickle.HIGHEST_PROTOCOL))
    sizes = {}
    for name, (store_cls, po_cls) in {
            "jax": (JaxStore, JaxPagedObjects),
            "port": (PagedTensorStore, PagedObjects)}.items():
        cfg_cls = JaxConfiguration if name == "jax" else Configuration
        cfg = cfg_cls(root_dir=str(tmp_path / name), page_size_bytes=page,
                      page_pool_bytes=64 << 20)
        store = store_cls(cfg, pool_bytes=64 << 20)
        try:
            po = po_cls.ingest(store, "big", records)
            sid = store._set_id("big")
            sizes[name] = [store.backend.page_size(p)
                           for p in store.backend.set_pages(sid)]
            assert [r["i"] for r in po] == list(range(40))
            po2 = po_cls.ingest(store, "huge",
                                [{"x": bytes(3 * page)}, {"y": 1}, {"z": 2}])
            sid2 = store._set_id("huge")
            assert len(store.backend.set_pages(sid2)) == 2
            assert len(list(po2)) == 3
            po.drop()
            with pytest.raises(KeyError, match="dropped"):
                list(po)
            with pytest.raises(KeyError, match="dropped"):
                po.append([1])
        finally:
            store.close()
    assert sizes["port"] == sizes["jax"]
    assert len(sizes["port"]) >= 8
    assert max(sizes["port"]) <= page + 2 * rec_bytes


def test_raising_predicate_releases_the_read_lock(tmp_path):
    """A Filter whose predicate raises mid-stream closes the record
    stream at once: an append right after it does not block, and a
    remove (which waits for every stream of the set) completes."""
    c = _port(tmp_path)
    c.create_database("d")
    c.create_set("d", "r", type_name="object", storage="paged")
    c.send_data("d", "r", [{"i": i} for i in range(500)])
    po = c.store.paged_objects(SetIdentifier("d", "r"))

    def pred(r):
        if r["i"] == 250:
            raise RuntimeError("bad record")
        return True

    sink = WriteSet(Filter(ScanSet("d", "r"), pred, label="raises"),
                    "d", "out")
    with pytest.raises(RuntimeError, match="bad record") as info:
        c.execute_computations(sink)
    assert info.traceback  # the frames stay alive while we check
    assert po.rw._readers == 0
    done = threading.Event()

    def mutate():
        c.send_data("d", "r", [{"i": 500}])
        c.remove_set("d", "r")
        done.set()

    t = threading.Thread(target=mutate, daemon=True)
    t.start()
    t.join(timeout=JOIN_TIMEOUT)
    assert not t.is_alive() and done.is_set(), \
        "a stream left by the raising predicate blocked the set"
    assert po.dropped


def test_append_while_iterating_does_not_deadlock(tmp_path):
    store = SetStore(Configuration(root_dir=str(tmp_path / "s"), **ARENA))
    ident = SetIdentifier("db", "recs")
    store.create_set(ident, storage="paged")
    store.add_data(ident, [{"i": n} for n in range(50)])
    done = threading.Event()

    def append_mid_iteration():
        it = iter(store.get_items(ident)[0])
        next(it)  # holds the read lock
        store.add_data(ident, [{"i": 999}])
        other = SetIdentifier("db", "other")
        store.create_set(other)
        store.add_data(other, [np.ones(4, np.float32)])
        list(it)
        done.set()

    t = threading.Thread(target=append_mid_iteration, daemon=True)
    t.start()
    t.join(timeout=JOIN_TIMEOUT)
    assert not t.is_alive() and done.is_set(), \
        "an append under a live iterator deadlocked"
    got = sorted(r["i"] for r in store.get_items(ident)[0])
    assert got == list(range(50)) + [999]


def test_concurrent_appends_lose_no_batch(tmp_path):
    store = SetStore(Configuration(root_dir=str(tmp_path / "s"), **ARENA))
    ident = SetIdentifier("db", "recs")
    store.create_set(ident, storage="paged")
    store.add_data(ident, [{"w": -1, "i": 0}])

    def writer(w):
        for b in range(10):
            store.add_data(ident, [{"w": w, "i": b * 5 + j}
                                   for j in range(5)])

    threads = [threading.Thread(target=writer, args=(w,), daemon=True)
               for w in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    recs = store.paged_objects(ident).to_list()
    assert len(recs) == 1 + 6 * 50
    for w in range(6):  # each writer's batches stay in its order
        assert [r["i"] for r in recs if r["w"] == w] == list(range(50))


def test_replacing_or_clearing_a_paged_record_set_frees_its_pages(tmp_path):
    c = _port(tmp_path)
    c.create_database("d")
    c.create_set("d", "r", storage="paged")
    c.send_data("d", "r", [{"i": i, "pad": "x" * 100} for i in range(300)])
    ps = c.store.page_store()
    used = ps.stats()["bytes_in_use"]
    assert used > 0
    # a matrix replaces the records; their pages go back to the arena
    c.send_matrix("d", "r", np.ones((8, 8), np.float32), (8, 8))
    assert c.store.paged_objects(SetIdentifier("d", "r")) is None
    assert ps.stats()["bytes_in_use"] < used
    c.send_data("d", "r", [{"i": 1}])
    c.clear_set("d", "r")
    assert c.store.get_items(SetIdentifier("d", "r")) == []
    with pytest.raises(ValueError, match="one matrix"):
        c.send_data("d", "r", [np.ones((2, 2)), np.ones((2, 2))])


@pytest.mark.parametrize("paged", [False, True])
def test_objects_sets_columnarise_at_ingest(tmp_path, paged):
    """``type_name="objects"``: records become one dictionary-encoded
    table (paged: pages of a relation), appends remap the dictionaries,
    an empty batch is a no-op — as in the reference."""
    jc = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    pc = _port(tmp_path)
    for c in (jc, pc):
        c.create_database("o")
        kw = {"storage": "paged"} if paged and c is pc else {}
        c.create_set("o", "recs", type_name="objects", **kw)
        c.send_data("o", "recs", [])
        c.send_data("o", "recs", [{"k": "b", "v": 1}, {"k": "a", "v": 2}])
        c.send_data("o", "recs", [{"k": "c", "v": 3}, {"k": "a", "v": 4}])
    want, got = jc.get_table("o", "recs"), pc.get_table("o", "recs")
    assert got.to_rows() == want.to_rows()
    assert got.dicts["k"] == want.dicts["k"] == ["a", "b", "c"]
    assert pc.store.storage_of(SetIdentifier("o", "recs")) == \
        ("paged" if paged else "memory")
