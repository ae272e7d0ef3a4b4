"""The port's paged relations (``relational/outofcore.py``) against the JAX
package's, on the CPU.

Both packages page the same numpy columns (``workloads.tpch.generate(
scale=3, seed=9)``, as the reference's ``tests/test_outofcore.py``) with
the same row blocking, so both streams cut the same chunks. Covered:
``PagedColumns`` round trips (host and device streams, host and device
assembly), the atomic append and its rollback, ``update_column`` with
per-column cache invalidation, projected streams, the partition hash and
``partition_by_key``, every fold of ``relational/folds.py`` through
``run_fold`` against the reference's fold on the same chunk sequence,
``ooc_q01``/``ooc_q06``/``ooc_q03`` and the two benches. Integers
exactly; floats at the reference tests' ``rtol=1e-4, atol=1e-3``."""

import contextlib
import hashlib

import numpy as np
import pytest
import torch

from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational import outofcore as JO
from netsdb_tpu.relational import tuning as JT
from netsdb_tpu.relational.folds import SUITE_FOLDS as JAX_FOLDS
from netsdb_tpu.relational.queries import tables_from_rows as jax_tables
from netsdb_tpu.relational.stats import analyze_table as jax_analyze
from netsdb_tpu.storage.paged import PagedTensorStore as JaxStore
from netsdb_tpu.workloads import tpch
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational import outofcore as O
from netsdb_tpu_torch.relational import tuning as T
from netsdb_tpu_torch.relational.folds import SUITE_FOLDS
from netsdb_tpu_torch.relational.queries import cq01, cq03, cq06
from netsdb_tpu_torch.relational.queries import tables_from_rows
from netsdb_tpu_torch.relational.stats import analyze_table
from netsdb_tpu_torch.storage.devcache import DeviceBlockCache
from netsdb_tpu_torch.storage.paged import PagedTensorStore

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-3)
# LUT joins and dense reductions on both sides, so both plan alike
PLAIN = dict(segment_dense_limit=1e9, count_grid_limit=1e9,
             join_lut_factor=1e9, join_lut_max_bytes=1 << 30)


@pytest.fixture(autouse=True)
def _plain_plans():
    clear_compiled_cache()
    for k, v in PLAIN.items():
        JT.set_override(k, v, kind="cpu")
        T.set_override(k, v, kind="cpu")
    yield
    JT.clear_overrides()
    T.clear_overrides()


@pytest.fixture(scope="module")
def data():
    return tpch.generate(scale=3, seed=9)


@pytest.fixture(scope="module")
def tables(data):
    return tables_from_rows(data, device="cpu")


@pytest.fixture(scope="module")
def jtables(data):
    return jax_tables(data)


def _store(tmp_path, pool=None, page=1 << 14, name="port"):
    cfg = Configuration(root_dir=str(tmp_path / name), page_size_bytes=page)
    return PagedTensorStore(cfg, pool_bytes=pool)


def _jstore(tmp_path, pool=None, page=1 << 14):
    cfg = JaxConfiguration(root_dir=str(tmp_path / "jax"),
                           page_size_bytes=page)
    return JaxStore(cfg, pool_bytes=pool)


def same(ours, ref):
    got = ours.detach().cpu().numpy() if torch.is_tensor(ours) \
        else np.asarray(ours)
    want = np.asarray(ref)
    assert got.shape == want.shape
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------- PagedColumns
def test_paged_columns_round_trip(tmp_path, tables):
    li = tables["lineitem"]
    store = _store(tmp_path)
    pc = O.PagedColumns.from_table(store, "lineitem", li, O.Q01_COLUMNS)
    assert pc.device.type == "cpu" and pc.num_pages() > 1
    seen = 0
    for cols, valid, start in pc.stream(device=False):
        n = int(valid.sum())
        assert start == seen
        np.testing.assert_array_equal(
            cols["l_quantity"][:n], li["l_quantity"].numpy()[seen:seen + n])
        seen += n
    assert seen == li.num_rows
    # the device stream: the same rows, padded to the bucket
    seen = 0
    with contextlib.closing(pc.stream()) as chunks:
        for cols, valid, start in chunks:
            assert valid.shape[0] == pc.pad_rows()
            n = int(valid.sum())
            np.testing.assert_array_equal(
                cols["l_shipdate"][:n].numpy(),
                li["l_shipdate"].numpy()[seen:seen + n])
            seen += n
    assert seen == li.num_rows
    parts = list(pc.stream_host_tables())
    assert [t.num_rows for t in parts] == [e - s for s, e in
                                           pc.block_ranges()]
    np.testing.assert_array_equal(
        np.concatenate([t["l_tax"].numpy() for t in parts]),
        li["l_tax"].numpy())
    host, dev = pc.to_host_table(), pc.to_table()
    for name in O.Q01_COLUMNS:
        np.testing.assert_array_equal(host[name].numpy(), li[name].numpy())
        np.testing.assert_array_equal(dev[name].numpy(), li[name].numpy())
    assert host.dicts == {n: li.dicts[n] for n in li.dicts
                          if n in O.Q01_COLUMNS}
    assert staging.active_count() == 0
    store.close()


def test_chunks_match_the_reference(tmp_path, tables, jtables):
    """The same row blocking cuts the same chunks: every chunk table of
    ``stream_tables`` equals the reference's, ``_rowid`` and mask
    included."""
    li, jli = tables["lineitem"], jtables["lineitem"]
    pc = O.PagedColumns.from_table(_store(tmp_path), "li", li,
                                   O.Q03_COLUMNS, row_block=700)
    jpc = JO.PagedColumns.from_table(_jstore(tmp_path), "li", jli,
                                     O.Q03_COLUMNS, row_block=700)
    assert pc.pad_rows() == jpc.pad_rows()
    with contextlib.closing(pc.stream_tables()) as a, \
            contextlib.closing(jpc.stream_tables()) as b:
        pairs = list(zip(a, b))
    assert len(pairs) == jpc.num_pages() == pc.num_pages()
    for ours, ref in pairs:
        assert set(ours.cols) == set(ref.cols)
        for name in ref.cols:
            same(ours[name], ref[name])
        same(ours.mask(), ref.mask())


def test_ingest_stats_and_append_match_the_reference(tmp_path, tables,
                                                     jtables):
    li = tables["lineitem"]
    cols = {n: li[n].numpy() for n in O.Q03_COLUMNS}
    half = li.num_rows // 2
    pc = O.PagedColumns.ingest(_store(tmp_path), "li",
                               {n: c[:half] for n, c in cols.items()},
                               row_block=512, device="cpu")
    jpc = JO.PagedColumns.ingest(_jstore(tmp_path), "li",
                                 {n: c[:half] for n, c in cols.items()},
                                 row_block=512)
    for p in (pc, jpc):
        p.append({n: c[half:] for n, c in cols.items()})
    assert pc.num_rows == jpc.num_rows == li.num_rows
    assert pc.block_ranges() == jpc.block_ranges()
    assert pc.int_names == jpc.int_names
    assert pc.float_names == jpc.float_names
    for n, st in jpc.stats.items():
        assert (pc.stats[n].n_rows, pc.stats[n].min_val,
                pc.stats[n].max_val) == (st.n_rows, st.min_val, st.max_val)
    host = pc.to_host_table()
    for n in O.Q03_COLUMNS:
        np.testing.assert_array_equal(host[n].numpy(), cols[n])


def test_append_rolls_back_both_matrices(tmp_path, tables, monkeypatch):
    """A failure writing the float matrix rolls the int matrix back too:
    the relation keeps its rows, pages, statistics and contents."""
    li = tables["lineitem"]
    cols = {n: li[n].numpy() for n in O.Q03_COLUMNS}
    store = _store(tmp_path)
    pc = O.PagedColumns.ingest(store, "li", cols, row_block=512,
                               device="cpu")
    pages, rows, stats = pc.num_pages(), pc.num_rows, dict(pc.stats)
    orig = PagedTensorStore.put

    def failing(self, name, dense, row_block=None, append=False):
        if append and name.endswith(".float"):
            raise MemoryError("synthetic arena exhaustion")
        return orig(self, name, dense, row_block=row_block, append=append)

    monkeypatch.setattr(PagedTensorStore, "put", failing)
    with pytest.raises(MemoryError):
        pc.append({n: c[:1000] for n, c in cols.items()})
    monkeypatch.setattr(PagedTensorStore, "put", orig)
    assert (pc.num_pages(), pc.num_rows, pc.stats) == (pages, rows, stats)
    assert store.num_blocks("li.int") == store.num_blocks("li.float")
    host = pc.to_host_table()
    for n in O.Q03_COLUMNS:
        np.testing.assert_array_equal(host[n].numpy(), cols[n])
    with pytest.raises(ValueError, match="schema"):
        pc.append({"l_orderkey": cols["l_orderkey"]})
    with pytest.raises(TypeError, match="int-classified"):
        pc.append({**cols, "l_shipdate": cols["l_shipdate"] * 1.0})


def _cached_relation(tmp_path, n=6000):
    """An unbound relation bound by hand to a partial device cache."""
    rng = np.random.default_rng(0)
    cols = {"k": rng.integers(0, 100, n).astype(np.int32),
            "v": rng.uniform(0, 1, n).astype(np.float32)}
    store = _store(tmp_path, page=4096)
    pc = O.PagedColumns.ingest(store, "t", cols, device="cpu")
    pc.devcache = DeviceBlockCache(1 << 24, partial=True)
    pc.cache_scope = "d:t"
    pc.cache_version_fn = lambda: 1
    return pc, cols


def _consume(pc, columns=None):
    with contextlib.closing(pc.stream_tables(columns=columns)) as s:
        return [{k: v.numpy().copy() for k, v in t.cols.items()} for t in s]


def test_update_column_keeps_other_columns_blocks(tmp_path):
    """Updating one column in place drops only the cached blocks of
    streams that held it: the other column's projected stream serves
    from the cache with no page read; the touched one re-stages and sees
    the new values."""
    pc, cols = _cached_relation(tmp_path)
    cache, store = pc.devcache, pc.store
    _consume(pc, ["v"])
    _consume(pc, ["k"])
    nblocks = len(pc.block_ranges())
    assert cache.stats()["entries"] == 2 * nblocks
    assert cache.has_scope("d:t") and not cache.has_scope("d:u")
    epoch = cache.scope_epoch("d:t")
    new_k = np.arange(len(cols["k"]), dtype=np.int32) % 7
    pc.update_column("k", new_k)
    assert cache.scope_epoch("d:t") == epoch + 1  # in-flight installs refused
    st = cache.stats()
    assert st["entries"] == nblocks and st["dirty_invalidations"] == nblocks
    reads = store.stats()["page_reads"]
    got_v = _consume(pc, ["v"])
    assert store.stats()["page_reads"] == reads  # served from the cache
    rows = len(cols["v"])
    np.testing.assert_array_equal(
        np.concatenate([t["v"][t["_rowid"] < rows] for t in got_v]),
        cols["v"])
    got_k = _consume(pc, ["k"])
    assert store.stats()["page_reads"] == reads + nblocks
    np.testing.assert_array_equal(
        np.concatenate([t["k"][t["_rowid"] < rows] for t in got_k]), new_k)
    assert pc.stats["k"].max_val == 6
    # an unprojected stream holds every column: any update drops it
    _consume(pc)
    pc.update_column("v", np.zeros(rows, np.float32))
    assert not any(not isinstance(k[-2], frozenset)
                   for k in cache._entries)
    pc.drop()
    assert not cache.has_scope("d:t")
    with pytest.raises(KeyError):
        pc.update_column("nope", new_k)
    with pytest.raises(ValueError):
        pc.update_column("v", np.zeros(rows - 1, np.float32))
    with pytest.raises(TypeError):
        pc.update_column("k", np.zeros(rows, np.float32))


def test_projection_reads_only_the_requested_matrices(tmp_path):
    pc, cols = _cached_relation(tmp_path)
    pc.devcache = None
    nblocks, store = len(pc.block_ranges()), pc.store
    reads = store.stats()["page_reads"]
    got = _consume(pc, ["v"])
    assert store.stats()["page_reads"] == reads + nblocks  # floats only
    assert all(set(t) == {"v", "_rowid"} for t in got)
    _consume(pc)
    assert store.stats()["page_reads"] == reads + 3 * nblocks
    with pytest.raises(KeyError):
        _consume(pc, ["nope"])
    assert staging.active_count() == 0


def test_cached_chunks_are_never_written(tmp_path, tables):
    """Every suite query folded twice over a warm paged client leaves the
    cached chunks' bytes as they were, and both warm runs agree exactly
    (a step that wrote into a chunk would corrupt the next request)."""
    from netsdb_tpu_torch import Client

    c = Client(Configuration(root_dir=str(tmp_path / "c"),
                             page_size_bytes=4096, page_pool_bytes=16384),
               device="cpu")
    c.create_database("d")
    for name, t in tables.items():
        c.create_set("d", name, type_name="table",
                     storage="paged" if name in ("lineitem", "orders",
                                                 "partsupp") else "memory")
        c.send_table("d", name, t)
    cache = c.store.device_cache()

    def digest():
        h = hashlib.blake2s()
        for key in sorted(cache._entries, key=repr):
            for t in cache._entries[key][0]:
                for name in sorted(t.cols):
                    h.update(t.cols[name].numpy().tobytes())
                h.update(t.mask().numpy().tobytes())
        return h.hexdigest()

    sinks = {q: dag.suite_sink_for(c, "d", q) for q in SUITE_FOLDS}
    for q, s in sinks.items():
        dag.run_query(c, s)  # installs
    before = digest()
    assert cache.stats()["entries"] > 0
    runs = [{q: dag.run_query(c, s) for q, s in sinks.items()}
            for _ in range(2)]
    assert digest() == before
    for q in sinks:
        for a, b in zip(runs[0][q], runs[1][q]):
            assert torch.equal(a, b), q


def test_a_raising_step_raises_and_releases_the_stream(tmp_path, tables):
    """A step that raises mid-stream reaches the caller as it is; the
    staging thread stops and the relation's read lock is released (an
    append, which takes the write lock, goes through)."""
    from netsdb_tpu_torch.plan.fold import single_pass

    li = tables["lineitem"]
    pc = O.PagedColumns.from_table(_store(tmp_path), "li", li,
                                   O.Q03_COLUMNS, row_block=500)
    calls = {"n": 0}

    def step(st, t):
        calls["n"] += 1
        if calls["n"] == 2:
            raise ValueError("step failed")
        return st

    with pytest.raises(ValueError, match="step failed"):
        O.run_fold(single_pass(lambda prev, src: 0, step,
                               lambda st, src: st), pc)
    assert staging.active_count() == 0
    pc.append({n: li[n].numpy()[:10] for n in O.Q03_COLUMNS})
    assert pc.num_rows == li.num_rows + 10


# ------------------------------------------------------------- partitioning
def test_mix_partition_key_matches_the_reference():
    keys = np.concatenate([np.arange(-5, 5000, dtype=np.int32) * 8,
                           np.asarray([2**31 - 1], np.int32)])
    np.testing.assert_array_equal(O.mix_partition_key(keys),
                                  JO.mix_partition_key(keys))


def test_partition_by_key_matches_the_reference(tmp_path, tables, jtables):
    li, jli = tables["lineitem"], jtables["lineitem"]
    pc = O.PagedColumns.from_table(_store(tmp_path), "li", li,
                                   O.Q03_COLUMNS, row_block=900)
    jpc = JO.PagedColumns.from_table(_jstore(tmp_path), "li", jli,
                                     O.Q03_COLUMNS, row_block=900)
    ours = O.partition_by_key(pc, "l_orderkey", 4, keep_rowid=True,
                              columns=("l_shipdate",))
    ref = JO.partition_by_key(jpc, "l_orderkey", 4, keep_rowid=True,
                              columns=("l_shipdate",))
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.num_rows == b.num_rows
        ta, tb = a.to_host_table(), b.to_host_table()
        assert set(ta.cols) == {"l_orderkey", "l_shipdate", "_rowid0"}
        for name in tb.cols:
            same(ta[name], tb[name])
    assert sum(p.num_rows for p in ours if p is not None) == li.num_rows


# ------------------------------------------------------------- the folds
_TABLES = dag._QUERY_TABLES


@pytest.mark.parametrize("qname", sorted(SUITE_FOLDS))
def test_fold_matches_the_reference_fold(qname, tmp_path, tables, jtables):
    """Each fold over its paged fact table through ``run_fold``, the
    dimension tables resident, against the reference's fold through its
    ``run_fold`` on the same chunk sequence."""
    fact, make = SUITE_FOLDS[qname]
    jfact, jmake = JAX_FOLDS[qname]
    assert fact == jfact
    names = _TABLES[qname]

    def spec(tabs, analyze):
        return ({n: dict(analyze(tabs[n])) for n in names},
                {n: tabs[n].dicts for n in names},
                {n: tabs[n].num_rows for n in names})

    fold = make(*spec(tables, analyze_table))
    jfold = jmake(*spec(jtables, jax_analyze))
    rb = max(tables[fact].num_rows // 5, 64)
    pc = O.PagedColumns.from_table(_store(tmp_path), fact, tables[fact],
                                   list(tables[fact].cols), row_block=rb)
    jpc = JO.PagedColumns.from_table(_jstore(tmp_path), fact, jtables[fact],
                                     list(jtables[fact].cols), row_block=rb)
    assert pc.num_pages() > 1
    ours = O.run_fold(fold, pc, *[tables[n] for n in names if n != fact])
    ref = JO.run_fold(jfold, jpc, *[jtables[n] for n in names if n != fact])
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        same(a, b)


# ------------------------------------------------------------- the runners
def test_ooc_q01_q06_match_the_reference_and_resident(tmp_path, tables,
                                                      jtables):
    li, jli = tables["lineitem"], jtables["lineitem"]
    pc = O.PagedColumns.from_table(_store(tmp_path), "li", li, O.Q01_COLUMNS)
    jpc = JO.PagedColumns.from_table(_jstore(tmp_path), "li", jli,
                                     O.Q01_COLUMNS)
    got, ref, resident = O.ooc_q01(pc), JO.ooc_q01(jpc), cq01(tables)
    assert [k for k, _ in got] == [k for k, _ in ref] == \
        [k for k, _ in resident]
    for (_, g), (_, w), (_, r) in zip(got, ref, resident):
        assert g["count"] == w["count"] == r["count"]
        for f in ("sum_qty", "sum_base_price", "sum_disc_price",
                  "sum_charge", "avg_disc"):
            assert g[f] == pytest.approx(w[f], rel=1e-4, abs=1e-3)
            assert g[f] == pytest.approx(r[f], rel=1e-4, abs=1e-3)
    (_, g6), = O.ooc_q06(pc)
    (_, w6), = JO.ooc_q06(jpc)
    assert g6 == pytest.approx(w6, rel=1e-4, abs=1e-3)
    assert g6 == pytest.approx(cq06(tables)[0][1], rel=1e-4, abs=1e-3)


def test_ooc_under_a_tiny_pool_spills(tmp_path, tables):
    li = tables["lineitem"]
    store = _store(tmp_path, pool=1 << 15, page=1 << 12)
    assert store.native
    pc = O.PagedColumns.from_table(store, "li", li, O.Q01_COLUMNS)
    got, want = O.ooc_q01(pc), cq01(tables)
    assert [(k, v["count"]) for k, v in got] == \
        [(k, v["count"]) for k, v in want]
    assert store.stats()["spills"] > 0
    store.close()


@pytest.mark.parametrize("parts", [3, 4])
def test_ooc_q03_matches_the_reference(parts, tmp_path, tables, jtables):
    """The join's build side as a LUT paged in key ranges, the probe
    streamed once per range, under a pool far below both."""
    from netsdb_tpu.relational.table import date_to_int

    li, jli = tables["lineitem"], jtables["lineitem"]
    store = _store(tmp_path, pool=1 << 15, page=1 << 12)
    jstore = _jstore(tmp_path, pool=1 << 15, page=1 << 12)
    pc = O.PagedColumns.from_table(store, "li", li, O.Q03_COLUMNS)
    jpc = JO.PagedColumns.from_table(jstore, "li", jli, O.Q03_COLUMNS)
    orders = {n: tables["orders"][n].numpy() for n in
              ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority")}
    customer = {n: tables["customer"][n].numpy() for n in
                ("c_custkey", "c_mktsegment")}
    seg = tables["customer"].code("c_mktsegment", "BUILDING")
    cap = max(1, (int(orders["o_orderkey"].max()) + 1) // parts)
    args = (orders, customer, seg, date_to_int("1995-03-15"), cap)
    assert O.build_q03_side(store, *args) == \
        JO.build_q03_side(jstore, *args) >= parts
    got, ref, want = O.ooc_q03(pc, store), JO.ooc_q03(jpc, jstore), \
        cq03(tables)
    assert [r["okey"] for r in got] == [r["okey"] for r in ref] == \
        [r["okey"] for r in want]
    assert [r["odate"] for r in got] == [r["odate"] for r in ref]
    for g, w in zip(got, ref):
        assert g["revenue"] == pytest.approx(w["revenue"], rel=1e-4)
    assert store.stats()["spills"] > 0
    with pytest.raises(KeyError, match="l_orderkey"):
        O.ooc_q03(O.PagedColumns.ingest(
            store, "x", {"v": np.ones(4, np.float32)}, device="cpu"), store)


def test_bench_out_of_core_smoke():
    res = O.bench_out_of_core(rows=200_000, pool_bytes=1 << 22,
                              row_block=16_384, device="cpu")
    assert res["q01_groups"] > 0 and res["native"]
    assert res["q06_rel_err"] < 1e-4
    assert res["store_stats"]["spills"] > 0


def test_bench_paged_set_api_smoke():
    res = O.bench_paged_set_api(rows=20_000, pool_bytes=1 << 16,
                                page_bytes=1 << 12, device="cpu")
    assert res["q01_groups"] == 6 and res["q03_rows"] > 0
    assert res["build_pages"] > 1 and res["probe_passes"] == 1.0
    assert res["store_stats"]["spills"] > 0
