"""Row-sharded relations (``relational/sharded.py``, placed relation
sets) against the JAX package's, on the CPU.

The JAX side runs on the suite's virtual CPU devices; the port on as many
virtual positions of the CPU. Both get the same rows
(``workloads.tpch.generate``). Covered: ``fold_sharded`` and the ten
``sharded_qXX`` against the reference's and the one-device cores, Q01's
int32 counts, partition-count invariance, the fold cache (dictionary
digest included), the kernel layer (``sharded_query``,
``sharded_key_marks``, ``probe_marks``) on a row count 4 does not divide,
and the suite over placed sets through ``Client.create_set(placement=)``
+ ``send_table`` + ``suite_sink_for`` — memory and paged fact sets, the
fact tables' row counts not divisible by the positions — and the
end-to-end ``q01_sink`` → ``get_table`` → rows. Limits: the reference
tests' own (rtol 1e-4, atol 1e-3 against the one-device cores), and
rtol 1e-5, atol 1e-3 against the reference's placed run, integers
exactly."""

import jax
import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.placement import Placement as JPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational import sharded as JS
from netsdb_tpu.relational.queries import tables_from_rows as jtables
from netsdb_tpu.workloads import tpch
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational import sharded as S
from netsdb_tpu_torch.relational.dag import FACT_TABLES, _QUERY_TABLES
from netsdb_tpu_torch.relational.queries import _SUITE_CORES
from netsdb_tpu_torch.relational.queries import tables_from_rows

torch.set_num_threads(2)
QUERIES = sorted(_QUERY_TABLES)
PLACED = dict(rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def rows3():
    return tpch.generate(scale=3, seed=5)


@pytest.fixture(scope="module")
def rows2():
    # lineitem 898 and orders 300 rows: 4 does not divide lineitem's
    return tpch.generate(scale=2, seed=3)


@pytest.fixture(scope="module")
def tables(rows3):
    return tables_from_rows(rows3, device="cpu")


@pytest.fixture()
def mesh8():
    with virtual_devices(8, "cpu"):
        yield make_mesh((8,), ("data",))


def _resident(qname, tables, **params):
    core, args_fn = _SUITE_CORES[qname]
    out = core(*args_fn(tables, **params))
    return out if isinstance(out, tuple) else (out,)


def same(got, want, **tol):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **(tol or PLACED))


@pytest.mark.parametrize("qname", QUERIES)
def test_sharded_fold_matches_the_reference_and_local(qname, rows3, tables,
                                                      mesh8):
    want = jax.device_get(JS.fold_sharded(
        qname, jtables(rows3), jmake_mesh((8,), ("data",),
                                          devices=jax.devices()[:8])))
    got = S.fold_sharded(qname, tables, mesh8)
    local = _resident(qname, tables)
    assert len(got) == len(want) == len(local)
    for g, w, lo in zip(got, want, local):
        same(g, w)
        same(g, lo.numpy(), rtol=1e-4, atol=1e-3)


def test_sharded_q01_counts_stay_int32(tables, mesh8):
    _sums, counts = S.sharded_q01(tables, mesh8)
    assert counts.dtype == torch.int32


@pytest.mark.parametrize("qname", ["q01", "q04", "q06", "q17", "q22"])
def test_sharded_mesh_shape_invariance(tables, qname):
    with virtual_devices(8, "cpu"):
        ref = S.fold_sharded(qname, tables, make_mesh((2,), ("data",),
                             devices=[torch.device("cpu")] * 2))
        got = S.fold_sharded(qname, tables, make_mesh((8,), ("data",)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-2)


def test_sharded_wrappers_are_thin(tables, mesh8):
    for a, b in zip(S.sharded_q06(tables, mesh8),
                    S.fold_sharded("q06", tables, mesh8)):
        assert torch.equal(a, b)


def test_fold_cache_reused(tables, mesh8):
    S._FOLD_JIT.clear()
    S.fold_sharded("q06", tables, mesh8)
    n = len(S._FOLD_JIT)
    S.fold_sharded("q06", tables, mesh8)
    assert len(S._FOLD_JIT) == n == 1


def test_fold_cache_distinguishes_dict_encodings(mesh8):
    """Two datasets with equal row counts and key spaces but different
    dictionary encodings never share a fold (builders bake dictionary
    codes into their closures)."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    t1 = tables_from_rows(tpch.generate(scale=2, seed=11), device="cpu")
    li = t1["lineitem"]
    d = li.dicts["l_shipmode"]
    rev = list(reversed(d))
    remap = torch.tensor([rev.index(s) for s in d], dtype=torch.int32)
    cols = dict(li.cols)
    cols["l_shipmode"] = remap[li["l_shipmode"].long()]
    t2 = dict(t1)
    t2["lineitem"] = ColumnTable(cols, {**li.dicts, "l_shipmode": rev},
                                 li.valid)
    for t in (t1, t2):
        for a, b in zip(S.fold_sharded("q12", t, mesh8),
                        _resident("q12", t)):
            np.testing.assert_allclose(a.numpy(), b.numpy())


# --- the kernel layer --------------------------------------------------------

def _kernel_inputs():
    rng = np.random.default_rng(4)
    n = 1001  # 4 does not divide it: the padding rows must stay inert
    return {"key": rng.integers(0, 50, n).astype(np.int32),
            "val": rng.integers(-5, 5, n).astype(np.float32),
            "flag": rng.random(n) > 0.3}


def test_sharded_query_sum_and_min_match_the_reference():
    import jax.numpy as jnp

    from netsdb_tpu.relational import kernels as JK
    from netsdb_tpu_torch.relational import kernels as K

    c = _kernel_inputs()
    jmesh = jmake_mesh((4,), ("data",), devices=jax.devices()[:4])
    jfact = {k: jnp.asarray(v) for k, v in c.items()}
    pfact = {k: torch.from_numpy(v) for k, v in c.items()}

    def jsum(valid, cols):
        return JK.segment_sum(cols["val"], cols["key"], 50,
                              valid & cols["flag"])

    def psum(valid, cols):
        return K.segment_sum(cols["val"], cols["key"], 50,
                             valid & cols["flag"])

    def jmin(valid, cols):
        return jnp.min(jnp.where(valid, cols["val"], 99.0))

    def pmin(valid, cols):
        return torch.where(valid, cols["val"], 99.0).min()

    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("data",))
        got = S.sharded_query(psum, mesh, "data", pfact)
        got_min = S.sharded_query(pmin, mesh, "data", pfact,
                                  combine=torch.minimum)
    want = JS.sharded_query(jsum, jmesh, "data", jfact)
    want_min = JS.sharded_query(jmin, jmesh, "data", jfact,
                                combine=jax.lax.pmin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_min.item() == float(want_min) == c["val"].min()


def test_sharded_key_marks_and_probe_marks_match_the_reference():
    import jax.numpy as jnp

    c = _kernel_inputs()
    jmesh = jmake_mesh((4,), ("data",), devices=jax.devices()[:4])
    probe = np.arange(-3, 60, dtype=np.int32)
    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("data",))
        marks = S.sharded_key_marks(
            mesh, "data", torch.from_numpy(c["key"]), 50,
            row_mask=torch.from_numpy(c["flag"]))
    want = JS.sharded_key_marks(jmesh, "data", jnp.asarray(c["key"]), 50,
                                row_mask=jnp.asarray(c["flag"]))
    np.testing.assert_array_equal(marks.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        S.probe_marks(marks, torch.from_numpy(probe), 50).numpy(),
        np.asarray(JS.probe_marks(want, jnp.asarray(probe), 50)))


# --- the suite over placed sets ------------------------------------------

def _load(c, rows, placement_cls, n, paged=()):
    c.create_database("tpch")
    for name, r in rows.items():
        if not r:
            continue
        pl = (placement_cls.data_parallel(ndim=1, n_devices=n)
              if name in FACT_TABLES
              else placement_cls.replicated(ndim=1, n_devices=n))
        c.create_set("tpch", name, type_name="table", placement=pl,
                     storage="paged" if name in paged else "memory")
        c.send_table("tpch", name, r)


def _clients(tmp_path, rows, n, paged=(), **cfg):
    clear_compiled_cache()
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax"), **cfg))
    _load(j, rows, JPlacement, n, paged)
    p = Client(Configuration(root_dir=str(tmp_path / "port"), **cfg),
               device="cpu")
    _load(p, rows, Placement, n, paged)
    return j, p


def test_placed_sets_shard_their_rows_over_the_positions(tmp_path, rows2):
    """``send_table`` into a set placed over 4 positions pads the fact
    rows (898 → 900) and shards every column: 4 distinct shards, the
    padding masked invalid; dimensions keep one copy per device."""
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        _load(c, rows2, Placement, 4)
        li = c.get_table("tpch", "lineitem")
        assert li.num_rows == 900 and len(rows2["lineitem"]) == 898
        assert len({id(t) for t in li["l_orderkey"].shards.flat}) == 4
        assert int(li.valid.to_dense().sum()) == 898
        nation = c.get_table("tpch", "nation")
        assert len({id(t) for t in nation["n_nationkey"].shards.flat}) == 1
        assert li.to_rows()[:3] == c.get_table("tpch", "lineitem").to_rows(
            )[:3]
        assert c.analyze_set("tpch", "lineitem")["num_rows"] == 900


@pytest.mark.parametrize("qname", QUERIES)
def test_suite_over_placed_sets_matches_the_reference(qname, tmp_path,
                                                      rows2):
    """The same DAG runs on one position or on many, depending only on
    how the sets were created: fact tables row-sharded over 4 positions
    (898 lineitem rows), dimensions replicated."""
    with virtual_devices(4, "cpu"):
        j, p = _clients(tmp_path, rows2, 4)
        want = jdag.run_query(j, jdag.suite_sink_for(j, "tpch", qname),
                              job_name=f"jp-{qname}")
        got = dag.run_query(p, dag.suite_sink_for(p, "tpch", qname),
                            job_name=f"pp-{qname}")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        same(g, w)
    assert S.fallback_log() == []


@pytest.mark.parametrize("qname", ["q01", "q03", "q06", "q12", "q17"])
def test_suite_over_paged_and_placed_sets_matches_the_reference(
        qname, tmp_path, rows2):
    """A paged and placed lineitem streams each chunk sharded over the
    positions, under a pool small enough to spill."""
    from netsdb_tpu_torch import obs

    cfg = dict(page_size_bytes=4096, page_pool_bytes=16384)
    with virtual_devices(4, "cpu"):
        j, p = _clients(tmp_path, rows2, 4, paged=("lineitem",), **cfg)
        want = jdag.run_query(j, jdag.suite_sink_for(j, "tpch", qname),
                              job_name=f"jpp-{qname}")
        before = obs.REGISTRY.counter("mesh.placed_chunks").value
        got = dag.run_query(p, dag.suite_sink_for(p, "tpch", qname),
                            job_name=f"ppp-{qname}")
        assert obs.REGISTRY.counter("mesh.placed_chunks").value > before
    assert p.store.page_store().stats()["spills"] > 0
    for g, w in zip(got, want):
        same(g, w)


def test_placed_q01_and_q06_sinks_end_to_end_rows(tmp_path, rows2):
    """Placed sets → ``q01_sink``/``q06_sink`` → ``get_table`` → rows,
    against the reference's same DAGs."""
    with virtual_devices(4, "cpu"):
        j, p = _clients(tmp_path, rows2, 4)
        for sink in ("q01_sink", "q06_sink"):
            jdag.run_query(j, getattr(jdag, sink)("tpch"))
            dag.run_query(p, getattr(dag, sink)("tpch"))
            out = sink.replace("_sink", "_out")
            want = j.get_table("tpch", out).to_rows()
            got = p.get_table("tpch", out).to_rows()
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    if isinstance(g[k], float):
                        assert g[k] == pytest.approx(w[k], rel=1e-5,
                                                     abs=1e-3)
                    else:
                        assert g[k] == w[k], k


def test_placed_q03_sink_filters_orders_on_each_position(tmp_path, rows2):
    """``q03_sink_for`` over placed sets: the rowwise filter node runs on
    each position's orders (no gather), the probe fold over the sharded
    lineitem; the rows equal the reference's."""
    from netsdb_tpu_torch import obs

    with virtual_devices(4, "cpu"):
        j, p = _clients(tmp_path, rows2, 4)
        want = jdag.q03_rows(jdag.run_query(j, jdag.q03_sink_for(j, "tpch")))
        before = obs.REGISTRY.counter("mesh.rowwise_nodes").value
        got = dag.q03_rows(dag.run_query(p, dag.q03_sink_for(p, "tpch")))
        assert obs.REGISTRY.counter("mesh.rowwise_nodes").value > before
    assert [r["okey"] for r in got] == [r["okey"] for r in want]
    for g, w in zip(got, want):
        assert g["odate"] == w["odate"]
        assert g["revenue"] == pytest.approx(w["revenue"], rel=1e-5)


def test_a_node_that_is_not_rowwise_gathers_and_counts_it(tmp_path, rows2):
    """A plain ``Apply`` over a placed fact table runs over the gathered
    relation and the fallback is logged with its reason."""
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet

    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        _load(c, rows2, Placement, 4)
        sink = WriteSet(Apply(ScanSet("tpch", "lineitem"),
                              lambda t: t["l_quantity"].sum(),
                              label="total-qty"), "tpch", "o")
        out = next(iter(c.execute_computations(sink).values()))
    assert out.item() == sum(r["l_quantity"] for r in rows2["lineitem"])
    log = {e["node"]: e for e in S.fallback_log()}
    assert "gathered" in log["total-qty"]["reason"]


# --- the placement API's cases (tests/test_placement_api.py) ---------------

def test_direct_columnar_path_ignores_placement_padding(tmp_path, rows2):
    """The direct core over a table read back from a placed set (rows
    padded, masked invalid) equals the core over the raw rows."""
    from netsdb_tpu_torch.relational.queries import cq01

    with virtual_devices(8, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        c.create_database("tpch")
        c.create_set("tpch", "lineitem", type_name="table",
                     placement=Placement.data_parallel(ndim=1))
        c.send_table("tpch", "lineitem", rows2["lineitem"])
        stored = c.get_table("tpch", "lineitem")
        assert stored.num_rows % 8 == 0 and stored.num_rows > 898
        got = cq01({"lineitem": stored})
    want = cq01(tables_from_rows(rows2, device="cpu"))
    assert len(got) == len(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk == wk and gv["count"] == wv["count"]
        np.testing.assert_allclose(gv["sum_qty"], wv["sum_qty"], rtol=1e-5)


def test_placed_table_survives_eviction_and_re_placement(tmp_path, rows2):
    """An evicted placed relation reloads placed (as many shards as
    positions, the same rows); a placement given to an existing set
    re-places its table."""
    from netsdb_tpu_torch.storage.store import SetIdentifier

    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        c.store.max_host_bytes = 1 << 14  # force eviction
        c.create_database("d")
        c.create_set("d", "a", type_name="table",
                     placement=Placement.data_parallel(ndim=1))
        c.send_table("d", "a", rows2["orders"])
        c.create_set("d", "b", type_name="table")
        c.send_table("d", "b", rows2["lineitem"])
        assert c.store._sets[SetIdentifier("d", "a")].items is None
        back = c.get_table("d", "a")
        assert len({id(s) for s in back["o_orderkey"].shards.flat}) == 4
        assert back.num_rows == 300
        assert back.to_rows() == _decoded_rows(rows2["orders"])
        c.create_set("d", "b", placement=Placement.data_parallel(ndim=1))
        li = c.get_table("d", "b")
        assert li.num_rows == 900
        assert len({id(s) for s in li["l_orderkey"].shards.flat}) == 4


def _decoded_rows(rows):
    """Rows as a table's ``to_rows`` decodes them."""
    from netsdb_tpu_torch.relational.table import ColumnTable

    return ColumnTable.from_rows(rows, device="cpu").to_rows()


def test_suite_sink_reingest_does_not_reuse_stale_stats(tmp_path):
    """Re-ingesting placed sets with a larger key space gives a fresh
    plan (the statistics' digest is in the node's label), not the old
    closure's smaller LUT."""
    def load(c, stride, n_orders):
        rows = tpch.generate(scale=1, seed=21)
        for r in rows["orders"]:
            r["o_orderkey"] = (r["o_orderkey"] * stride) % n_orders
        for r in rows["lineitem"]:
            r["l_orderkey"] = (r["l_orderkey"] * stride) % n_orders
        for name in ("customer", "orders", "lineitem"):
            if not c.set_exists("tpch", name):
                c.create_set("tpch", name, type_name="table",
                             placement=(Placement.data_parallel(ndim=1)
                                        if name in FACT_TABLES else
                                        Placement.replicated(ndim=1)))
            c.send_table("tpch", name, rows[name])
        return rows

    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        c.create_database("tpch")
        load(c, stride=1, n_orders=128)
        dag.run_query(c, dag.suite_sink_for(c, "tpch", "q03"))
        rows = load(c, stride=31, n_orders=4096)
        got = dag.run_query(c, dag.suite_sink_for(c, "tpch", "q03"))
    want = _resident("q03", tables_from_rows(rows, device="cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-3)


def test_placed_q01_through_the_serving_daemon(tmp_path, rows2):
    """A daemon's placed relation set: ``send_table`` over the wire shards
    the rows over the daemon's positions, and ``q01_sink`` run there
    gives the reference's counts."""
    from netsdb_tpu_torch.relational.queries import cq01
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.serve.server import ServeController

    with virtual_devices(4, "cpu"):
        ctl = ServeController(Configuration(root_dir=str(tmp_path)),
                              port=0, device="cpu")
        ctl.start()
        try:
            rc = RemoteClient(ctl.advertise_addr, timeout=60)
            rc.create_database("tpch")
            rc.create_set("tpch", "lineitem", type_name="table",
                          placement=Placement.data_parallel(ndim=1))
            rc.send_table("tpch", "lineitem", rows2["lineitem"])
            held = ctl.library.get_table("tpch", "lineitem")
            assert len({id(s) for s in held["l_orderkey"].shards.flat}) == 4
            rc.execute_computations(dag.q01_sink("tpch"), job_name="sq01")
            got = {(r["l_returnflag"], r["l_linestatus"]): r["count"]
                   for r in rc.get_table("tpch", "q01_out").to_rows()}
        finally:
            ctl.shutdown()
    want = {k: v["count"] for k, v in
            cq01(tables_from_rows(rows2, device="cpu"))}
    assert got == want
