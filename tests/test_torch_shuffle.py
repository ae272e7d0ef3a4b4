"""The row shuffle (``relational/shuffle.py``) and ``Partition`` over a
column against the JAX package's, on the CPU
(``tests/test_shuffle.py``'s cases).

The JAX side runs on the suite's virtual CPU devices; the port on as many
virtual positions of the CPU. Both take the same numpy columns from a
seed. The bucket layout is the reference's (a stable sort by destination
``key % n``, fixed capacity ``slack * mean + 16``), so the shuffled
columns, the validity and the overflow counts are compared exactly; the
Q03 rows by key and date exactly, revenues within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.parallel.placement import Placement as JPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational import shuffle as JS
from netsdb_tpu.relational.queries import tables_from_rows as jtables
from netsdb_tpu.workloads import tpch
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.plan import computations as C
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational import shuffle as S
from netsdb_tpu_torch.relational.queries import cq03, tables_from_rows

torch.set_num_threads(2)


def jmesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n), ("data",))


@pytest.fixture()
def mesh():
    def make(n):
        return make_mesh((n,), ("data",),
                         devices=[torch.device("cpu")] * n)
    return make


@pytest.fixture(scope="module")
def rows():
    return tpch.generate(scale=2, seed=5)


@pytest.fixture(scope="module")
def tables(rows):
    return tables_from_rows(rows, device="cpu")


def dense(x):
    return x.to_dense().numpy()


def both(cols):
    return ({k: jnp.asarray(v) for k, v in cols.items()},
            {k: torch.from_numpy(v) for k, v in cols.items()})


# ----------------------------------------------------- repartition
@pytest.mark.parametrize("n_rows", [1000, 1001])
def test_hash_repartition_matches_the_reference(n_rows, mesh):
    """Every row survives with its payload, co-located on shard key % 8,
    in the reference's bucket layout (1001: padding rows that must not
    travel)."""
    rng = np.random.default_rng(0)
    cols = {"k": rng.integers(0, 400, n_rows).astype(np.int32),
            "v": rng.standard_normal(n_rows).astype(np.float32)}
    jc, pc = both(cols)
    want = JS.hash_repartition(jmesh(8), "data", jc, "k")
    got = S.hash_repartition(mesh(8), "data", pc, "k")
    S.check_overflow(got)
    assert int(got.overflow) == int(want.overflow) == 0
    np.testing.assert_array_equal(dense(got.valid), np.asarray(want.valid))
    for k in cols:
        np.testing.assert_array_equal(dense(got.cols[k]),
                                      np.asarray(want.cols[k]))
    valid = dense(got.valid)
    assert sorted(dense(got.cols["k"])[valid].tolist()) == \
        sorted(cols["k"].tolist())
    per = got.rows_per_shard
    for s in range(8):
        ks = dense(got.cols["k"])[s * per:(s + 1) * per][
            valid[s * per:(s + 1) * per]]
        assert np.all(ks % 8 == s)


def test_negative_keys_land_where_the_reference_puts_them(mesh):
    """Floor mod and floor division: a live -1 key goes to shard n - 1
    (``torch.remainder``, never ``fmod``), as in jnp; its compressed key
    is -1, which every join drops."""
    keys = np.array([-1, -5, 3, 7, -1, 0, 9, -8, 2, 6], np.int32)
    jc, pc = both({"k": keys})
    want = JS.hash_repartition(jmesh(4), "data", jc, "k")
    got = S.hash_repartition(mesh(4), "data", pc, "k")
    np.testing.assert_array_equal(dense(got.cols["k"]),
                                  np.asarray(want.cols["k"]))
    np.testing.assert_array_equal(dense(got.valid), np.asarray(want.valid))
    per = got.rows_per_shard
    k3 = dense(got.cols["k"])[3 * per:4 * per][dense(got.valid)[3 * per:
                                                               4 * per]]
    assert -1 in k3.tolist() and -5 in k3.tolist()


def test_hash_repartition_overflow_counted_as_the_reference(mesh):
    """One key in every row fills one bucket at slack 1: the drops are
    counted (summed over the positions), the bucket never grows."""
    keys = np.zeros(512, np.int32)
    jc, pc = both({"k": keys})
    want = JS.hash_repartition(jmesh(8), "data", jc, "k", slack=1.0)
    got = S.hash_repartition(mesh(8), "data", pc, "k", slack=1.0)
    assert int(got.overflow) == int(want.overflow) > 0
    assert got.rows_per_shard == want.rows_per_shard
    with pytest.raises(ValueError, match="dropped"):
        S.check_overflow(got)


def test_repartition_of_a_repartition_keeps_padding_home(mesh):
    """A ShardedRows re-shuffled with its validity: its padding rows do
    not travel."""
    rng = np.random.default_rng(6)
    cols = {"k": rng.integers(0, 60, 300).astype(np.int32)}
    jc, pc = both(cols)
    j1 = JS.hash_repartition(jmesh(4), "data", jc, "k")
    p1 = S.hash_repartition(mesh(4), "data", pc, "k")
    j2 = JS.hash_repartition(jmesh(4), "data", {"k": j1.cols["k"]}, "k",
                             valid=j1.valid)
    p2 = S.hash_repartition(p1.mesh, "data", {"k": p1.cols["k"]}, "k",
                            valid=p1.valid)
    np.testing.assert_array_equal(dense(p2.valid), np.asarray(j2.valid))
    np.testing.assert_array_equal(dense(p2.cols["k"]),
                                  np.asarray(j2.cols["k"]))
    assert int(dense(p2.valid).sum()) == 300


# ----------------------------------------------------------- join
def test_hash_join_matches_the_reference(mesh):
    rng = np.random.default_rng(1)
    nb, npr, ks = 300, 2001, 500
    cols_b = {"bk": rng.permutation(ks)[:nb].astype(np.int32),
              "bv": rng.integers(0, 1000, nb).astype(np.int32),
              "bflag": rng.random(nb) > 0.25}
    cols_p = {"pk": rng.integers(0, ks, npr).astype(np.int32),
              "pv": rng.standard_normal(npr).astype(np.float32)}
    jb, pb = both(cols_b)
    jp, pp = both(cols_p)
    want = JS.hash_join(jmesh(8), "data", build=jb, build_key="bk",
                        probe=jp, probe_key="pk", key_space=ks,
                        build_mask_fn=lambda c: c["bflag"])
    got = S.hash_join(mesh(8), "data", build=pb, build_key="bk", probe=pp,
                      probe_key="pk", key_space=ks,
                      build_mask_fn=lambda c: c["bflag"])
    S.check_overflow(got)
    assert set(got.cols) == set(want.cols)
    np.testing.assert_array_equal(dense(got.valid), np.asarray(want.valid))
    ok = dense(got.valid)
    for k in want.cols:
        np.testing.assert_array_equal(dense(got.cols[k])[ok],
                                      np.asarray(want.cols[k])[ok])


def test_hash_join_downstream_local_aggregate(mesh):
    """The joined sharded table feeds a purely local segment sum whose
    merged result equals the single-device aggregate."""
    rng = np.random.default_rng(2)
    ks, npr = 64, 4096
    bk = np.arange(ks, dtype=np.int32)
    bw = rng.standard_normal(ks).astype(np.float32)
    pk = rng.integers(0, ks, npr).astype(np.int32)
    pv = rng.standard_normal(npr).astype(np.float32)
    t = S.hash_join(mesh(8), "data",
                    build={"bk": torch.from_numpy(bk),
                           "bw": torch.from_numpy(bw)}, build_key="bk",
                    probe={"pk": torch.from_numpy(pk),
                           "pv": torch.from_numpy(pv)}, probe_key="pk",
                    key_space=ks)
    S.check_overflow(t)
    prod = S._sharded(t.mesh, t.axis, [t.local(i)[0]["pv"]
                                       * t.local(i)[0]["bw"]
                                       for i in range(8)])
    sums = dense(S.segment_sum_by_key(
        S.ShardedRows({**t.cols, "prod": prod}, t.valid, t.mesh, t.axis,
                      t.overflow), "pk", "prod", ks))
    local_ks = S.compressed_key_space(ks, 8)
    got = np.array([sums[(k % 8) * local_ks + k // 8] for k in range(ks)])
    want = np.zeros(ks, np.float32)
    np.add.at(want, pk, pv * bw[pk])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_hash_join_rejects_column_collision(mesh):
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="collision"):
        S.hash_join(mesh(4), "data", build={"k": z, "x": z}, build_key="k",
                    probe={"pk": z, "x": z}, probe_key="pk", key_space=8)
    with pytest.raises(ValueError, match="reserved"):
        S.hash_repartition(mesh(4), "data", {"__valid__": z}, "__valid__")


# ---------------------------------------------------------- Q03 rows
def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["okey"], g["odate"]) == (w["okey"], w["odate"])
        assert g["revenue"] == pytest.approx(w["revenue"], rel=1e-5)


def test_shuffle_q03_matches_local_and_the_reference(rows, tables, mesh):
    seg = tables["customer"].dicts["c_mktsegment"][0]
    want = JS.shuffle_q03(jtables(rows), jmesh(8), segment=seg)
    got = S.shuffle_q03(tables, mesh(8), segment=seg)
    _rows_equal(got, want)
    _rows_equal(got, cq03(tables, segment=seg))


def test_shuffle_q03_partition_branch_matches(rows, tables, mesh,
                                              monkeypatch):
    """The planner's repartition choice for the customer side: the
    three-way all-shuffle plan agrees with the broadcast plan."""
    from netsdb_tpu.relational import planner as JPLN
    from netsdb_tpu_torch.relational import planner as PLN

    seg = tables["customer"].dicts["c_mktsegment"][0]
    monkeypatch.setattr(JPLN, "plan_distribution",
                        lambda *a, **k: JPLN.DistPlan("partition"))
    monkeypatch.setattr(PLN, "plan_distribution",
                        lambda *a, **k: PLN.DistPlan("partition"))
    want = JS.shuffle_q03(jtables(rows), jmesh(8), segment=seg)
    got = S.shuffle_q03(tables, mesh(8), segment=seg)
    _rows_equal(got, want)
    _rows_equal(got, cq03(tables, segment=seg))


def test_shuffle_q03_partition_count_invariant(tables, mesh):
    seg = tables["customer"].dicts["c_mktsegment"][0]
    r4 = S.shuffle_q03(tables, mesh(4), segment=seg)
    r8 = S.shuffle_q03(tables, mesh(8), segment=seg)
    _rows_equal(r4, r8)


# ------------------------------------------------------------ top-k
def test_distributed_top_k_matches_the_reference(mesh):
    rng = np.random.default_rng(3)
    n = 512  # global positions encode key = local_idx * 8 + shard
    scores = rng.standard_normal(n).astype(np.float32)
    want = JS.distributed_top_k(jmesh(8), "data", jnp.asarray(scores), 5)
    got = S.distributed_top_k(mesh(8), "data", torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    per = n // 8
    decoded = np.array([scores[(g % 8) * per + g // 8] for g in range(n)])
    np.testing.assert_array_equal(got[1].numpy(), np.argsort(-decoded)[:5])


def test_distributed_top_k_ties_and_masks_as_the_reference(mesh):
    """Ties go to the lower candidate, masked rows never win, and a short
    vector pads with -inf and key -1."""
    scores = np.repeat(np.arange(8, dtype=np.float32), 8)  # many ties
    mask = np.ones(64, bool)
    mask[::3] = False
    want = JS.distributed_top_k(jmesh(8), "data", jnp.asarray(scores), 10,
                                mask=jnp.asarray(mask))
    got = S.distributed_top_k(mesh(8), "data", torch.from_numpy(scores),
                              10, mask=torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    short = np.arange(16, dtype=np.float32)
    vals, keys, ok = S.distributed_top_k(mesh(8), "data",
                                         torch.from_numpy(short), 10)
    assert vals.shape == (10,) and bool(ok.all()) and vals[0] == 15.0
    vals, keys, ok = S.distributed_top_k(mesh(8), "data",
                                         torch.from_numpy(short[:8]), 10)
    assert ok.tolist() == [True] * 8 + [False] * 2
    assert keys[8:].tolist() == [-1, -1]


# -------------------------------------------------- Partition over placed sets
def _placed(tmp_path, rows, n):
    clear_compiled_cache()
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    p = Client(Configuration(root_dir=str(tmp_path / "port")),
               device="cpu")
    for c, pl in ((j, JPlacement), (p, Placement)):
        c.create_database("d")
        for name in ("customer", "orders", "lineitem"):
            c.create_set("d", name, type_name="table",
                         placement=pl.data_parallel(ndim=1, n_devices=n)
                         if name != "customer"
                         else pl.replicated(ndim=1, n_devices=n))
            c.send_table("d", name, rows[name])
    return j, p


def test_partition_on_a_column_over_a_placed_set(tmp_path, rows):
    """``Partition("o_orderkey", 4)`` over the placed orders lowers to the
    row shuffle on the set's mesh: ShardedRows equal to the reference's,
    overflow 0, every key on shard key % 4."""
    with virtual_devices(4, "cpu"):
        j, p = _placed(tmp_path, rows, 4)

        def sink(M):
            return M.WriteSet(M.Partition(M.ScanSet("d", "orders"),
                                          "o_orderkey", 4), "d", "parts")
        from netsdb_tpu.plan import computations as JC
        from netsdb_tpu.plan.executor import execute_computations as jexec
        from netsdb_tpu_torch.plan.executor import execute_computations

        # a ShardedRows feeds a downstream stage; no set holds it
        want = next(iter(jexec(j, [sink(JC)], materialize=False).values()))
        got = next(iter(execute_computations(
            p, [sink(C)], materialize=False).values()))
    assert isinstance(got, S.ShardedRows)
    assert int(got.overflow) == int(want.overflow) == 0
    np.testing.assert_array_equal(dense(got.valid), np.asarray(want.valid))
    ok = dense(got.valid)
    keys = dense(got.cols["o_orderkey"])
    np.testing.assert_array_equal(keys, np.asarray(want.cols["o_orderkey"]))
    per = got.rows_per_shard
    assert all(np.all(keys[s * per:(s + 1) * per][ok[s * per:(s + 1) * per]]
                      % 4 == s) for s in range(4))
    assert int(ok.sum()) == len(rows["orders"])


def test_partition_errors_are_the_references(tmp_path, rows):
    with virtual_devices(4, "cpu"):
        _, p = _placed(tmp_path, rows, 4)
        wrong = C.WriteSet(C.Partition(C.ScanSet("d", "orders"),
                                       "o_orderkey", 3), "d", "x")
        with pytest.raises(ValueError, match="declared 3 partitions"):
            p.execute_computations(wrong)
        node = C.Partition(C.ScanSet("d", "orders"), "o_orderkey", 4)
        with pytest.raises(TypeError, match="ColumnTable"):
            node.evaluate([{"o_orderkey": 1}])


def test_q03_row_sink_over_placed_sets_matches_the_reference(tmp_path,
                                                             rows):
    seg = "BUILDING"
    with virtual_devices(4, "cpu"):
        j, p = _placed(tmp_path, rows, 4)
        want = jdag.run_query(j, JS.q03_row_sink_for(j, "d", segment=seg))
        got = dag.run_query(p, S.q03_row_sink_for(p, "d", segment=seg))
    _rows_equal(got, want)
    local = cq03(tables_from_rows(rows, device="cpu"), segment=seg)
    _rows_equal(got, local)
    with pytest.raises(ValueError, match="placed lineitem"):
        c = Client(Configuration(root_dir=str(tmp_path / "u")),
                   device="cpu")
        c.create_database("d")
        for name in ("customer", "orders", "lineitem"):
            c.create_set("d", name, type_name="table")
            c.send_table("d", name, rows[name])
        S.q03_row_sink_for(c, "d")
