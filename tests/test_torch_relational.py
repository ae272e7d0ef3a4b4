"""The port's columnar relational engine against the JAX package's, on
the CPU: column tables, every kernel with each method forced, the
statistics and planner decisions under identical thresholds, the ten
TPC-H cores, and the dbgen-shaped generator.

The same numpy columns and dictionaries go into both packages, from
``workloads.tpch.generate(scale=2, seed=3)`` and from random seeds 11,
42 and 77. Integers (counts, keys, minima, histograms, join indices and
hits, top-k indices) must match exactly; floats within rtol 1e-5 (atol
1e-5 for sums that cancel near 0): the two packages add in different
orders. Inputs include masked rows, ``-1`` codes, orphan keys, duplicate
build keys and top-k ties — the cases where a gather or scatter index
could leave its column, which the port clamps and the reference answers
by its own index rules (``kernels.take``)."""

import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.relational import kernels as JK
from netsdb_tpu.relational import planner as JP
from netsdb_tpu.relational import queries as JQ
from netsdb_tpu.relational import stats as JS
from netsdb_tpu.relational import tuning as JT
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.workloads import tpch
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational import planner as P
from netsdb_tpu_torch.relational import queries as Q
from netsdb_tpu_torch.relational import stats as S
from netsdb_tpu_torch.relational import tuning as T
from netsdb_tpu_torch.relational.table import (ColumnTable, concat_tables,
                                               date_to_int, int_to_date)

torch.set_num_threads(2)

SEEDS = (11, 42, 77)
RTOL = ATOL = 1e-5
G = 37  # segments of the kernel cases

# the same thresholds forced on both packages (kind "cpu"), so no case
# depends on a package's own table
PROFILES = {
    "dense_lut": dict(segment_dense_limit=1e9, count_grid_limit=1e9,
                      join_lut_factor=1e9, join_lut_max_bytes=1 << 30),
    "grid_sort": dict(segment_dense_limit=0, count_grid_limit=1e9,
                      join_lut_factor=0.0, join_lut_max_bytes=1 << 30),
    "scatter_lut": dict(segment_dense_limit=0, count_grid_limit=0,
                        join_lut_factor=1e9, join_lut_max_bytes=1 << 30),
}


def force(profile):
    for name, value in PROFILES[profile].items():
        JT.set_override(name, value, kind="cpu")
        T.set_override(name, value, kind="cpu")


@pytest.fixture(autouse=True)
def _clean_thresholds():
    yield
    JT.clear_overrides()
    T.clear_overrides()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


def same(ours, ref, exact=None):
    """A port tensor against a JAX array: integers and bools exactly,
    floats within RTOL/ATOL (NaN where the reference has NaN)."""
    got = ours.detach().cpu().numpy()
    want = np.asarray(ref)
    assert got.shape == want.shape
    if exact or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def same_result(ours, ref):
    """Query results (lists, tuples, dicts of numbers and strings):
    structure, strings and ints exactly, floats within RTOL/ATOL."""
    if isinstance(ref, float):
        assert isinstance(ours, float)
        assert math.isclose(ours, ref, rel_tol=RTOL, abs_tol=ATOL), (ours,
                                                                      ref)
    elif isinstance(ref, dict):
        assert ours.keys() == ref.keys()
        for k in ref:
            same_result(ours[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            same_result(a, b)
    else:
        assert ours == ref


def segment_case(seed, n=300, g=G, dtype=np.float32):
    """Values, segment ids over [-2, g + 3) (``-1`` codes and orphans
    included) and a mask with about a fifth of the rows off."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        vals = rng.standard_normal(n).astype(np.float32)
    else:
        vals = rng.integers(-50, 50, n).astype(np.int32)
    ids = rng.integers(-2, g + 3, n).astype(np.int32)
    mask = rng.random(n) > 0.2
    return vals, ids, mask


# ------------------------------------------------------------ ColumnTable
@pytest.fixture(scope="module")
def data():
    return tpch.generate(scale=2, seed=3)


@pytest.mark.parametrize("name", ["region", "nation", "supplier", "customer",
                                  "part", "partsupp", "orders", "lineitem"])
def test_table_round_trip(data, name):
    """Rows → port table → rows gives the rows back (floats as float32),
    as the reference's round trip does, and the columns and
    dictionaries equal the reference table's."""
    rows = data[name]
    dates = tuple(k for k, v in rows[0].items()
                  if isinstance(v, str) and len(v) == 10 and v[4] == "-")
    ours = ColumnTable.from_rows(rows, device="cpu")
    ref = JTable.from_rows(rows)
    back = ours.to_rows(date_cols=dates)
    assert back == ref.to_rows(date_cols=dates)
    f32 = lambda v: float(np.float32(v)) if isinstance(v, float) else v
    assert back == [{k: f32(v) for k, v in r.items()} for r in rows]
    assert ours.dicts == ref.dicts and ours.num_rows == ref.num_rows
    for col in ref.cols:
        same(ours[col], ref[col], exact=True)
        assert ours[col].dtype == {"int32": torch.int32,
                                   "float32": torch.float32,
                                   "bool": torch.bool}[str(ref[col].dtype)]
    # the ingest statistics equal the reference's analysis
    assert S.analyze_table(ours) == {
        c: S.ColumnStats(*tuple(s)[:4])
        for c, s in ((c, (v.n_rows, v.min_val, v.max_val, v.n_distinct))
                     for c, v in JS.analyze_table(ref).items())}


def test_from_columns_carries_a_jax_table(data):
    """A JAX table's numpy columns, dictionaries and mask cross over as
    they are; date strings and other strings encode as the reference
    encodes them."""
    ref = JTable.from_rows(data["orders"])
    mask = np.arange(ref.num_rows) % 3 != 0
    ref = ref.filter(jnp.asarray(mask))
    ours = ColumnTable.from_columns({n: np.asarray(c)
                                     for n, c in ref.cols.items()},
                                    ref.dicts, valid=np.asarray(ref.valid),
                                    device="cpu")
    assert ours.to_rows() == ref.to_rows()
    strings = {"d": np.array(["1995-03-15", "1994-01-01"], object),
               "s": np.array(["b", "a"], object), "i": np.array([3, 4])}
    ours = ColumnTable.from_columns(strings, device="cpu")
    ref = JTable.from_columns(strings)
    assert ours.dicts == ref.dicts
    for col in strings:
        same(ours[col], ref[col], exact=True)


def test_pickle_round_trip(data):
    table = ColumnTable.from_rows(data["customer"], device="cpu")
    table = table.filter(table["c_acctbal"] > 0)
    back = pickle.loads(pickle.dumps(table))
    assert back.dicts == table.dicts
    for col in table.cols:
        assert torch.equal(back[col], table[col])
    assert torch.equal(back.valid, table.valid)
    assert back.to_rows() == table.to_rows()


def test_table_verbs_match_the_reference(data):
    rows = data["customer"]
    ours = ColumnTable.from_rows(rows, device="cpu")
    ref = JTable.from_rows(rows)
    seg = ours.dicts["c_mktsegment"]
    assert ours.code("c_mktsegment", seg[1]) == ref.code("c_mktsegment",
                                                         seg[1]) == 1
    assert ours.code("c_mktsegment", "NOPE") == -1
    assert ours.codes_where("c_phone", lambda s: s.startswith("1")) == \
        ref.codes_where("c_phone", lambda s: s.startswith("1"))
    assert ours.decode("c_mktsegment", 2) == ref.decode("c_mktsegment", 2)
    assert bool(ours.mask().all()) and ours.compact() is ours
    keep = np.asarray(ref["c_acctbal"]) > 1000
    f_ours = ours.filter(t(keep)).filter(ours["c_custkey"] % 2 == 0)
    f_ref = ref.filter(j(keep)).filter(ref["c_custkey"] % 2 == 0)
    same(f_ours.mask(), f_ref.mask())
    assert f_ours.num_rows == ours.num_rows  # filters never shrink
    assert f_ours.compact().to_rows() == f_ref.compact().to_rows()
    assert f_ours.compact() is f_ours.compact()  # memoised
    sel = f_ours.select(["c_custkey", "c_phone"])
    assert set(sel.cols) == {"c_custkey", "c_phone"}
    assert set(sel.dicts) == {"c_phone"} and sel.valid is f_ours.valid
    wc = ours.with_column("x", ours["c_custkey"] * 2, ["a"])
    assert wc.dicts["x"] == ["a"] and "x" not in ours.cols
    assert date_to_int("1995-03-15") == 19950315
    assert int_to_date(19950315) == "1995-03-15"
    with pytest.raises(ValueError, match="ISO"):
        date_to_int("15/03/1995")
    with pytest.raises(ValueError, match="at least one row"):
        ColumnTable.from_rows([], device="cpu")


def test_concat_tables_matches_the_reference():
    """An append remaps the batch's dictionary codes into the stored
    dictionaries (new strings extend them) as the reference's
    ``concat_tables`` does; masks concatenate."""
    from netsdb_tpu.relational.autojoin import concat_tables as jconcat

    a_rows = [{"k": i, "s": f"v{i % 3}", "x": float(i)} for i in range(7)]
    b_rows = [{"k": 10 + i, "s": f"v{(i * 2) % 5}", "x": -float(i)}
              for i in range(6)]
    ours_a = ColumnTable.from_rows(a_rows, device="cpu")
    ours_b = ColumnTable.from_rows(b_rows, device="cpu")
    ours_b = ours_b.filter(ours_b["k"] != 12)
    ref_b = JTable.from_rows(b_rows)
    ref_b = ref_b.filter(ref_b["k"] != 12)
    ours = concat_tables(ours_a, ours_b)
    ref = jconcat(JTable.from_rows(a_rows), ref_b)
    assert ours.dicts == ref.dicts
    for col in ref.cols:
        same(ours[col], ref[col])
    same(ours.mask(), ref.mask())
    assert ours.to_rows() == ref.to_rows()
    # the appended table's statistics, collected where it lives
    assert S.column_stats(ours, "k") == S.ColumnStats(13, 0, 15)
    assert S.column_stats(ours, "s").key_space == len(ref.dicts["s"])
    with pytest.raises(ValueError, match="schema"):
        concat_tables(ours_a, ours_a.select(["k"]))


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", ["dense", "scatter"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_sum(seed, method, dtype):
    vals, ids, mask = segment_case(seed, dtype=dtype)
    same(K.segment_sum(t(vals), t(ids), G, t(mask), method=method),
         JK.segment_sum(j(vals), j(ids), G, j(mask), method=method))
    same(K.segment_sum(t(vals), t(ids), G, method=method),
         JK.segment_sum(j(vals), j(ids), G, method=method))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", ["dense", "grid", "scatter"])
def test_segment_count_and_bincount(seed, method):
    _, ids, mask = segment_case(seed)
    got = K.segment_count(t(ids), G, t(mask), method=method)
    assert got.dtype == torch.int32
    same(got, JK.segment_count(j(ids), G, j(mask), method=method))
    same(K.bincount_masked(t(ids), G, t(mask), method=method),
         JK.bincount_masked(j(ids), G, j(mask), method=method))
    # nothing of a dropped or orphan row is counted
    ok = mask & (ids >= 0) & (ids < G)
    assert int(got.sum()) == int(ok.sum())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", ["dense", "scatter"])
@pytest.mark.parametrize("which", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_min_max(seed, method, which, dtype):
    """Minima and maxima are exact selections, empty segments hold the
    identity (±inf or the int extremes)."""
    vals, ids, mask = segment_case(seed, dtype=dtype)
    ours = getattr(K, f"segment_{which}")
    ref = getattr(JK, f"segment_{which}")
    same(ours(t(vals), t(ids), G, t(mask), method=method),
         ref(j(vals), j(ids), G, j(mask), method=method), exact=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", ["dense", "scatter"])
def test_segment_mean(seed, method):
    vals, ids, mask = segment_case(seed, dtype=np.int32)
    same(K.segment_mean(t(vals), t(ids), G, t(mask), method=method),
         JK.segment_mean(j(vals), j(ids), G, j(mask), method=method))


@pytest.mark.parametrize("op", ["sum", "min"])
def test_dense_reduce_is_the_same_at_any_row_count(monkeypatch, op):
    """The dense reduce goes over row chunks (never a rows x groups
    block): with a chunk of 7 rows it gives what one chunk gives, and
    the scatter path agrees."""
    vals, ids, mask = segment_case(5, n=1000)
    fn = getattr(K, f"segment_{op}")
    whole = fn(t(vals), t(ids), G, t(mask), method="dense")
    monkeypatch.setattr(K, "_DENSE_CHUNK_ELEMS", 7 * G)
    chunked = fn(t(vals), t(ids), G, t(mask), method="dense")
    scatter = fn(t(vals), t(ids), G, t(mask), method="scatter")
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(scatter.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_grid_count_is_exact_over_chunks(monkeypatch):
    """The grid count adds int32 chunk grids: with chunks of 3 rows and a
    key space over several grid rows it equals the scatter count."""
    rng = np.random.default_rng(9)
    ids = rng.integers(-3, 700, 5000).astype(np.int32)
    monkeypatch.setattr(K, "_GRID_CHUNK_ELEMS", 3 * (6 + 128))
    got = K.count_grid(t(ids), 690)
    assert got.dtype == torch.int32
    assert torch.equal(got, K.segment_count(t(ids), 690, method="scatter"))
    same(got, JK.count_grid(j(ids), 690))


def join_case(seed, n_build=40, n_probe=200, ks=64, unique=True):
    rng = np.random.default_rng(seed)
    if unique:
        pk = rng.permutation(ks)[:n_build].astype(np.int32)
    else:  # duplicate build keys
        pk = rng.integers(0, ks // 2, n_build).astype(np.int32)
    pk[:2] = [ks + 5, -1]  # build rows outside the key space
    fk = rng.integers(-3, ks + 4, n_probe).astype(np.int32)
    fk[:2] = [-2147483648, ks - 1]  # the sort path's sentinel, the edge
    return (pk, fk, rng.random(n_build) > 0.25, rng.random(n_probe) > 0.2,
            ks)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strategy", ["lut", "sort"])
def test_pk_fk_join(seed, strategy):
    """Hits match exactly; every hit's build row carries the probe's key;
    misses point at row 0 (LUT) or a clamped row (sort), as the
    reference's do."""
    pk, fk, pm, fm, ks = join_case(seed)
    plan_o, plan_r = P.JoinPlan(strategy, ks), JP.JoinPlan(strategy, ks)
    for masks in ((None, None), (pm, fm)):
        tm = [None if m is None else t(m) for m in masks]
        jm = [None if m is None else j(m) for m in masks]
        idx, hit = K.pk_fk_join(t(pk), t(fk), *tm, plan=plan_o)
        ridx, rhit = JK.pk_fk_join(j(pk), j(fk), *jm, plan=plan_r)
        same(hit, rhit)
        same(idx, ridx)
        assert idx.dtype == torch.int32
        h = hit.numpy()
        assert (pk[idx.numpy()[h]] == fk[h]).all()
    # key_space alone forces the LUT
    same(K.pk_fk_join(t(pk), t(fk), key_space=ks)[1],
         JK.pk_fk_join(j(pk), j(fk), key_space=ks)[1])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strategy", ["lut", "sort"])
def test_member_with_duplicate_build_keys(seed, strategy):
    pk, fk, pm, fm, ks = join_case(seed, unique=False)
    for masks in ((None, None), (pm, fm)):
        tm = [None if m is None else t(m) for m in masks]
        jm = [None if m is None else j(m) for m in masks]
        got = K.member(t(pk), t(fk), *tm,
                       plan=P.JoinPlan(strategy, ks))
        same(got, JK.member(j(pk), j(fk), *jm,
                            plan=JP.JoinPlan(strategy, ks)))
        build = pk if masks[0] is None else pk[masks[0]]
        want = np.isin(fk, build[(build >= 0) & (build < ks)]
                       if strategy == "lut" else build)
        if masks[1] is not None:
            want &= masks[1]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_any_by_key(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, 60, 400).astype(np.int32)
    flag = (rng.random(400) > 0.9).astype(np.int32)
    got = K.any_by_key(t(keys), t(flag), 55)
    same(got, JK.any_by_key(j(keys), j(flag), 55))
    for method in ("dense", "grid", "scatter"):
        assert torch.equal(K.any_by_key(t(keys), t(flag), 55, method), got)


@pytest.mark.parametrize("seed", SEEDS)
def test_top_k_masked_ties(seed):
    """Ties go to the lower index, as ``lax.top_k``, masked rows are
    -inf and count as not valid."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 6, 50).astype(np.float32)  # many ties
    mask = rng.random(50) > 0.3
    for k in (1, 10, 50):
        idx, ok = K.top_k_masked(t(scores), k, t(mask))
        ridx, rok = JK.top_k_masked(j(scores), k, j(mask))
        same(idx, ridx)
        same(ok, rok)
    idx, _ = K.top_k_masked(torch.tensor([1.0, 3, 3, 1, 3]), 3)
    assert idx.tolist() == [1, 2, 4]


def test_take_reproduces_the_reference_out_of_range_values():
    """``jnp.take`` wraps a negative index and fills past the end (the
    int minimum, NaN, True). The port's gather reads a clamped index and
    gives the same values."""
    idx = np.array([-1, 7, -6, 0, 4, -5], np.int32)
    for a in (np.arange(5, dtype=np.int32), np.arange(5, dtype=np.float32),
              np.array([True, False, False, False, False])):
        same(K.take(t(a), t(idx)), jnp.take(j(a), j(idx)), exact=True)
    # from an empty column every index is out of range (the reference
    # refuses this gather)
    assert (K.take(torch.zeros(0, dtype=torch.int32), t(idx))
            == -2147483648).all()


# ------------------------------------------------------- stats, planner
def test_stats_match_the_reference():
    rng = np.random.default_rng(42)
    cols = {"k": rng.integers(-4, 90, 500).astype(np.int32),
            "b": rng.random(500) > 0.5,
            "x": rng.random(500).astype(np.float32)}
    for a in (cols["k"], cols["b"], np.zeros(0, np.int32)):
        for distinct in (False, True):
            r = JS.analyze_array(a, distinct)
            want = S.ColumnStats(r.n_rows, r.min_val, r.max_val,
                                 r.n_distinct)
            assert S.analyze_array(a, distinct) == want
            assert S.analyze_array(t(a), distinct) == want
    ours = ColumnTable.from_columns(cols, device="cpu")
    ref = JTable.from_columns(cols)
    assert set(S.analyze_table(ours)) == {"k", "b"}
    assert S.key_space(ours, "k") == JS.key_space(ref, "k") == 90
    assert S.column_stats(ours, "k", distinct=True).density == \
        JS.column_stats(ref, "k", distinct=True).density
    with pytest.raises(ValueError, match="distinct"):
        S.ColumnStats(3, 0, 2).density
    # the cache is per instance: a filtered table starts cold, and
    # injected statistics win
    filtered = ours.filter(ours["k"] > 0)
    assert "_column_stats" not in filtered.__dict__
    S.inject_stats(filtered, {"k": S.ColumnStats(1, 0, 999)})
    assert S.key_space(filtered, "k") == 1000


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_planner_decisions_match_under_the_same_thresholds(data, profile):
    force(profile)
    ours = Q.tables_from_rows(data, device="cpu")
    ref = JQ.tables_from_rows(data)
    for build, bcol, probe, pcol in (("part", "p_partkey", "lineitem",
                                      "l_partkey"),
                                     ("orders", "o_orderkey", "lineitem",
                                      "l_orderkey"),
                                     ("orders", "o_custkey", "customer",
                                      "c_custkey")):
        assert tuple(P.plan_join(ours[build], bcol, ours[probe], pcol)) == \
            tuple(JP.plan_join(ref[build], bcol, ref[probe], pcol))
    for g in (1, 6, 64, 300, 1 << 20):
        assert P.segment_method(g, "cpu") == JP.segment_method(g, "cpu")
        assert P.count_method(g, "cpu") == JP.count_method(g, "cpu")
    st = S.ColumnStats(100, 0, 5000)
    assert tuple(P.plan_join_from_stats(st, 50, "cpu")) == \
        tuple(JP.plan_join_from_stats(JS.ColumnStats(100, 0, 5000), 50,
                                      "cpu"))


def test_plan_distribution_and_device_memory():
    for build in (1 << 20, 1 << 30):
        assert P.plan_distribution(build, 4, 1 << 32) == \
            tuple(JP.plan_distribution(build, 4, 1 << 32))
    assert P.device_memory_bytes("cpu") > 1 << 28
    assert P.plan_distribution(1, 1).strategy == "broadcast"


def test_thresholds_lookup_order(tmp_path, monkeypatch):
    """The port's own autotune file wins over its measured table, which
    wins over the defaults; the reference's TPU row is not there."""
    path = tmp_path / "autotune.json"
    monkeypatch.setattr(T, "_tuning_path", lambda: str(path))
    monkeypatch.setattr(T, "_MEASURED", {"kind-x": {"join_lut_factor": 8.0}})
    T.clear_overrides()
    assert T.get("segment_dense_limit", "kind-x") == 64
    assert T.get("join_lut_factor", "kind-x") == 8.0
    assert "TPU v5 lite" not in T._MEASURED and not T._MEASURED.get("cpu")
    path.write_text('{"kind-x": {"join_lut_factor": 2.0}}')
    T.clear_overrides()
    assert T.get("join_lut_factor", "kind-x") == 2.0
    T.set_override("join_lut_factor", 5.0, kind="kind-x")
    assert T.get("join_lut_factor", "kind-x") == 5.0
    assert T.device_kind("cpu") == "cpu"


def test_autotune_records_the_measured_crossovers(tmp_path, monkeypatch):
    """``autotune`` races each strategy pair upward and keeps the last
    win; a fake timer makes the races deterministic. ``persist`` writes
    the port's file and nothing else."""
    path = tmp_path / "autotune.json"
    monkeypatch.setattr(T, "_tuning_path", lambda: str(path))
    T.clear_overrides()
    calls = []

    def fake(fn, device, iters=5):
        calls.append(fn)
        return float((len(calls) + 1) % 2)  # the first of a pair wins

    assert T.measure_segment_crossover("cpu", n_rows=64, candidates=(2, 4),
                                       timer=fake) == 4
    assert T.measure_count_grid_crossover("cpu", n_rows=64,
                                          candidates=(4, 8),
                                          timer=fake) == 8
    assert T.measure_join_crossover("cpu", n_build=16, n_probe=32,
                                    factors=(2, 4), timer=fake) == 4.0
    assert T._largest_win((1, 2, 3), lambda c: c < 3) == 2
    assert T._largest_win((1, 2), lambda c: False) == 0
    monkeypatch.setattr(T, "measure_segment_crossover", lambda d: 16)
    monkeypatch.setattr(T, "measure_count_grid_crossover", lambda d: 4096)
    monkeypatch.setattr(T, "measure_join_crossover", lambda d: 8.0)
    got = T.autotune("cpu", persist=False)
    assert not path.exists()
    assert got == {"segment_dense_limit": 16.0, "count_grid_limit": 4096.0,
                   "join_lut_factor": 8.0,
                   "join_lut_max_bytes": float(1 << 28)}
    T.clear_overrides()
    T.autotune("cpu", persist=True)
    assert T.get("segment_dense_limit", "cpu") == 16.0
    T.clear_overrides()
    assert T.get("count_grid_limit", "cpu") == 4096.0  # from the file


# ------------------------------------------------------------- queries
@pytest.fixture(scope="module")
def both_tables(data):
    return Q.tables_from_rows(data, device="cpu"), JQ.tables_from_rows(data)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("qname", sorted(Q.COLUMNAR_QUERIES))
def test_query_matches_the_reference(both_tables, qname, profile):
    force(profile)
    ours, ref = both_tables
    same_result(Q.COLUMNAR_QUERIES[qname](ours),
                JQ.COLUMNAR_QUERIES[qname](ref))


def test_compile_suite_runs_the_ten_cores(both_tables):
    ours, ref = both_tables
    suite = Q.compile_suite(ours)
    out = suite()
    assert set(out) == set(Q._SUITE_CORES)
    templates, arrays = Q.suite_args_split(ours)
    r_templates, r_arrays = JQ.suite_args_split(ref)
    for name in templates:
        assert len(arrays[name]) == len(r_arrays[name])
        assert [x is Q._SLOT for x in templates[name]] == \
            [x is JQ._SLOT for x in r_templates[name]]
        want = JQ._SUITE_CORES[name][0](*JQ._SUITE_CORES[name][1](ref))
        got = out[name]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            same(a, b)


def test_q22_code_lut_matches_the_reference():
    phones = ["13-1", "31-2", "99-3", "17-4"]
    got = Q.q22_code_lut(phones, ("17", "13", "31"), device="cpu")
    want = JQ.q22_code_lut(phones, ("17", "13", "31"))
    assert got[0] == want[0]
    same(got[1], want[1])


def test_generator_and_queries_match_the_reference_at_dbgen_shape():
    """``generate_columnar`` draws the reference generator's columns from
    the same seed; the ten queries over them agree."""
    from netsdb_tpu.relational.bench import generate_columnar as jgen
    from netsdb_tpu_torch.relational.bench import (PUBLISHED,
                                                   generate_columnar)

    ours = generate_columnar(sf=0.002, seed=7, device="cpu")
    ref = jgen(sf=0.002, seed=7)
    assert set(ours) == set(ref)
    for name in ref:
        assert ours[name].dicts == ref[name].dicts
        for col in ref[name].cols:
            same(ours[name][col], ref[name][col], exact=True)
    assert ours["lineitem"].num_rows == 12000
    for qname, fn in Q.COLUMNAR_QUERIES.items():
        same_result(fn(ours), JQ.COLUMNAR_QUERIES[qname](ref))
    assert PUBLISHED == {"q01": 13.4, "q02": 77.4, "q04": 188.5}


def test_bench_times_on_the_tables_device():
    from netsdb_tpu_torch.relational import bench

    out = bench.main(sf=0.0005, iters=2, device="cpu")
    assert out["lineitem_rows"] == 3000 and out["device"] == "cpu"
    assert set(out["queries"]) == set(Q.COLUMNAR_QUERIES)
    assert out["queries"]["q01"]["reference_cluster_s"] == 13.4
    assert all(v["ms_p50"] > 0 for v in out["queries"].values())
    assert out["suite"]["all_ten_queries_ms"] > 0


def test_entry_points_default_to_cuda():
    """Tables, generated data and LUTs go to CUDA unless asked; without a
    card they raise instead of falling back."""
    from netsdb_tpu_torch.relational.bench import generate_columnar

    calls = [lambda **kw: ColumnTable.from_rows([{"a": 1}], **kw).device,
             lambda **kw: Q.tables_from_rows({"t": [{"a": 1}]},
                                             **kw)["t"].device,
             lambda **kw: generate_columnar(sf=0.0001, **kw)["region"].device,
             lambda **kw: Q.q22_code_lut(["13-1"], ("13",), **kw)[1].device]
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert call(device="cpu").type == "cpu"
