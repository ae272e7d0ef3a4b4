"""Parity of the port's row TPC-H (``workloads.tpch``: the ten host DAGs,
the ``.tbl`` parsers and loaders) with the JAX package. The same seeded
instance goes through both clients; results are compared exactly and in
order (both compute in Python floats)."""

import numpy as np
import pytest

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.plan.planner import plan_from_sinks as jax_plan
from netsdb_tpu.workloads import tpch as JT
from netsdb_tpu_torch import Client, Configuration
from netsdb_tpu_torch.native import tblparse
from netsdb_tpu_torch.plan.planner import plan_from_sinks
from netsdb_tpu_torch.workloads import tpch as T


@pytest.fixture(scope="module")
def data():
    return T.generate(scale=2, seed=0)


@pytest.fixture(scope="module")
def loaded(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("rows")
    j = JaxClient(JaxConfiguration(root_dir=str(root / "jax")))
    p = Client(Configuration(root_dir=str(root / "port")), device="cpu")
    JT.load_tables(j, "tpch", data)
    T.load_tables(p, "tpch", data)
    return j, p


def test_generate_and_schemas_match_the_reference():
    assert T.generate(scale=2, seed=5) == JT.generate(scale=2, seed=5)
    assert T._TBL_SCHEMAS == JT._TBL_SCHEMAS
    assert T.TABLES == JT.TABLES and list(T.QUERIES) == list(JT.QUERIES)


@pytest.mark.parametrize("query", list(T.QUERIES))
def test_row_query_matches_the_reference(loaded, query):
    j, p = loaded
    want = JT.run_query(j, query)
    got = T.run_query(p, query)
    assert got == want
    # the DAG is the reference's, node for node
    assert len(plan_from_sinks([T.QUERIES[query]()]).topo) == \
        len(jax_plan([JT.QUERIES[query]()]).topo)


@pytest.mark.parametrize("query,params", [
    ("q01", {"delta_date": "1995-06-17"}),
    ("q03", {"segment": "MACHINERY", "date": "1996-01-01"}),
    ("q06", {"disc": 0.05, "qty": 30}),
    ("q12", {"mode1": "AIR", "mode2": "RAIL"}),
    ("q13", {"word1": "zzz", "word2": "qqq"}),
    ("q22", {"prefixes": ("10", "11", "12", "20", "21", "25")})])
def test_row_query_parameters_match_the_reference(loaded, query, params):
    j, p = loaded
    assert T.run_query(p, query, **params) == \
        JT.run_query(j, query, **params)


def test_q13_without_the_comment_filter_counts_every_order(loaded, data):
    _, p = loaded
    got = dict(T.run_query(p, "q13", word1="zzz", word2="qqq"))
    assert sum(k * v for k, v in got.items()) == len(data["orders"])


@pytest.fixture(scope="module")
def tbl_dir(data, tmp_path_factory):
    d = tmp_path_factory.mktemp("tbl")
    T.write_tbl_dir(data, str(d))
    return d


@pytest.mark.parametrize("table", list(T.TABLES))
@pytest.mark.parametrize("native", [True, False])
def test_tbl_parsers_match_the_reference(tbl_dir, data, table, native,
                                         monkeypatch):
    """Each ``.tbl`` file through the port's row parser and its columnar
    parser (native, and the Python fallback when the library is not
    there) equals the reference's, and holds the generated records."""
    path = str(tbl_dir / f"{table}.tbl")
    rows = T.parse_tbl(path, table)
    assert rows == JT.parse_tbl(path, table)
    assert len(rows) == len(data[table])
    for got, want in zip(rows, data[table]):
        for k, v in want.items():
            assert got[k] == v
    if native:
        assert tblparse.available(), tblparse._lib_err
    else:
        monkeypatch.setattr(tblparse, "_load", lambda: None)
        assert not tblparse.available()
    cols = T.parse_tbl_columnar(path, table)
    jcols = JT.parse_tbl_columnar(path, table)
    assert list(cols) == list(jcols)
    for name, typ in T._TBL_SCHEMAS[table]:
        assert cols[name].dtype == jcols[name].dtype
        assert cols[name].tolist() == jcols[name].tolist()
        assert cols[name].tolist() == [r[name] for r in rows]


def test_tbl_malformed_input_raises_as_the_reference(tmp_path):
    p = tmp_path / "nation.tbl"
    p.write_text("0|ALGERIA|\n")
    for mod in (T, JT):
        with pytest.raises(ValueError, match="expected 4 fields"):
            mod.parse_tbl(str(p), "nation")
        with pytest.raises(ValueError, match="unknown TPC-H table"):
            mod.parse_tbl(str(p), "nations")
    with pytest.raises(ValueError, match="line 1"):
        tblparse.parse_columnar(str(p), T._TBL_SCHEMAS["nation"])
    q = tmp_path / "region.tbl"
    q.write_text("99999999999999999999999|AFRICA|comment|\n")
    with pytest.raises(ValueError, match="overflow"):
        tblparse.parse_columnar(str(q), T._TBL_SCHEMAS["region"])
    with pytest.raises(FileNotFoundError):
        tblparse.parse_columnar(str(tmp_path / "none.tbl"),
                                T._TBL_SCHEMAS["region"])


def test_tbl_dir_loaders_match_the_reference(tbl_dir, data, tmp_path):
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    p = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    assert T.load_tbl_dir(p, str(tbl_dir)) == JT.load_tbl_dir(j, str(tbl_dir))
    assert T.load_tbl_dir_columnar(p, str(tbl_dir)) == \
        JT.load_tbl_dir_columnar(j, str(tbl_dir))
    for table in T.TABLES:
        assert list(p.get_set_iterator("tpch", table)) == \
            list(j.get_set_iterator("tpch", table))
        [pt] = list(p.get_set_iterator("tpch", f"{table}_columnar"))
        [jt] = list(j.get_set_iterator("tpch", f"{table}_columnar"))
        assert pt.device.type == "cpu" and pt.dicts == jt.dicts
        for name in jt.cols:
            np.testing.assert_array_equal(pt[name].numpy(),
                                          np.asarray(jt[name]))
    # the row queries run over the loaded .tbl sets as over the records
    assert T.run_query(p, "q01") == JT.run_query(j, "q01")
