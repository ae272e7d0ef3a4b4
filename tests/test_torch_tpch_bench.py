"""Parity of the port's tpchBench family with the JAX package: the host
DAGs over nested Customer records (compared exactly and in order), the
columnar family (``tpch_bench_columnar``: integers exactly, Jaccard
scores within 1e-6 relative, the same customers at the k-th place when
scores tie), and the host DAGs held against ``queries_on_sets`` over
``columnarize`` of the same customers."""

import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.workloads import tpch_bench as JB
from netsdb_tpu.workloads import tpch_bench_columnar as JBC
from netsdb_tpu_torch import Client, Configuration
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.workloads import tpch_bench as B
from netsdb_tpu_torch.workloads import tpch_bench_columnar as BC

RTOL = 1e-6


@pytest.fixture(scope="module")
def customers():
    return B.generate(num_customers=60, seed=7)


@pytest.fixture(scope="module")
def tied():
    """Few parts, so many customers share a Jaccard score and the k-th
    place is a tie."""
    return B.generate(num_customers=80, max_orders=1, max_items=2,
                      num_parts=5, seed=3)


def _clients(tmp_path, customers):
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    p = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    JB.load(j, customers)
    B.load(p, customers)
    return j, p


def _run(c, *sinks):
    return {k.set: v for k, v in c.execute_computations(*sinks).items()}


def test_generate_matches_the_reference():
    from dataclasses import asdict

    assert [asdict(c) for c in B.generate(num_customers=30, seed=2)] == \
        [asdict(c) for c in JB.generate(num_customers=30, seed=2)]


def test_host_dags_match_the_reference_in_order(tmp_path, customers):
    j, p = _clients(tmp_path, customers)
    builds = lambda M: [M.customer_int_selection(threshold=20),
                        M.customer_int_selection(threshold=20, negate=True),
                        M.customer_string_selection(segment="BUILDING"),
                        M.customer_string_selection(segment="BUILDING",
                                                    negate=True),
                        M.flatten_triples(), M.count_customers(),
                        M.top_jaccard(query_parts=[1, 2, 3, 7, 11, 13], k=4)]
    want, got = _run(j, *builds(JB)), _run(p, *builds(B))
    assert list(got) == list(want)
    for name in want:
        if isinstance(want[name], dict):
            assert list(got[name].items()) == list(want[name].items())
        else:
            assert [vars(x) for x in got[name]] == \
                [vars(x) for x in want[name]]
    # the group-by reads the triples set the flatten wrote
    want, got = _run(j, JB.group_by_supplier()), _run(p, B.group_by_supplier())
    assert list(got["supplier_info"].items()) == \
        list(want["supplier_info"].items())


@pytest.fixture(scope="module")
def tables(customers):
    return JBC.columnarize(customers), BC.columnarize(customers, device="cpu")


def test_columnarize_matches_the_reference(tables):
    jt, pt = tables
    for name in jt:
        assert list(pt[name].cols) == list(jt[name].cols)
        assert pt[name].dicts == jt[name].dicts
        for col in jt[name].cols:
            np.testing.assert_array_equal(pt[name][col].numpy(),
                                          np.asarray(jt[name][col]))


def test_columnar_family_matches_the_reference(tables):
    jt, pt = tables
    for thr, seg in ((25, "BUILDING"), (-1, "NOPE")):
        for g, w in zip(BC.selections(pt, thr, seg),
                        JBC.selections(jt, thr, seg)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(BC.group_by_supplier(pt), JBC.group_by_supplier(jt)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert BC.count_customers(pt) == JBC.count_customers(jt) == 60
    for query, k in (([1, 3, 5, 7, 11, 13, 17], 5), ([0], 3),
                     ([2, 200], 60)):
        got = BC.top_jaccard(pt, query, k)
        want = JBC.top_jaccard(jt, query, k)
        assert [c for _, c in got] == [c for _, c in want]
        np.testing.assert_allclose([s for s, _ in got],
                                   [s for s, _ in want], rtol=RTOL)


@pytest.mark.parametrize("k", [3, 10, 27])
def test_top_jaccard_ties_at_the_kth_place_match(tied, k):
    jt, pt = JBC.columnarize(tied), BC.columnarize(tied, device="cpu")
    query = [0, 2]
    got = BC.top_jaccard(pt, query, k)
    want = JBC.top_jaccard(jt, query, k)
    scores = [s for s, _ in got]
    assert len(set(scores)) < len(scores)  # the ties this case is about
    assert got == want
    # the host oracle's order: score down, then custKey up
    q = frozenset(query)
    oracle = []
    for c in tied:
        parts = frozenset(li.partKey for o in c.orders for li in o.lineItems)
        oracle.append((len(parts & q) / len(parts | q), c.custKey))
    oracle.sort(key=lambda si: (-si[0], si[1]))
    assert [c for _, c in got] == [c for _, c in oracle[:k]]
    np.testing.assert_allclose(scores, [s for s, _ in oracle[:k]], rtol=RTOL)


def test_membership_matrix_clips_and_drops_keys_as_the_reference():
    ck = np.array([0, 1, 2, -1, 3, 5, 1, -3, 2], np.int32)
    pk = np.array([0, 4, -2, 1, 9, 1, 2, 0, 3], np.int32)
    import jax.numpy as jnp

    want = np.asarray(JBC._membership_matrix(4, 4, jnp.asarray(ck),
                                             jnp.asarray(pk)))
    got = BC._membership_matrix(4, 4, torch.from_numpy(ck),
                                torch.from_numpy(pk))
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_dags_hold_against_queries_on_sets(tmp_path, customers):
    """As the reference's columnar test does: the host DAGs over the
    records and ``queries_on_sets`` over ``columnarize`` of the same
    customers, sent with ``send_table``, agree."""
    _, p = _clients(tmp_path, customers)
    tabs = BC.columnarize(customers, device="cpu")
    p.create_database("tpchbc")
    for name, t in tabs.items():
        p.create_set("tpchbc", name, type_name="table")
        p.send_table("tpchbc", name, t)
    query, k = [1, 3, 5, 7, 11, 13, 17], 6
    res = BC.queries_on_sets(p, db="tpchbc", threshold=25,
                             segment="BUILDING", query_parts=query, k=k)
    host = _run(p, B.customer_int_selection(threshold=25),
                B.customer_string_selection(segment="BUILDING"),
                B.count_customers(), B.flatten_triples(),
                B.top_jaccard(query_parts=query, k=k))
    sel_int, not_int, sel_str, not_str = (m.numpy() for m in
                                          res["selections"])
    keys = [c.custKey for c in customers]
    assert [keys[i] for i in np.nonzero(sel_int)[0]] == \
        [c.custKey for c in host["selected_int"]]
    assert [keys[i] for i in np.nonzero(sel_str)[0]] == \
        [c.custKey for c in host["selected_str"]]
    assert (sel_int ^ not_int).all() and (sel_str ^ not_str).all()
    assert res["count"] == host["customer_count"][0]
    _run(p, B.group_by_supplier())
    info = dict(p.get_set_iterator("tpchbench", "supplier_info"))
    sup_names = tabs["triples"].dicts["supplier"]
    pair = res["pair_counts"].numpy()
    for sname, per_cust in info.items():
        s = sup_names.index(sname)
        for cname, parts in per_cust.items():
            assert pair[s, int(cname[len("Customer"):])] == len(parts)
        assert res["per_supplier"][s] == sum(map(len, per_cust.values()))
    heap = host["top_jaccard"][0]  # (score, custKey, name), largest first
    got = res["top_jaccard"]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _, _ in heap],
                               rtol=RTOL)
    kth = got[-1][0]
    assert {c for s, c in got if s > kth} == \
        {c for s, c, _ in heap if s > kth}


def test_queries_on_placed_sets_raise_naming_a4(tmp_path, customers):
    """``queries_on_sets`` over placed sets (once ROADMAP.md A4, now
    ported): both sets row-sharded over 8 positions, as the reference's
    over its 8 CPU devices — the selections over the padded rows, the
    supplier counts, the count and the Jaccard top-k equal the
    reference's."""
    from netsdb_tpu.parallel.placement import Placement as JPlacement
    from netsdb_tpu_torch.parallel.mesh import virtual_devices

    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    j.create_database("tpchbench")
    jt = JBC.columnarize(customers)
    for name, t in jt.items():
        j.create_set("tpchbench", name, type_name="table",
                     placement=JPlacement.data_parallel(ndim=1))
        j.send_table("tpchbench", name, t)
    query = [1, 3, 5, 7, 11]
    want = JBC.queries_on_sets(j, threshold=25, query_parts=query, k=4)
    with virtual_devices(8, "cpu"):
        p = Client(Configuration(root_dir=str(tmp_path / "port")),
                   device="cpu")
        p.create_database("tpchbench")
        for name, t in BC.columnarize(customers, device="cpu").items():
            p.create_set("tpchbench", name, type_name="table",
                         placement=Placement.data_parallel(ndim=1))
            p.send_table("tpchbench", name, t)
        got = BC.queries_on_sets(p, threshold=25, query_parts=query, k=4)
    for g, w in zip(got["selections"], want["selections"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got["pair_counts"].numpy(),
                                  np.asarray(want["pair_counts"]))
    np.testing.assert_array_equal(got["per_supplier"].numpy(),
                                  np.asarray(want["per_supplier"]))
    assert got["count"] == want["count"] == len(customers)
    assert [c for _, c in got["top_jaccard"]] == \
        [c for _, c in want["top_jaccard"]]
    np.testing.assert_allclose([s for s, _ in got["top_jaccard"]],
                               [s for s, _ in want["top_jaccard"]],
                               rtol=RTOL)


def test_bench_runs_on_the_cpu():
    res = BC.bench_tpch_bench(n_customers=2_000, n_parts=256,
                              n_suppliers=8, iters=2, device="cpu")
    assert res["triples"] == 12_000 and res["device"] == "cpu"
    assert res["jaccard_ms"] > 0
    cols = BC.bench_columns(n_customers=100, n_parts=32)
    assert set(cols) == {"customers", "triples"}
    assert cols["triples"][0]["partKey"].max() < 32
