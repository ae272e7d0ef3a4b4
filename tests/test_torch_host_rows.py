"""Parity of the port's host-record path with the JAX package: the
dispatcher's partition policies, the host nodes (``Filter``,
``MultiApply``, key-function ``Join``, ``Aggregate``, ``Partition``),
the executor's eager record path and the plan-text parser. The same
seeded records (``random.Random``, numpy) go through both packages;
lists and dicts are compared exactly and in order."""

import random
import re

import numpy as np
import pytest

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.plan import computations as JC
from netsdb_tpu.plan import parser as JP
from netsdb_tpu.plan.planner import plan_from_sinks as jax_plan
from netsdb_tpu.storage import dispatcher as JD
from netsdb_tpu_torch import Client, Configuration
from netsdb_tpu_torch.plan import computations as C
from netsdb_tpu_torch.plan import parser as P
from netsdb_tpu_torch.plan.planner import plan_from_sinks
from netsdb_tpu_torch.storage import dispatcher as D
from netsdb_tpu_torch.storage.store import SetIdentifier


@pytest.fixture()
def clients(tmp_path):
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    p = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    for c in (j, p):
        c.create_database("db")
    return j, p


def _records(n=60, seed=0):
    rng = random.Random(seed)
    return [{"k": rng.randrange(9), "g": rng.choice("abcde"),
             "v": round(rng.uniform(-10, 10), 3), "i": i,
             "words": " ".join(rng.choices(["x", "y", "z"],
                                           k=rng.randint(1, 4)))}
            for i in range(n)]


def _send(clients, name, items, **kw):
    for c in clients:
        c.create_set("db", name, type_name="object", **kw)
        c.send_data("db", name, items)


def _run(clients, build, job):
    """``build(module)`` makes a list of sinks from a computations module;
    runs them in both packages and returns both results, keyed by output
    set name."""
    j, p = clients
    rj = j.execute_computations(*build(JC), job_name=job)
    rp = p.execute_computations(*build(C), job_name=job)
    return ({k.set: v for k, v in rj.items()},
            {k.set: v for k, v in rp.items()})


def _canon(text):
    """A plan dump with node ids renumbered by first appearance (the two
    packages count node ids apart)."""
    names = {}

    def sub(m):
        return names.setdefault(m.group(0), f"#{len(names)}")

    return re.sub(r"\b(?:[A-Za-z]+_\d+|scan_\w+?_\d+)\b", sub, text)


# --- dispatcher -------------------------------------------------------
KEYS = [0, 1, -7, 2**40, True, 3.0, 2.5, -0.0, None, "", "user17",
        "ünïcode", b"raw", (1, "a"), (2, (3.5, None)), [4, "b"]]


@pytest.mark.parametrize("n", [1, 3, 8, 13])
def test_hash_policy_routes_every_key_as_the_reference(n):
    items = [{"key": k} for k in KEYS] + [{"key": i} for i in range(200)] \
        + [{"key": f"s{i}"} for i in range(200)] \
        + [{"key": (i, f"t{i}")} for i in range(100)]
    want = JD.HashPolicy(lambda r: r["key"]).partition(items, n)
    got = D.HashPolicy(lambda r: r["key"]).partition(items, n)
    assert got == want
    for k in KEYS:
        assert D._stable_key_bytes(k) == JD._stable_key_bytes(k)


def test_hash_policy_rejects_unstable_keys_as_the_reference():
    for mod in (JD, D):
        with pytest.raises(TypeError, match="primitive"):
            mod.HashPolicy(lambda x: object()).partition([1], 2)


@pytest.mark.parametrize("name,kwargs", [
    ("roundrobin", {"start": 2}), ("random", {"seed": 5}),
    ("fair", {"weights": [1.0, 2.5, 0.5]}),
    ("hash", {"key_fn": lambda x: x % 5})])
def test_policies_split_batches_as_the_reference(name, kwargs):
    jp, pp = JD.make_policy(name, **kwargs), D.make_policy(name, **kwargs)
    for batch in (list(range(17)), list(range(100, 131))):
        assert pp.partition(batch, 3) == jp.partition(batch, 3)
    assert set(D.POLICIES) == set(JD.POLICIES)


def test_policy_errors_match_the_reference():
    for mod in (JD, D):
        with pytest.raises(ValueError, match="unknown policy"):
            mod.make_policy("nope")
        with pytest.raises(ValueError, match="weights"):
            mod.FairPolicy([0.0, 0.0])
        with pytest.raises(ValueError, match="shards"):
            mod.FairPolicy([1.0, 1.0]).partition([1, 2], 3)


def test_dispatch_to_sets_matches_the_reference(clients):
    items = _records(41, seed=4)
    out = []
    for c, mod in zip(clients, (JD, D)):
        names = mod.dispatch_to_sets(c, "db", "ev", items, 4,
                                     mod.HashPolicy(lambda r: r["g"]))
        out.append([list(c.get_set_iterator("db", n)) for n in names])
        assert names == [f"ev_shard{i}" for i in range(4)]
    assert out[1] == out[0]


# --- host nodes through the executor ------------------------------------
def test_filter_join_aggregate_pipeline_matches_in_order(clients):
    recs = _records(80, seed=1)
    dims = [{"g": g, "w": i * 1.5} for i, g in enumerate("abcd")]
    _send(clients, "r", recs)
    _send(clients, "d", dims + [{"g": "a", "w": 99.0}])  # duplicate key

    def build(M):
        big = M.Filter(M.ScanSet("db", "r"), lambda r: r["v"] > -3.0,
                       label="v>-3")
        pairs = M.Join(big, M.ScanSet("db", "d"),
                       left_key=lambda r: r["g"],
                       right_key=lambda d: d["g"], label="r⋈d")
        proj = M.Join(big, M.ScanSet("db", "d"),
                      left_key=lambda r: r["g"], right_key=lambda d: d["g"],
                      project=lambda r, d: {"i": r["i"],
                                            "x": r["v"] * d["w"]},
                      label="proj")
        agg = M.Aggregate(proj, key=lambda r: r["i"] % 7,
                          value=lambda r: r["x"],
                          combine=lambda a, b: a + b, label="sum by i%7")
        return [M.WriteSet(pairs, "db", "pairs"),
                M.WriteSet(agg, "db", "agg"),
                M.WriteSet(big, "db", "big")]

    want, got = _run(clients, build, "pipe")
    assert got["pairs"] == want["pairs"]  # probe order, then bucket order
    assert list(got["agg"].items()) == list(want["agg"].items())
    assert got["big"] == want["big"]
    # materialised: a dict sink stores its items, in order
    stored = list(clients[1].get_set_iterator("db", "agg"))
    assert stored == list(want["agg"].items())


def test_multiapply_flatten_and_wordcount_match(clients):
    recs = _records(50, seed=2)
    _send(clients, "r", recs)

    def build(M):
        words = M.MultiApply(M.ScanSet("db", "r"),
                             lambda r: r["words"].split(), label="split")
        counts = M.Aggregate(words, key=lambda w: w, value=lambda w: 1,
                             combine=lambda a, b: a + b, label="wc")
        return [M.WriteSet(words, "db", "words"),
                M.WriteSet(counts, "db", "wc")]

    want, got = _run(clients, build, "flat")
    assert got["words"] == want["words"]
    assert list(got["wc"].items()) == list(want["wc"].items())


def test_fn_aggregate_and_fn_join_forward_values(clients):
    recs = _records(30, seed=3)
    _send(clients, "r", recs)

    def build(M):
        scan = M.ScanSet("db", "r")
        tot = M.Aggregate(scan, fn=lambda rs: sum(r["v"] for r in rs),
                          label="total")
        both = M.Join(scan, tot, fn=lambda rs, t: [r["i"] for r in rs
                                                   if r["v"] < t / 30],
                      label="below mean")
        return [M.WriteSet(both, "db", "below")]

    want, got = _run(clients, build, "fn")
    assert got["below"] == want["below"]


def test_partition_routes_as_the_reference_and_dispatcher(clients):
    recs = _records(70, seed=5)
    _send(clients, "r", recs)

    def build(M):
        return [M.WriteSet(M.Partition(M.ScanSet("db", "r"),
                                       lambda r: (r["k"], r["g"]), 4,
                                       label="byKG"), "db", "parts")]

    want, got = _run(clients, build, "part")
    assert list(got["parts"].items()) == list(want["parts"].items())
    disp = D.HashPolicy(lambda r: (r["k"], r["g"])).partition(recs, 4)
    assert [got["parts"][i] for i in range(4)] == disp
    with pytest.raises(ValueError, match="num_partitions"):
        C.Partition(C.ScanSet("a", "b"), lambda r: r, 0)


def test_partition_on_a_column_raises_naming_a4(clients):
    _, p = clients
    p.create_set("db", "t", type_name="table")
    p.send_table("db", "t", [{"k": 1, "v": 2.0}])
    node = C.Partition(C.ScanSet("db", "t"), "k", 2)
    assert node.label == "k"
    # the row shuffle is ported (tests/test_torch_shuffle.py); over an
    # unplaced relation it raises the reference's error
    with pytest.raises(ValueError, match="placed"):
        p.execute_computations(C.WriteSet(node, "db", "o"))


def test_plan_atoms_equal_the_reference(clients):
    def build(M):
        s = M.ScanSet("db", "r")
        f = M.Filter(s, lambda r: True, label="keep")
        m = M.MultiApply(f, lambda r: [r], label="one")
        j = M.Join(m, s, left_key=lambda r: 1, right_key=lambda r: 1)
        jo = M.Join(j, s, on=("a", "b"), take=("c",), label="dev")
        a = M.Aggregate(jo, key=lambda r: 0, value=lambda r: 1,
                        combine=lambda x, y: x + y)
        af = M.Aggregate(a, fn=len)
        pt = M.Partition(af, lambda r: r, 3)
        ap = M.Apply(pt, lambda x: x, label="rows")
        return [M.WriteSet(ap, "db", "out")]

    want = jax_plan(build(JC)).to_plan_string()
    got = plan_from_sinks(build(C)).to_plan_string()
    assert _canon(got) == _canon(want)
    assert "FLATTEN(" in got and "PARTITION(" in got and "'equijoin'" in got


# --- parser -------------------------------------------------------------
def test_plan_text_round_trip_runs_in_both_packages(clients):
    from netsdb_tpu.workloads import tpch as jtpch
    from netsdb_tpu_torch.workloads import tpch

    recs = _records(40, seed=6)
    _send(clients, "r", recs)
    text = ("s <= SCAN('db', 'r')\n"
            "f <= FILTER(s, 'pos')\n"
            "w <= FLATTEN(f, 'split')\n"
            "a <= AGGREGATE(w, 'wc')\n"
            "p <= PARTITION(f, 'byG')\n"
            "o1 <= OUTPUT(a, 'db', 'wc')\n"
            "o2 <= OUTPUT(p, 'db', 'parts')")
    registry = {"pos": lambda r: r["v"] > 0,
                "split": lambda r: r["words"].split(),
                "wc": {"key": lambda w: w, "value": lambda w: 1,
                       "combine": lambda a, b: a + b},
                "byG": {"key_fn": lambda r: r["g"], "num_partitions": 3}}
    jparsed, parsed = JP.parse_plan(text), P.parse_plan(text)
    assert parsed.to_plan_string() == jparsed.to_plan_string()
    assert [a.name for a in parsed.scans] == ["s"]
    assert [a.literals for a in parsed.outputs] == [["db", "wc"],
                                                     ["db", "parts"]]
    rj = clients[0].execute_computations(
        *jparsed.to_computations(registry), job_name="parsed")
    rp = clients[1].execute_computations(
        *parsed.to_computations(registry), job_name="parsed")
    for ident in rj:
        assert list(rp[SetIdentifier(*ident)].items()) == \
            list(rj[ident].items())
    # a real dump survives the round trip, and rebinds
    dump = plan_from_sinks([tpch.q03()]).to_plan_string()
    assert P.parse_plan(dump).to_plan_string() == dump
    assert _canon(dump) == _canon(jax_plan([jtpch.q03()]).to_plan_string())


@pytest.mark.parametrize("text,match", [
    ("garbage line without arrow", "cannot parse"),
    ("a <= FILTER(missing, 'p')", "undefined"),
    ("a <= SCAN('d', 's')\na <= SCAN('d', 't')", "duplicate"),
    ("s <= SCAN('d')", "takes"),
    ("s <= SCAN('d', 's')\nw <= OUTPUT(s, 'db')", "takes"),
    ("a <= SCAN('d', 's')\nb <= MYSTERY(a, 'x')", "unknown atom kind"),
    ("a <= SCAN('d', 's')\nb <= FILTER(a, 'nolabel')", "no registry"),
    ("a <= SCAN('d', 's')\nb <= PARTITION(a, 'p')", "num_partitions"),
    ("a <= FILTER(b, 'x')\nb <= FILTER(a, 'x')", "cycle")])
def test_parse_errors_match_the_reference(text, match):
    registry = {"x": lambda v: v, "p": lambda v: v}
    for mod in (JP, P):
        with pytest.raises(mod.PlanParseError, match=match):
            mod.parse_plan(text).to_computations(registry)


def test_out_of_order_text_builds_and_runs(clients):
    text = ("w <= OUTPUT(f, 'db', 'odd')\n"
            "f <= FILTER(s, 'odd')\n"
            "s <= SCAN('db', 'nums')")
    _send(clients, "nums", list(range(25)))
    reg = {"odd": lambda x: x % 2 == 1}
    got = [next(iter(c.execute_computations(
        *mod.parse_plan(text).to_computations(reg)).values()))
        for c, mod in zip(clients, (JP, P))]
    assert got[1] == got[0] == list(range(1, 25, 2))


def test_shared_record_subgraph_runs_once(clients):
    _, p = clients
    p.create_set("db", "n", type_name="object")
    p.send_data("db", "n", list(range(10)))
    calls = []

    def pred(x):
        calls.append(x)
        return x > 4

    shared = C.Filter(C.ScanSet("db", "n"), pred, label="x>4")
    s1 = C.WriteSet(C.Aggregate(shared, fn=lambda xs: [sum(xs)],
                                label="sum"), "db", "o1")
    s2 = C.WriteSet(C.MultiApply(shared, lambda x: [x, x], label="dup"),
                    "db", "o2")
    out = p.execute_computations(s1, s2)
    assert len(calls) == 10
    assert out[SetIdentifier("db", "o1")] == [sum(range(5, 10))]
    assert np.array_equal(out[SetIdentifier("db", "o2")],
                          [x for x in range(5, 10) for _ in (0, 1)])
