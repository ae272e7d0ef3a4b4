"""The port's fusion region mapper (``netsdb_tpu_torch/plan/fusion.py``)
against the reference's (``netsdb_tpu/plan/fusion.py``).

The same plans are built in both packages — the mixed q06 + spine plan,
the graft chain (a rowwise pre-chain and an epilogue around a streamed
fold), the post-only graft whose fold may take the grace hash, and q03
over paged sets (the grace hash) — over the same numpy data (a seed). The
mapper is pure Python, so its region maps must be EQUAL: region kinds,
member labels in order, pre and post chains, fingerprints, under both
mappers, at several ``fusion_min_region`` floors, and the splits under
``fusion_stage_budget_bytes`` when both ledgers are fed the same rows.
Results: the port fused, the port node by node (``plan_fusion=False``)
and the reference must agree — the port's two exactly (the same eager
ops on the CPU), the reference within rtol 1e-5 (float sums in another
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from netsdb_tpu import obs as jobs
from netsdb_tpu.client import Client as JClient
from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.plan import executor as jex
from netsdb_tpu.plan import fusion as jfusion
from netsdb_tpu.plan import computations as jcomp
from netsdb_tpu.plan import fold as jfold
from netsdb_tpu.plan.planner import plan_from_sinks as jplan_from_sinks
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational import tuning as JT
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.storage.store import SetIdentifier as JIdent
from netsdb_tpu_torch import Client, obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import computations as pcomp
from netsdb_tpu_torch.plan import executor as pex
from netsdb_tpu_torch.plan import fold as pfold
from netsdb_tpu_torch.plan import fusion as pfusion
from netsdb_tpu_torch.plan.planner import plan_from_sinks
from netsdb_tpu_torch.relational import dag as pdag
from netsdb_tpu_torch.relational import tuning as T
from netsdb_tpu_torch.relational.table import ColumnTable

RTOL = 1e-5


class Side:
    """One package's pieces, so a plan is written once for both."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.comp = jcomp if ref else pcomp
        self.fold = jfold if ref else pfold
        self.dag = jdag if ref else pdag
        self.executor = jex if ref else pex
        self.fusion = jfusion if ref else pfusion
        self.obs = jobs if ref else obs
        self.plan_from_sinks = jplan_from_sinks if ref else plan_from_sinks

    def client(self, tmp_path, **cfg):
        cfg.setdefault("fusion_cost_source", "static")
        if self.ref:
            return JClient(JConfiguration(root_dir=str(tmp_path / "ref"),
                                          **cfg))
        return Client(Configuration(root_dir=str(tmp_path / "port"), **cfg),
                      device="cpu")

    def table(self, cols, dicts=None):
        if self.ref:
            return JTable(dict(cols), dict(dicts or {}))
        return ColumnTable.from_columns(cols, dicts, device="cpu")

    def ctable(self, cols, like):
        """A table of ``cols`` with ``like``'s dictionaries and mask."""
        return (JTable if self.ref else ColumnTable)(cols, like.dicts,
                                                     like.valid)

    def xsum(self, x):
        return jnp.sum(x) if self.ref else torch.sum(x)

    def segment_sum(self, state, chunk, nk):
        if self.ref:
            seg = jnp.where(chunk.mask(), chunk["k"], 0)
            vals = jnp.where(chunk.mask(), chunk["v"], 0.0)
            return state + jax.ops.segment_sum(vals, seg, num_segments=nk)
        seg = torch.where(chunk.mask(), chunk["k"], 0).long()
        vals = torch.where(chunk.mask(), chunk["v"], 0.0)
        return state + torch.zeros(nk).index_add_(0, seg, vals)

    def zeros(self, nk):
        return jnp.zeros((nk,), jnp.float32) if self.ref else torch.zeros(nk)

    def scan_values(self, c, plan):
        if not self.ref:
            return pex.scan_values(c, plan)
        out = {}
        for n in plan.topo:
            if isinstance(n, jcomp.ScanSet):
                items = c.store.get_items(JIdent(n.db, n.set_name))
                out[n.node_id] = items[0] if len(items) == 1 else items
        return out


SIDES = {"ref": Side(True), "port": Side(False)}


@pytest.fixture(autouse=True)
def _clean():
    jex.clear_compiled_cache()
    pex.clear_compiled_cache()
    yield
    JT.clear_overrides()
    T.clear_overrides()


# --- the plans -------------------------------------------------------------

def ingest_lineitem(side, c, n, seed=2):
    rng = np.random.default_rng(seed)
    if c.set_exists("d", "lineitem"):
        c.remove_set("d", "lineitem")
    c.create_set("d", "lineitem", type_name="table", storage="paged")
    c.send_table("d", "lineitem", side.table({
        "l_shipdate": rng.integers(19940101, 19950101, n, dtype=np.int32),
        "l_discount": np.full(n, 0.06, np.float32),
        "l_quantity": np.full(n, 10.0, np.float32),
        "l_extendedprice": rng.uniform(1000, 2000, n).astype(np.float32)}))


def ingest_dim(side, c, m=512, seed=0):
    rng = np.random.default_rng(seed)
    if not c.set_exists("d", "dim"):
        c.create_set("d", "dim", type_name="table")
    c.send_table("d", "dim", side.table(
        {"x": rng.standard_normal(m).astype(np.float32)}))


def mixed_sink(side, spine=4):
    """q06's paged fold joined to a ``spine``-node resident Apply chain."""
    C = side.comp
    node = C.ScanSet("d", "dim")
    for i in range(spine):
        node = C.Apply(node, lambda t, _i=i: side.ctable(
            {"x": t["x"] * (1.0 + 1e-6 * _i)}, t), label=f"sp{i}")
    z = C.Apply(node, lambda t: side.xsum(t["x"]) * 1e-9, label="zsum")
    q06 = side.dag.q06_sink("d")
    j = C.Join(q06.inputs[0], z, fn=lambda rev, v: side.ctable(
        {"revenue": rev["revenue"] + v}, rev), label="combine")
    return C.WriteSet(j, "d", "out")


def ingest_fact(side, c, name, n, nk, seed):
    rng = np.random.default_rng(seed)
    c.create_set("d", name, type_name="table", storage="paged")
    cols = {"k": rng.integers(0, nk, n, dtype=np.int32),
            "v": rng.uniform(0.0, 10.0, n).astype(np.float32)}
    c.send_table("d", name, side.table(cols))
    return cols


def graft_sink(side, nk=64):
    """A rowwise pre-chain, a segment-sum fold and a two-node epilogue."""
    C = side.comp
    s = C.ScanSet("d", "fact")
    pre = C.Apply(s, lambda t: side.ctable({"k": t["k"], "v": t["v"] * 1.5},
                                           t), label="pre", rowwise=True)
    fold = side.fold.single_pass(
        lambda prev, src: side.zeros(nk),
        lambda st, ch: side.segment_sum(st, ch, nk), lambda st, src: st)
    agg = C.Apply(pre, fold=fold, label="seg")
    e1 = C.Apply(agg, lambda v: v + 1.0, label="e1")
    e2 = C.Apply(e1, lambda v: v * 0.5, label="e2")
    return C.WriteSet(e2, "d", "graft_out")


def gpath_sink(side, nk=32):
    """A grace-capable fold (declared keys) after a rowwise chain: the
    chain is not grafted, the epilogue is."""
    C = side.comp
    s = C.ScanSet("d", "gfact")
    pre = C.Apply(s, lambda t: side.ctable({"k": t["k"], "v": t["v"] * 2.0},
                                           t), label="gpre", rowwise=True)
    fold = side.fold.FoldSpec(
        ((lambda prev, src: side.zeros(nk),
          lambda st, ch: side.segment_sum(st, ch, nk)),),
        lambda st, src: st, merge=lambda a, b: a + b, probe_key="k",
        build_key="k")
    agg = C.Apply(pre, fold=fold, label="gseg")
    epi = C.Apply(agg, lambda v: v * 10.0, label="gepi")
    return C.WriteSet(epi, "d", "g_out")


def _tpch_tables():
    from netsdb_tpu.relational.queries import tables_from_rows
    from netsdb_tpu.workloads import tpch

    tables = tables_from_rows(tpch.generate(scale=6, seed=3))
    return {n: ({k: np.asarray(v) for k, v in t.cols.items()},
                {k: list(v) for k, v in t.dicts.items()},
                None if t.valid is None else np.asarray(t.valid))
            for n, t in tables.items()}


_TPCH = {}


def tpch_tables():
    if not _TPCH:
        _TPCH.update(_tpch_tables())
    return _TPCH


def load_tpch(side, c):
    for name, (cols, dicts, valid) in tpch_tables().items():
        paged = name in ("lineitem", "orders", "customer")
        c.create_set("d", name, type_name="table",
                     storage="paged" if paged else "memory")
        if side.ref:
            c.send_table("d", name, JTable(cols, dicts, valid))
        else:
            c.send_table("d", name, ColumnTable.from_columns(
                cols, dicts, valid, device="cpu"))


def q03_sink(side, c):
    return side.dag.q03_sink_for(c, "d")


PLANS = ("mixed", "graft", "gpath", "q03")


def build(name, side, tmp_path, **cfg):
    """(client, sink) of plan ``name`` on ``side`` (both sides get the same
    data from the same seeds). q03 runs in the reference's test arena, so
    its three facts spill and take the grace hash."""
    if name == "q03":
        cfg.update(page_size_bytes=4096, page_pool_bytes=16384)
    c = side.client(tmp_path, **cfg)
    c.create_database("d")
    if name == "mixed":
        ingest_lineitem(side, c, 900)
        ingest_dim(side, c)
        return c, mixed_sink(side)
    if name == "graft":
        ingest_fact(side, c, "fact", 5000, 64, 0)
        return c, graft_sink(side)
    if name == "gpath":
        ingest_fact(side, c, "gfact", 3000, 32, 1)
        return c, gpath_sink(side)
    load_tpch(side, c)
    return c, q03_sink(side, c)


def labels(plan, ids):
    by_id = {n.node_id: n for n in plan.topo}
    return [getattr(by_id[i], "label", "") or by_id[i].op_kind for i in ids]


def describe(side, c, sink, job, **cfg):
    """The region map of ``sink``'s plan as plain data."""
    plan = side.plan_from_sinks([sink])
    config = c.store.config
    for k, v in cfg.items():
        setattr(config, k, v)
    rmap = side.fusion.map_regions(plan, side.scan_values(c, plan), config,
                                   job, traceable=side.executor._is_traceable)
    return [(r.rid, r.kind, labels(plan, r.node_ids), labels(plan, r.pre_ids),
             labels(plan, r.post_ids), r.fingerprint,
             None if r.anchor is None else labels(plan, [r.anchor])[0])
            for r in rmap.regions]


# --- region maps -----------------------------------------------------------

@pytest.mark.parametrize("mapper", ["optimal", "greedy"])
@pytest.mark.parametrize("plan", PLANS)
def test_region_maps_equal_the_reference(tmp_path, plan, mapper):
    maps = {}
    for key, side in SIDES.items():
        c, sink = build(plan, side, tmp_path / key)
        maps[key] = describe(side, c, sink, f"map-{plan}",
                             fusion_mapper=mapper)
    assert maps["port"] == maps["ref"]
    # q03's folds declare join keys (the grace hash) and its resident
    # nodes feed them directly: no region in either package
    assert bool(maps["port"]) == (plan != "q03")


@pytest.mark.parametrize("floor", [2, 3, 6, 7, 99])
def test_min_region_floor_equals_the_reference(tmp_path, floor):
    maps = {}
    for key, side in SIDES.items():
        c, sink = build("mixed", side, tmp_path / key)
        maps[key] = describe(side, c, sink, "map-floor",
                             fusion_min_region=floor)
    assert maps["port"] == maps["ref"]
    spines = [m for m in maps["port"] if m[1] == "spine"]
    # sp0..sp3, zsum and combine: one run of six nodes
    assert (len(spines) == 1) == (floor <= 6)


def _feed_ledger(side, job, spine, nbytes):
    led = side.obs.operators.LEDGER
    for i in range(spine):
        led.add(job, f"Apply:sp{i}", {"wall_s": 1e-3, "device_est_s": 0.0,
                                      "counters": {"bytes_in": nbytes}})
    for label, kind in (("zsum", "Apply"), ("combine", "Join")):
        led.add(job, f"{kind}:{label}", {"wall_s": 1e-3, "device_est_s": 0.0,
                                         "counters": {"bytes_in": nbytes}})


@pytest.mark.parametrize("budget", [0, 3 << 20, 5 << 20, 1 << 30])
def test_stage_budget_splits_equal_the_reference(tmp_path, budget):
    """Both ledgers hold the same rows (1 MiB staged per node, 1 ms of
    dispatch): under a budget the optimal mapper splits the eight-node run
    at the same seams in both packages."""
    job = f"map-budget-{budget}"
    maps, splits = {}, {}
    for key, side in SIDES.items():
        c, _ = build("mixed", side, tmp_path / key)
        _feed_ledger(side, job, 6, 1 << 20)
        before = side.obs.REGISTRY.counter("fusion.splits").value
        maps[key] = describe(side, c, mixed_sink(side, spine=6), job,
                             fusion_cost_source="ledger",
                             fusion_stage_budget_bytes=budget)
        splits[key] = side.obs.REGISTRY.counter("fusion.splits").value \
            - before
    assert maps["port"] == maps["ref"]
    assert splits["port"] == splits["ref"]
    spines = [m for m in maps["port"] if m[1] == "spine"]
    if budget == 3 << 20:
        assert len(spines) >= 2 and splits["port"] >= 1
    if budget in (0, 1 << 30):
        assert len(spines) == 1


@pytest.mark.parametrize("mapper", ["optimal", "greedy"])
def test_chronic_retracers_stay_out_like_the_reference(tmp_path, mapper):
    job = f"map-retrace-{mapper}"
    maps = {}
    for key, side in SIDES.items():
        c, sink = build("mixed", side, tmp_path / key)
        side.obs.operators.LEDGER.add(job, "Apply:sp1", {
            "wall_s": 1.0, "device_est_s": 0.1, "counters": {"traces": 9.0}})
        maps[key] = describe(side, c, sink, job, fusion_cost_source="ledger",
                             fusion_mapper=mapper)
    assert maps["port"] == maps["ref"]
    for m in maps["port"]:
        assert "sp1" not in m[2]


def test_cost_model_matches_the_reference():
    job = "cost-parity"
    rows = {"Apply:hot": {"wall_s": 1.0, "device_est_s": 0.2,
                          "counters": {"traces": 10.0, "bytes_in": 4096}},
            "Join:cold": {"wall_s": 1e-6, "device_est_s": 0.0}}
    got = {}
    for key, side in SIDES.items():
        for label, row in rows.items():
            side.obs.operators.LEDGER.add(job, label, row)
        cm = side.fusion.CostModel(job, source="ledger")

        class N:
            def __init__(self, kind, label):
                self.op_kind, self.label = kind, label

        nodes = [N("Apply", "hot"), N("Join", "cold"), N("Apply", "unseen")]
        got[key] = ([cm.dispatch_overhead_s(n) for n in nodes],
                    [cm.retrace_rate(n) for n in nodes],
                    [cm.staged_bytes(n) for n in nodes],
                    cm.region_profitable(nodes[1:]),
                    cm.region_profitable(nodes))
    assert got["port"] == got["ref"]


def test_classify_values_matches_the_reference(tmp_path):
    kinds = {}
    for key, side in SIDES.items():
        c, sink = build("graft", side, tmp_path / key)
        plan = side.plan_from_sinks([sink])
        k = side.fusion.classify_values(plan, side.scan_values(c, plan))
        kinds[key] = [k[n.node_id] for n in plan.topo]
    assert kinds["port"] == kinds["ref"]
    assert "rowwise_paged" in kinds["port"]


# --- results: fused, node by node, reference ---------------------------------

def _result(side, c, sink, job):
    out = c.execute_computations(sink, job_name=job)
    val = next(iter(out.values()))
    if hasattr(val, "cols"):
        return {k: np.asarray(v) for k, v in val.cols.items()}
    return np.asarray(val)


def _same(a, b, exact):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k], exact)
        return
    if exact or a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("plan", ["mixed", "graft", "gpath"])
def test_fused_unfused_and_reference_agree(tmp_path, plan):
    ref_c, ref_sink = build(plan, SIDES["ref"], tmp_path / "ref")
    ref = _result(SIDES["ref"], ref_c, ref_sink, f"res-{plan}")
    port = SIDES["port"]
    c, sink = build(plan, port, tmp_path / "port")
    fused = _result(port, c, sink, f"res-{plan}")
    c.store.config.plan_fusion = False
    unfused = _result(port, c, {"mixed": mixed_sink, "graft": graft_sink,
                                "gpath": gpath_sink}[plan](port),
                      f"res-{plan}-off")
    _same(fused, unfused, exact=True)
    _same(fused, ref, exact=False)


def test_fused_equals_unfused_on_grace_hash_q03(tmp_path):
    rows = {}
    for fused in (True, False):
        for key, side in SIDES.items():
            c, sink = build("q03", side, tmp_path / f"{key}{int(fused)}",
                            plan_fusion=fused)
            rows[key, fused] = side.dag.q03_rows(side.dag.run_query(c, sink))
    assert rows["port", True] == rows["port", False]
    assert [r["okey"] for r in rows["port", True]] == \
        [r["okey"] for r in rows["ref", True]]
    np.testing.assert_allclose([r["revenue"] for r in rows["port", True]],
                               [r["revenue"] for r in rows["ref", True]],
                               rtol=RTOL)


def test_graft_result_matches_numpy(tmp_path):
    side = SIDES["port"]
    c = side.client(tmp_path)
    c.create_database("d")
    cols = ingest_fact(side, c, "fact", 5000, 64, 0)
    got = _result(side, c, graft_sink(side), "graft-np")
    want = np.zeros(64, np.float64)
    np.add.at(want, cols["k"], cols["v"].astype(np.float64) * 1.5)
    np.testing.assert_allclose(got, (want + 1.0) * 0.5, rtol=RTOL)


# --- programs a fused plan builds --------------------------------------------

def test_spine_compiles_one_program_like_the_reference(tmp_path):
    """Fused: one region program plus q06's fold step; per node: six
    ``eager::`` programs plus the fold step — in both packages."""
    new = {}
    for key, side in SIDES.items():
        c, _ = build("mixed", side, tmp_path / key)
        for fusion in (True, False):
            c.store.config.plan_fusion = fusion
            k0 = set(side.executor.compiled_cache_keys())
            _result(side, c, mixed_sink(side), f"n1-{fusion}")
            new[key, fusion] = sorted(
                k.split("::")[0] for k in
                set(side.executor.compiled_cache_keys()) - k0)
    assert new["port", True] == new["ref", True] == ["fold", "region"]
    assert new["port", False] == new["ref", False] == \
        ["eager"] * 6 + ["fold"]


def test_graft_programs_like_the_reference(tmp_path):
    new = {}
    for key, side in SIDES.items():
        c = side.client(tmp_path / key)
        c.create_database("d")
        ingest_fact(side, c, "fact", 5000, 64, 0)
        for fusion in (True, False):
            c.store.config.plan_fusion = fusion
            k0 = set(side.executor.compiled_cache_keys())
            _result(side, c, graft_sink(side), f"gr-{fusion}")
            new[key, fusion] = sorted(
                k.split("::")[0] + ("::fz" in k) * "+fz" + k.endswith(
                    "::epi") * "+epi"
                for k in set(side.executor.compiled_cache_keys()) - k0)
    assert new["port", True] == new["ref", True]
    assert new["port", False] == new["ref", False]
    assert new["port", True] == ["fold+fz", "region+epi"]


def test_regions_formed_counter_ticks(tmp_path):
    side = SIDES["port"]
    c, sink = build("mixed", side, tmp_path)
    before = obs.REGISTRY.counter("fusion.regions_formed").value
    _result(side, c, sink, "counter")
    assert obs.REGISTRY.counter("fusion.regions_formed").value > before
    assert obs.REGISTRY.counter("fusion.nodes_fused").value > 0


def test_fallback_is_counted_and_annotated(tmp_path):
    """A region abandoned at run time (values a program cannot take) is a
    counted fallback with its reason on the query's trace."""
    c, _ = build("mixed", SIDES["port"], tmp_path)
    assert not pex._program_safe_values([[1, 2, 3]])
    assert pex._program_safe_values([(c.get_table("d", "dim"),)])
    before = obs.REGISTRY.counter("fusion.fallbacks").value
    with obs.trace() as tr:
        pfusion.fallback("spine inputs not program-safe")
    assert obs.REGISTRY.counter("fusion.fallbacks").value == before + 1
    prof = tr.profile_dict
    assert prof["counters"]["fusion.fallbacks"] == 1
    assert prof["meta"]["fusion.fallback"] == "spine inputs not program-safe"


@pytest.mark.parametrize("label,rowwise", [
    ("pre:affine", True), ("pre:project", True), ("pre:scale", True),
    ("pre:other", False), ("scale", False)])
def test_rowwise_derivation_matches_the_reference(label, rowwise):
    for comp in (jcomp, pcomp):
        node = comp.Apply(comp.ScanSet("d", "x"), lambda t: t, label=label)
        assert node.rowwise is rowwise
        assert comp.Apply(comp.ScanSet("d", "x"), lambda t: t, label=label,
                          rowwise=not rowwise).rowwise is (not rowwise)
