"""``plan/scatter.py`` and ``fusion.compile_scatter_merge`` against the
reference's: the same DAG shapes get the same scatter kind, scan sets,
axis and refusals; every merge gives the reference's result on the same
integer partials exactly; the compiled merge equals the eager one and
carries the reference's program key."""

import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockedTensor as JBlocked
from netsdb_tpu.models.ff import FFModel as JFF
from netsdb_tpu.plan import computations as JC
from netsdb_tpu.plan import executor as jex
from netsdb_tpu.plan import scatter as JS
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.workloads import serve_bench as jsb
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.plan import computations as C
from netsdb_tpu_torch.plan import executor as pex
from netsdb_tpu_torch.plan import fusion
from netsdb_tpu_torch.plan import scatter as S
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.workloads import serve_bench as sb

SHARDED = {("d", "lineitem"), ("d", "orders"), ("d", "objs"),
           ("ff", "inputs"), ("d", "other")}


def _is_sharded(db, s):
    return (db, s) in SHARDED


def _group_sink(mod, rowwise_filter=True):
    scan = mod.ScanSet("d", "objs")
    inner = mod.Filter(scan, lambda r: r["v"] > 2, label="v>2") \
        if rowwise_filter else mod.Apply(scan, fn=lambda t: t,
                                         label="whole")
    node = mod.Aggregate(inner, key=lambda r: r["k"],
                         value=lambda r: r["v"],
                         combine=lambda a, b: a + b, label="sumv")
    return mod.WriteSet(node, "d", "g_out")


def _ff_sink(model_cls, stamp=True):
    sink = model_cls(db="ff", block=(4, 4)).build_inference_dag()
    if stamp:
        sink.scatter_gather = {"axis": 1, "block": (4, 4),
                               "mode": "concat"}
    return sink


def _whole_apply(mod):
    return mod.WriteSet(mod.Apply(mod.ScanSet("d", "lineitem"),
                                  fn=lambda t: t, label="whole"),
                        "d", "out")


#: (name, port sinks, reference sinks)
SHAPES = [
    ("fold_state", lambda: [sb.scaleout_q01_sink("d")],
     lambda: [jsb.scaleout_q01_sink("d")]),
    ("real_q01", lambda: [dag.q01_sink("d")], lambda: [jdag.q01_sink("d")]),
    ("q06", lambda: [dag.q06_sink("d")], lambda: [jdag.q06_sink("d")]),
    ("group", lambda: [_group_sink(C)], lambda: [_group_sink(JC)]),
    ("group_whole", lambda: [_group_sink(C, False)],
     lambda: [_group_sink(JC, False)]),
    ("join", lambda: [sb.scaleout_join_sink("d", 300)],
     lambda: [jsb.scaleout_join_sink("d", 300)]),
    ("ff_stamped", lambda: [_ff_sink(FFModel)], lambda: [_ff_sink(JFF)]),
    ("ff_bare", lambda: [_ff_sink(FFModel, False)],
     lambda: [_ff_sink(JFF, False)]),
    ("whole_apply", lambda: [_whole_apply(C)], lambda: [_whole_apply(JC)]),
    ("multi", lambda: [sb.scaleout_q01_sink("d"),
                       sb.scaleout_q01_sink("d", cutoff=19950101,
                                            output_set="b")],
     lambda: [jsb.scaleout_q01_sink("d"),
              jsb.scaleout_q01_sink("d", cutoff=19950101,
                                    output_set="b")]),
    ("multi_mixed", lambda: [sb.scaleout_q01_sink("d"), _group_sink(C)],
     lambda: [jsb.scaleout_q01_sink("d"), _group_sink(JC)]),
    ("multi_two_sets", lambda: [sb.scaleout_q01_sink("d"),
                                sb.scaleout_q01_sink(
                                    "d", lineitem_set="other",
                                    output_set="b")],
     lambda: [jsb.scaleout_q01_sink("d"),
              jsb.scaleout_q01_sink("d", lineitem_set="other",
                                    output_set="b")]),
    ("unsharded", lambda: [sb.scaleout_q01_sink("x")],
     lambda: [jsb.scaleout_q01_sink("x")]),
]


def _describe(spec):
    if spec is None:
        return None
    out = {"kind": spec.kind, "scan_sets": tuple(spec.scan_sets)}
    if isinstance(spec, (S.ScatterSpec, JS.ScatterSpec)):
        out.update(probe=spec.probe, build=spec.build,
                   gather=spec.gather, sink=spec.sink.set_name,
                   node=type(spec.node).__name__)
    else:
        out["components"] = [c.sink.set_name for c in spec.components]
    return out


@pytest.mark.parametrize("name,port,ref", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_analyze_sinks_matches_the_reference(name, port, ref):
    got = S.analyze_sinks(port(), _is_sharded)
    want = JS.analyze_sinks(ref(), _is_sharded)
    assert _describe(got) == _describe(want), name
    assert S.sharded_scan_sets(port(), _is_sharded) == \
        JS.sharded_scan_sets(ref(), _is_sharded)


def test_partial_sinks_mint_ids_above_the_dag():
    spec = S.analyze_sinks([sb.scaleout_q01_sink("d")], _is_sharded)
    sink = S.partial_sink(spec)
    partial = sink.inputs[0]
    assert partial.scatter_partial and partial.label.endswith("::partial")
    assert partial.node_id > spec.node.inputs[0].node_id
    assert sink.node_id == partial.node_id + 1
    assert sink.set_name == "__scatter_partial__"
    mspec = S.analyze_sinks(SHAPES[9][1](), _is_sharded)
    msink = S.multi_partial_sink(mspec)
    assert msink.inputs[0].label == (
        "multi::scaleq01:19980902+scaleq01:19950101::partial")
    gspec = S.analyze_sinks([_group_sink(C)], _is_sharded)
    gsink = S.partial_sink(gspec)
    assert gsink.inputs[0] is gspec.node


def _q01_partials(seed, nslots=3):
    """Each slot's scaleout q01 state over its rows, both packages."""
    table = jsb.scaleout_table(900, seed=seed)
    cols = {k: np.asarray(v) for k, v in table.cols.items()}
    jfold = jsb.scaleout_q01_sink("d").inputs[0].fold
    pfold = sb.scaleout_q01_sink("d").inputs[0].fold
    jstates, pstates = [], []
    for lo, hi in _range_slices(900, nslots):
        part = {k: v[lo:hi] for k, v in cols.items()}
        jt = JTable(part, dict(table.dicts), None)
        pt = ColumnTable({k: torch.from_numpy(v) for k, v in part.items()},
                         dict(table.dicts), None)
        init, step = jfold.passes[0]
        jstates.append(step(init(None, jt), jt))
        init, step = pfold.passes[0]
        pstates.append(step(init(None, pt), pt))
    return jfold, pfold, jstates, pstates, dict(table.dicts)


def _range_slices(n, k):
    from netsdb_tpu_torch.serve.placement import range_slices

    return range_slices(n, k)


def _cols(t):
    ok = np.asarray(t.mask())
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)[ok]
            for k, v in t.cols.items()}


def test_merge_fold_states_equals_the_reference():
    jfold, pfold, js, ps, dicts = _q01_partials(3)
    want = JS.merge_fold_states(jfold, js, dicts, 900)
    got = S.merge_fold_states(pfold, ps, dicts, 900)
    w, g = _cols(want), _cols(got)
    assert sorted(w) == sorted(g)
    for k in w:
        assert np.array_equal(g[k], w[k]), k
    assert got.dicts == want.dicts


def test_multi_fold_merge_equals_the_reference():
    jfold, pfold, js, ps, dicts = _q01_partials(4)
    jm = JS.MultiFoldMerge(tuple(
        JS.analyze_sinks(SHAPES[9][2](), _is_sharded).components))
    pm = S.MultiFoldMerge(tuple(
        S.analyze_sinks(SHAPES[9][1](), _is_sharded).components))
    want = JS.merge_fold_states(jm, [(s, s) for s in js], dicts, 900)
    got = S.merge_fold_states(pm, [(s, s) for s in ps], dicts, 900)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k, v in _cols(w).items():
            assert np.array_equal(_cols(g)[k], v), k


def test_compile_scatter_merge_equals_eager_and_keys_like_the_reference():
    jfold, pfold, js, ps, dicts = _q01_partials(5)
    pex.clear_compiled_cache()
    jex.clear_compiled_cache()
    before = obs.REGISTRY.counter("fusion.distributed_regions").value
    got = S.merge_fold_states_compiled(pfold, ps, dicts, 900, "job",
                                       "scaleq01:19980902")
    assert obs.REGISTRY.counter("fusion.distributed_regions").value \
        == before + 1
    eager = S.merge_fold_states(pfold, ps, dicts, 900)
    for k, v in _cols(eager).items():
        assert np.array_equal(_cols(got)[k], v), k
    want = JS.merge_fold_states_compiled(jfold, js, dicts, 900, "job",
                                         "scaleq01:19980902")
    for k, v in _cols(want).items():
        assert np.array_equal(_cols(got)[k], v), k
    key = [k for k in pex.compiled_cache_keys() if "::scatter::" in k]
    assert key == [k for k in jex.compiled_cache_keys()
                   if "::scatter::" in k]
    assert key[0].startswith("region::job::scatter::scaleq01:19980902"
                             "::merge::k3::")
    # another dictionary or row count is another program
    S.merge_fold_states_compiled(pfold, ps, dicts, 901, "job",
                                 "scaleq01:19980902")
    assert len([k for k in pex.compiled_cache_keys()
                if "::scatter::" in k]) == 2
    direct = fusion.compile_scatter_merge(
        pfold, 3, S.SchemaProxy(dicts, 900), "job", "scaleq01:19980902")
    for k, v in _cols(direct(tuple(ps))).items():
        assert np.array_equal(_cols(got)[k], v), k


def test_compile_scatter_merge_failure_falls_back_counted():
    jfold, pfold, js, ps, dicts = _q01_partials(6)

    class Broken:
        state_merge = staticmethod(lambda a, b: 1 / 0)
        finalize = pfold.finalize

    before = obs.REGISTRY.counter("fusion.fallbacks").value
    with pytest.raises(ZeroDivisionError):
        S.merge_fold_states_compiled(Broken(), ps, dicts, 900, "jb", "x")
    assert obs.REGISTRY.counter("fusion.fallbacks").value == before + 1
    # host-object states never reach a program (the reference's rule)
    out = S.merge_fold_states_compiled(
        pfold, [tuple(s) for s in ps], dicts, 900, "jb", "y",
        traceable=False)
    for k, v in _cols(S.merge_fold_states(pfold, ps, dicts, 900)).items():
        assert np.array_equal(_cols(out)[k], v)


def test_merge_group_dicts_equals_the_reference():
    parts = [{i % 5: i for i in range(s, s + 9)} for s in (0, 4, 11)]
    node = _group_sink(C).inputs[0]
    jnode = _group_sink(JC).inputs[0]
    assert S.merge_group_dicts(node, parts) == \
        JS.merge_group_dicts(jnode, parts)


def test_merge_join_outputs_equals_the_reference():
    rng = np.random.default_rng(2)
    parts = [(rng.integers(0, 99, n, dtype=np.int32),
              rng.integers(0, 9, n, dtype=np.int32)) for n in (5, 0, 7)]
    jfold = jsb.scaleout_join_sink("d", 99).inputs[0].fold
    pfold = sb.scaleout_join_sink("d", 99).inputs[0].fold
    want = JS.merge_join_outputs(jfold, [
        JTable({"okey": k, "rev": r}, valid=r > 0) for k, r in parts])
    got = S.merge_join_outputs(pfold, [
        ColumnTable({"okey": torch.from_numpy(k),
                     "rev": torch.from_numpy(r)},
                    valid=torch.from_numpy(r > 0)) for k, r in parts])
    for k, v in _cols(want).items():
        assert np.array_equal(_cols(got)[k], v), k


@pytest.mark.parametrize("gather", [
    {"axis": 1, "block": (4, 4), "mode": "concat"},
    {"axis": 0, "block": None},
    {"mode": "items"}])
def test_merge_tensor_chain_equals_the_reference(gather):
    rng = np.random.default_rng(9)
    if gather.get("mode") == "items":
        parts = [[rng.standard_normal((2, 3)).astype(np.float32)
                  for _ in range(n)] for n in (2, 1, 3)]
        got = S.merge_tensor_chain(gather, parts)
        want = JS.merge_tensor_chain(gather, parts)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        return
    axis = gather["axis"]
    shapes = [(5, 3), (5, 4), (5, 2)] if axis == 1 else \
        [(3, 5), (4, 5), (2, 5)]
    parts = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = JS.merge_tensor_chain(gather, parts)
    got = S.merge_tensor_chain(gather, [torch.from_numpy(p) for p in parts])
    if gather["block"]:
        assert isinstance(want, JBlocked)
        assert tuple(got.meta.block_shape) == tuple(want.meta.block_shape)
        assert np.array_equal(got.to_dense().numpy(),
                              np.asarray(want.to_dense()))
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_scatter_partial_fold_forms_an_anchor_region(tmp_path):
    """A shard's partial fold over a paged set is one region under the
    optimal mapper even with nothing to graft (the reference's scatter
    boundary); the greedy mapper leaves it alone."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.plan.planner import plan_from_sinks

    c = Client(Configuration(root_dir=str(tmp_path),
                             page_size_bytes=64 << 10), device="cpu")
    c.create_database("d")
    c.create_set("d", "lineitem", type_name="table", storage="paged")
    c.send_table("d", "lineitem", sb.scaleout_table(3000))
    spec = S.analyze_sinks([sb.scaleout_q01_sink("d")], _is_sharded)
    sink = S.partial_sink(spec)
    plan = plan_from_sinks([sink])
    scans = pex.scan_values(c, plan)
    before = obs.REGISTRY.counter("fusion.distributed_regions").value
    rmap = fusion.map_regions(plan, scans, c.store.config, "j",
                              traceable=pex._is_traceable)
    assert [(r.kind, r.anchor) for r in rmap.regions] == \
        [("graft", sink.inputs[0].node_id)]
    assert obs.REGISTRY.counter("fusion.distributed_regions").value \
        == before + 1
    greedy = Configuration(root_dir=str(tmp_path / "g"),
                           fusion_mapper="greedy")
    assert fusion.map_regions(plan, scans, greedy, "j",
                              traceable=pex._is_traceable).regions == []
    state = next(iter(c.execute_computations(
        sink, job_name="partial", materialize=False).values()))
    assert isinstance(state, tuple) and len(state) == 3
