"""The port's ``learning/`` against the reference's: the history rows, the
rule advisor's choices, the numpy actor-critic and the DRL advisor (the
same seed gives the same weights, choices and updates, bit for bit), the
TPC-H trace schemes and their training, and the live loop through the
port's ``Client`` on the CPU — counterparts of ``tests/test_rl.py``,
``tests/test_trace.py`` and ``tests/test_lachesis_live.py``.

Live A/B tests keep the reference tests' separations (a 1024-block
against a 128-block at width 300 pads 3.4× per dimension), so a choice
by measured time is never a close race."""

import numpy as np
import pytest

from netsdb_tpu.learning import advisor as ref_advisor
from netsdb_tpu.learning import history as ref_history
from netsdb_tpu.learning import rl as ref_rl
from netsdb_tpu.learning import trace as ref_trace
from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.learning import advisor, history, rl, trace
from netsdb_tpu_torch.learning.advisor import (PlacementAdvisor,
                                               PlacementCandidate)
from netsdb_tpu_torch.learning.history import HistoryDB
from netsdb_tpu_torch.parallel.mesh import virtual_devices

TIMES = {"mesh8x1": 3.0, "mesh4x2": 1.0, "mesh2x4": 2.0}


def _cands(mod):
    return [
        mod.PlacementCandidate("mesh8x1", (8, 1), {"input": ("data", None)}),
        mod.PlacementCandidate("mesh4x2", (4, 2),
                               {"input": ("data", "model")}),
        mod.PlacementCandidate("mesh2x4", (2, 4),
                               {"input": ("data", "model")}),
    ]


def _client(tmp_path, name="c"):
    return Client(Configuration(root_dir=str(tmp_path / name)),
                  device="cpu")


# --- the numpy actor-critic, bit for bit -----------------------------------

def test_state_layout_equals_the_reference():
    args = ([[1, 2], [3, 4, 5, 6, 7]], [9])
    s = rl.build_state(*args)
    assert s.shape == (rl.state_dim(2),)
    assert list(s[:rl.PER_CANDIDATE]) == [1, 2, 0, 0]
    assert list(s[rl.PER_CANDIDATE:2 * rl.PER_CANDIDATE]) == [3, 4, 5, 6]
    assert s[2 * rl.PER_CANDIDATE] == 9 and s[-1] == 0
    assert np.array_equal(s, ref_rl.build_state(*args))
    assert (rl.PER_CANDIDATE, rl.GLOBAL) == (ref_rl.PER_CANDIDATE,
                                             ref_rl.GLOBAL)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_actor_critic_updates_bit_for_bit(seed):
    """The same seeded act/learn sequence gives the same actions and the
    same weights, bit for bit."""
    nets = [mod.ActorCritic(state_dim=5, num_actions=3, seed=seed)
            for mod in (rl, ref_rl)]
    assert np.array_equal(nets[0].w_pi, nets[1].w_pi)
    states = np.random.default_rng(seed + 100).standard_normal((60, 5))
    for st in states:
        acts = [n.act(st) for n in nets]
        assert acts[0] == acts[1]
        for n in nets:
            n.learn(st, acts[0], float(st[0] - 0.5 * acts[0]))
    for attr in ("w_pi", "b_pi", "w_v"):
        assert np.array_equal(getattr(nets[0], attr),
                              getattr(nets[1], attr)), attr
    assert nets[0].b_v == nets[1].b_v
    for st in states[:5]:
        assert nets[0].act(st, explore=False) == nets[1].act(st,
                                                             explore=False)


def test_actor_critic_learns_bandit():
    net = rl.ActorCritic(state_dim=3, num_actions=3, seed=1)
    state = np.ones(3)
    rewards = [0.1, 1.0, 0.3]  # action 1 always best
    for _ in range(300):
        a = net.act(state)
        net.learn(state, a, rewards[a])
    assert net.act(state, explore=False) == 1
    assert net.policy(state)[1] > 0.8


def test_actor_critic_contextual():
    net = rl.ActorCritic(state_dim=2, num_actions=2, seed=2,
                         actor_lr=0.2, critic_lr=0.2)
    s0, s1 = np.array([1.0, 0.0]), np.array([0.0, 1.0])
    for _ in range(400):
        for s, best in ((s0, 0), (s1, 1)):
            a = net.act(s)
            net.learn(s, a, 1.0 if a == best else 0.0)
    assert net.act(s0, explore=False) == 0
    assert net.act(s1, explore=False) == 1


def test_drl_advisor_equals_the_reference():
    """Deterministic measured times: the same choices, the same history
    rows and the same weights as the reference's advisor."""
    port = rl.DRLPlacementAdvisor(_cands(advisor), db=HistoryDB(), seed=0)
    ref = ref_rl.DRLPlacementAdvisor(_cands(ref_advisor),
                                     db=ref_history.HistoryDB(), seed=0)
    chosen = {}
    for name, adv in (("port", port), ("ref", ref)):
        seen = []

        def run(c, seen=seen):
            seen.append(c.label)
            return TIMES[c.label]

        best = adv.measure_and_choose("jobA", run, rounds=30)
        chosen[name] = (seen, best.label,
                        [(r["config"], r["elapsed_s"])
                         for r in adv.db.runs("jobA")])
    assert chosen["port"] == chosen["ref"]
    assert chosen["port"][1] == "mesh4x2"
    assert len(chosen["port"][2]) == 30
    for attr in ("w_pi", "b_pi", "w_v"):
        assert np.array_equal(getattr(port.net, attr),
                              getattr(ref.net, attr))


def test_drl_advisor_picks_fastest():
    adv = rl.DRLPlacementAdvisor(_cands(advisor), db=HistoryDB(), seed=0)
    best = adv.measure_and_choose(
        "jobA", lambda c: TIMES[c.label] * (1 + 0.02 * np.random.rand()),
        rounds=30)
    assert best.label == "mesh4x2"
    assert len(adv.db.runs("jobA")) == 30


def test_drl_advisor_requires_candidates():
    with pytest.raises(ValueError):
        rl.DRLPlacementAdvisor([], db=HistoryDB())
    with pytest.raises(ValueError):
        PlacementAdvisor([], db=HistoryDB())


# --- history and the rule advisor --------------------------------------------

def test_history_rows_and_rule_choices_equal_the_reference():
    dbs = {"port": HistoryDB(), "ref": ref_history.HistoryDB()}
    advs = {"port": PlacementAdvisor(_cands(advisor), dbs["port"]),
            "ref": ref_advisor.PlacementAdvisor(_cands(ref_advisor),
                                                dbs["ref"])}
    got = {}
    for name, adv in advs.items():
        best = adv.measure_and_choose("j", lambda c: TIMES[c.label])
        got[name] = (best.label,
                     [(r["plan_key"], r["config"], r["elapsed_s"])
                      for r in dbs[name].runs("j")],
                     dbs[name].mean_elapsed("j", "mesh2x4"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == "mesh4x2"
    assert dbs["port"].mean_elapsed("j", "nope") is None


def test_candidate_arms_equal_the_reference():
    for fn in ("fusion_candidates", "mapper_candidates",
               "rebalance_candidates"):
        port = [(c.label, c.mesh_shape, c.specs)
                for c in getattr(advisor, fn)()]
        ref = [(c.label, c.mesh_shape, c.specs)
               for c in getattr(ref_advisor, fn)()]
        assert port == ref, fn


def test_executor_records_every_job_in_the_history(tmp_path):
    from netsdb_tpu_torch.plan.computations import Filter, ScanSet, WriteSet

    db = HistoryDB()
    history.set_history_db(db)
    try:
        c = _client(tmp_path)
        c.create_database("d")
        c.create_set("d", "src", type_name="object")
        c.send_data("d", "src", [1, 2, 3, 4])
        c.execute_computations(WriteSet(Filter(ScanSet("d", "src"),
                                               lambda v: v > 1, label="gt1"),
                                        "d", "out"), job_name="hist-job")
        runs = db.runs("hist-job")
        assert len(runs) == 1 and runs[0]["elapsed_s"] > 0
        assert runs[0]["config"] == "" and runs[0]["plan_key"]
    finally:
        history.set_history_db(None)


def test_history_keeps_the_newest_rows_within_its_bound():
    """A bounded database keeps its newest ``max_rows`` runs across job
    names; the process-wide in-memory default is bounded, so a daemon
    that serves requests for ever holds a bounded history."""
    db = HistoryDB(max_rows=5)
    for i in range(12):
        db.record("a" if i % 3 else "b", "k", float(i))
    assert db.count() == 5
    assert [r["elapsed_s"] for r in db.runs("a")] == [7.0, 8.0, 10.0, 11.0]
    assert [r["elapsed_s"] for r in db.runs("b")] == [9.0]
    assert db.mean_elapsed("a", "") == 9.0
    unbounded = HistoryDB()
    for i in range(12):
        unbounded.record("a", "k", float(i))
    assert unbounded.count() == 12
    with pytest.raises(ValueError):
        HistoryDB(max_rows=0)

    history.set_history_db(None)
    try:
        default = history.get_history_db()
        assert default.max_rows == history.DEFAULT_MAX_ROWS
        assert history.get_history_db() is default
    finally:
        history.set_history_db(None)


# --- the TPC-H trace generation and training ------------------------------

@pytest.fixture
def trace_db():
    db = trace.TraceDB()
    yield db
    db.close()


def test_prepare_training_enumerates_the_reference_schemes(trace_db):
    schemes = trace.prepare_training(trace_db, data_scale=1, num_nodes=2)
    ref_db = ref_trace.TraceDB()
    ref = ref_trace.prepare_training(ref_db, data_scale=1, num_nodes=2)
    assert [(s.scheme_id, s.label) for s in schemes] == \
        [(s.scheme_id, s.label) for s in ref]
    n_variants = sum(len(v) - 1 for v in trace.CANDIDATE_LAMBDAS.values())
    assert len(schemes) == 1 + n_variants
    loaded = trace_db.schemes()
    assert [s.scheme_id for s in loaded] == [s.scheme_id for s in schemes]
    for table, cols in trace.CANDIDATE_LAMBDAS.items():
        assert loaded[0].column_for(table) == cols[0]
    ref_db.close()


def test_gen_trace_records_runs(tmp_path, trace_db):
    c = _client(tmp_path)
    schemes = trace.prepare_training(trace_db)[:2]
    trace.gen_trace(c, trace_db, schemes=schemes, queries=("q01", "q06"),
                    scale=1, n_shards=2)
    runs = trace_db.runs()
    assert len(runs) == 2 * 2
    assert all(r["elapsed_s"] > 0 for r in runs)
    total = sum(len(list(c.get_set_iterator("tpch", f"lineitem_shard{i}")))
                for i in range(2))
    assert total == len(list(c.get_set_iterator("tpch", "lineitem")))


def test_trace_times_depend_on_scheme(tmp_path, trace_db):
    c = _client(tmp_path)
    schemes = trace.prepare_training(trace_db)
    mismatch = next(s for s in schemes
                    if s.column_for("lineitem") == "l_partkey")
    trace.gen_trace(c, trace_db, schemes=[schemes[0], mismatch],
                    queries=("q04",), scale=1, n_shards=2)
    shards = [f"lineitem_reshuffle_shard{i}" for i in range(2)]
    n = sum(len(list(c.get_set_iterator("tpch", s))) for s in shards)
    assert n == len(list(c.get_set_iterator("tpch", "lineitem")))


def test_train_prefers_faster_scheme_as_the_reference(trace_db):
    ref_db = ref_trace.TraceDB()
    got = []
    for mod, db in ((trace, trace_db), (ref_trace, ref_db)):
        schemes = mod.prepare_training(db)[:3]
        rng = np.random.default_rng(0)
        for _ in range(6):
            db.record_run(0, "q03", 1.0 + rng.uniform(0, 0.05))
            db.record_run(1, "q03", 0.1 + rng.uniform(0, 0.01))
            db.record_run(2, "q03", 1.5 + rng.uniform(0, 0.05))
        got.append(mod.train(db, "q03", schemes=schemes,
                             epochs=6).scheme_id)
    assert got == [1, 1]
    ref_db.close()


# --- the live loop through the client ----------------------------------------

def _advisor():
    return PlacementAdvisor(
        [PlacementCandidate("b256", (1,), {"block": (256, 256)}),
         PlacementCandidate("b64", (1,), {"block": (64, 64)})],
        HistoryDB())


def test_create_set_consults_advisor(tmp_path):
    client = _client(tmp_path)
    adv = _advisor()
    client.set_placement_advisor(adv, key="job1")
    client.create_database("d")
    client.create_set("d", "weights")
    meta = client.catalog.get_set("d", "weights")["meta"]
    assert meta["placement"] == "b256"
    assert tuple(meta["block_shape"]) == (256, 256)
    decs = adv.db.runs("job1:decisions")
    assert len(decs) == 1 and decs[0]["config"] == "b256"


def test_send_matrix_uses_placed_block(tmp_path):
    client = _client(tmp_path)
    client.set_placement_advisor(_advisor(), key="j")
    client.create_database("d")
    client.create_set("d", "m")
    t = client.send_matrix("d", "m", np.ones((100, 100), np.float32))
    assert t.meta.block_shape == (256, 256)


def test_execute_runs_under_applied_arm_only(tmp_path):
    from netsdb_tpu_torch.plan.computations import Filter, ScanSet, WriteSet

    client = _client(tmp_path)
    adv = _advisor()
    history.set_history_db(adv.db)
    try:
        client.set_placement_advisor(adv, key="q")
        client.create_database("d")
        client.create_set("d", "src", type_name="object")
        client.send_data("d", "src", [1, 2, 3, 4])
        sink = WriteSet(Filter(ScanSet("d", "src"), lambda v: v > 1,
                               label="gt1"), "d", "out")
        client.execute_computations(sink, job_name="q")
        runs = adv.db.runs("q")
        assert runs and runs[-1]["config"] == ""
        client.create_set("d", "weights")  # tensor set: the arm applies
        client.execute_computations(sink, job_name="q")
        assert adv.db.runs("q")[-1]["config"] == "b256"
        client.set_placement_advisor(None)
        client._advisor_arm = None
        client.execute_computations(sink, job_name="q2")
        assert adv.db.runs("q2")[-1]["config"] == ""
    finally:
        history.set_history_db(None)


def test_create_set_with_placement_writes_the_history_row(tmp_path):
    from netsdb_tpu_torch.parallel.placement import Placement

    db = HistoryDB()
    history.set_history_db(db)
    try:
        with virtual_devices(2, "cpu"):
            client = _client(tmp_path)
            client.create_database("d")
            pl = Placement.data_parallel(ndim=1)
            client.create_set("d", "t", type_name="table", placement=pl)
        rows = db.runs("d.t:placement")
        assert [r["config"] for r in rows] == [pl.label()]
    finally:
        history.set_history_db(None)


def test_drl_advisor_pluggable_into_client(tmp_path):
    adv = rl.DRLPlacementAdvisor(
        [PlacementCandidate("b256", (1,), {"block": (256, 256)}),
         PlacementCandidate("b64", (1,), {"block": (64, 64)})],
        HistoryDB(), seed=0)
    client = _client(tmp_path)
    client.set_placement_advisor(adv, key="drl-job")
    client.create_database("d")
    client.create_set("d", "weights")
    meta = client.catalog.get_set("d", "weights")["meta"]
    assert meta["placement"] in ("b256", "b64")
    assert adv.db.runs("drl-job:decisions")


def test_ab_loop_learns_the_faster_block():
    from netsdb_tpu_torch.learning.ab_bench import bench_placement_ab

    res = bench_placement_ab(width=300, batch=256, rounds=3, device="cpu")
    assert set(res["mean_s"]) == {"block1024", "block128"}
    assert res["decisions_recorded"] > 0
    assert res["winner"] == "block128"


def test_drl_live_loop_converges():
    from netsdb_tpu_torch.learning.ab_bench import bench_placement_ab

    res = bench_placement_ab(width=300, batch=256, labels=8, rounds=8,
                             advisor_kind="drl", seed=1, device="cpu")
    assert res["advisor"] == "drl"
    assert res["converged"], res
    assert len(res["rounds"]) == 8
    assert res["decisions_recorded"] >= 8
    assert all(v is not None for v in res["mean_s"].values())


def test_distribution_ab_rule_applies_placement_arms():
    from netsdb_tpu_torch.learning.ab_bench import bench_distribution_ab

    with virtual_devices(8, "cpu"):
        out = bench_distribution_ab(scale=8, rounds=3, advisor_kind="rule",
                                    device="cpu")
    for arm_label, pl_label in out["applied"]:
        want = "P(None)" if arm_label == "dim_replicated" else "P(data)"
        assert want in pl_label, (arm_label, pl_label)
    assert all(v is not None and v > 0 for v in out["mean_s"].values())
    assert out["winner"] in out["mean_s"]
    assert out["decisions_recorded"] >= 3


def test_distribution_and_batch_ab_drl_apply_their_arms():
    """The DRL arms through create_set: every round ran under the arm it
    applied and was recorded against it. (Which arm wins is host noise
    here: the virtual positions share one CPU.)"""
    from netsdb_tpu_torch.learning.ab_bench import (
        bench_batch_distribution_ab, bench_distribution_ab)

    with virtual_devices(8, "cpu"):
        out = bench_distribution_ab(scale=8, rounds=4, advisor_kind="drl",
                                    device="cpu")
        batch = bench_batch_distribution_ab(width=64, batch=256, rounds=4,
                                            device="cpu")
    assert len(out["applied"]) == 4 and "converged" in out
    assert all(v is not None for v in out["mean_s"].values())
    assert set(batch["mean_s"]) == {"x_replicated", "x_sharded"}
    assert all(v is not None for v in batch["mean_s"].values())
    assert batch["decisions_recorded"] == len(batch["rounds"]) >= 4


def test_fusion_and_mapper_arms():
    from netsdb_tpu_torch.learning.ab_bench import (bench_fusion_ab,
                                                    bench_mapper_ab)

    fus = bench_fusion_ab(rows=4096, rounds=2, reps=1, device="cpu")
    assert set(fus["mean_s"]) == {"fusion_on", "fusion_off"}
    assert all(v is not None for v in fus["mean_s"].values())
    for shape in ("mixed", "spine"):
        m = bench_mapper_ab(rows=4096, rounds=2, reps=1, shape=shape,
                            device="cpu")
        assert m["shape"] == shape
        assert set(m["mean_s"]) == {"mapper_optimal", "mapper_greedy"}
        assert m["winner"] in m["mean_s"]


def test_rebalance_arms_measure_routed_throughput():
    from netsdb_tpu_torch.learning.ab_bench import bench_rebalance_ab

    out = bench_rebalance_ab(rows=2000, rounds=1, queries=4, device="cpu")
    assert set(out["mean_s"]) == {"rebalance_on", "rebalance_frozen"}
    assert out["winner"] in out["mean_s"]
    # the on arm ran the advisor protocol on the live pool every time
    assert out["advise_decisions"] and all(
        d[0] == "rebalance_on" for d in out["advise_decisions"])
