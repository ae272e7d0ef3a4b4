"""Live Lachesis A/B — the port's ``netsdb_tpu/learning/ab_bench.py``: the
placement advisor closing the loop end-to-end.

The reference's self-learning story is "first run slow, later runs
fast": the optimizer tries placements, records runtimes, then serves
the best (``documentation.md:5-10``). This module reproduces that as a
LIVE run through the client: each round builds a fresh client with the
advisor installed, ``create_set`` consults the advisor for the block
shape (the page-size analogue), the FF job runs under the chosen arm,
and the measured wall time lands in the history DB — so the advisor's
next choice is driven by real rewards, not test fixtures.

The candidate arms differ in padding waste: at a deliberately
non-block-aligned model width (e.g. 1100), a 1024-block pads every
dimension to 2048 (~3.5x the FLOPs and bytes) while a 128-block pads to
1152 (~5% waste) — a real, measurable placement consequence on one
card, exactly the kind of knob the reference's optimizer tunes.

Every bench runs on the card unless given ``device="cpu"``. The
reference points every round at one stable XLA compile cache so that
explore rounds measure placements, not compiles; here each round warms
its arm once before it is timed, and the kernel libraries are built
once per process, so no cache directory is needed.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.learning.advisor import PlacementAdvisor, PlacementCandidate
from netsdb_tpu_torch.learning.history import HistoryDB
from netsdb_tpu_torch.models.ff import FFModel

def _sync(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


DEFAULT_CANDIDATES = (
    PlacementCandidate("block1024", (1,), {"block": (1024, 1024)}),
    PlacementCandidate("block128", (1,), {"block": (128, 128)}),
)


def bench_placement_ab(width: int = 1100, batch: int = 4096,
                       labels: int = 16, rounds: int = 4,
                       history_path: str = ":memory:",
                       seed: int = 0,
                       advisor_kind: str = "rule",
                       device=None) -> Dict[str, object]:
    """Run ``rounds`` live FF-inference jobs under the advisor.

    ``advisor_kind="rule"``: explore each arm once, then exploit the
    measured winner (the frequency/rule-based optimizer).
    ``advisor_kind="drl"``: the actor-critic
    :class:`~netsdb_tpu_torch.learning.rl.DRLPlacementAdvisor` makes the live
    choices and learns from the measured on-chip rewards — the
    reference's RLClient wired into live scheduling
    (``src/selfLearning/headers/RLClient.h:18-38``), not just replay
    training. Both speak the same choose/record surface, so the live
    loop is identical; the returned dict adds ``converged`` (greedy
    post-training choice == measured-mean winner) for the DRL arm.

    Returns per-arm mean wall seconds, the decisions audit trail, and
    the exploit-phase speedup of learned-vs-worst."""
    hdb = HistoryDB(history_path)
    if advisor_kind == "drl":
        from netsdb_tpu_torch.learning.rl import DRLPlacementAdvisor

        advisor = DRLPlacementAdvisor(list(DEFAULT_CANDIDATES), hdb,
                                      seed=seed)
    elif advisor_kind == "rule":
        advisor = PlacementAdvisor(list(DEFAULT_CANDIDATES), hdb)
    else:
        raise ValueError(f"advisor_kind must be 'rule' or 'drl', "
                         f"got {advisor_kind!r}")
    job = "ab-inference"
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((width, width)).astype(np.float32) * 0.02
    b1 = rng.standard_normal((width,)).astype(np.float32) * 0.01
    wo = rng.standard_normal((labels, width)).astype(np.float32) * 0.02
    bo = rng.standard_normal((labels,)).astype(np.float32) * 0.01
    x = rng.standard_normal((batch, width)).astype(np.float32)

    def one_round(advisor_on: bool = True, force_block=None):
        root = tempfile.mkdtemp(prefix="ab_bench_")
        try:
            client = Client(Configuration(root_dir=root), device=device)
            if advisor_on:
                client.set_placement_advisor(advisor, key=job)
            model = FFModel(db="ab")
            model.setup(client)  # create_set consults the advisor HERE
            if force_block is not None:
                model.block = tuple(force_block)
            cand = next(c for c in advisor.candidates
                        if tuple(c.specs["block"]) == model.block)
            model.load_weights(client, w1, b1, wo, bo)
            model.load_inputs(client, x)
            model.inference(client)  # warm this arm's program
            # min-of-3: the noise-robust location estimate for a
            # milliseconds-scale job on a possibly loaded machine (a
            # single inflated wall on the explore round would teach
            # the advisor the wrong winner)
            elapsed = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                out = model.inference(client)
                out.to_dense().cpu()  # sync
                elapsed = min(elapsed, time.perf_counter() - t0)
            return cand, elapsed
        finally:
            shutil.rmtree(root, ignore_errors=True)

    for cand in advisor.candidates:  # warm both compiles, unrecorded
        one_round(advisor_on=False, force_block=cand.specs["block"])
    chosen = []
    for _ in range(rounds):
        cand, elapsed = one_round()
        advisor.record(job, cand, elapsed)
        chosen.append((cand.label, round(elapsed, 4)))

    means = {c.label: hdb.mean_elapsed(job, c.label)
             for c in advisor.candidates}
    if advisor_kind == "drl":
        winner = advisor.choose(job, explore=False).label
    else:
        winner = advisor.choose(job).label
    decisions = hdb.runs(f"{job}:decisions")
    worst = max(v for v in means.values() if v is not None)
    best = min(v for v in means.values() if v is not None)
    out = {"advisor": advisor_kind, "rounds": chosen, "mean_s": means,
           "winner": winner, "decisions_recorded": len(decisions),
           "learned_speedup": round(worst / best, 2) if best else None}
    if advisor_kind == "drl":
        by_mean = min((v, k) for k, v in means.items()
                      if v is not None)[1]
        out["converged"] = winner == by_mean
    return out


def _converged(winner: str, means: Dict[str, Optional[float]],
               noise_frac: float = 0.25) -> bool:
    """DRL convergence check under the measurement-noise discipline
    (utils.timing): the greedy choice must match the
    measured-mean winner UNLESS the arm means are within ``noise_frac``
    of each other — statistically indistinguishable arms make either
    choice correct (both-below-noise = undecidable, not a failure)."""
    vals = {k: v for k, v in means.items() if v is not None}
    if winner not in vals:
        return False  # greedy picked an arm that was never measured
    by_mean = min(vals, key=vals.get)
    if winner == by_mean:
        return True
    lo = vals[by_mean]
    return vals[winner] <= lo * (1.0 + noise_frac)


# --------------------------------------------- distribution A/B (arms
# carrying Placements — Lachesis choosing SHARDING, the interesting
# decision variable on a mesh)
def distribution_candidates():
    """Replicated vs row-sharded dimension table over all devices —
    the broadcast-join-vs-repartition decision as advisor arms
    (``arm.specs["placement"]`` consumed by ``Client.create_set``)."""
    from netsdb_tpu_torch.parallel.placement import Placement

    return (
        PlacementCandidate("dim_replicated", (1,),
                           {"placement": Placement((("data", 0),),
                                                   (None,))}),
        PlacementCandidate("dim_rowsharded", (1,),
                           {"placement": Placement((("data", 0),),
                                                   ("data",))}),
    )


def batch_candidates():
    """Replicated vs batch-sharded ACTIVATIONS for FF inference — the
    data-parallelism decision as advisor arms, keyed by set name so
    only the ``inputs`` set takes the arm's placement. This pair is
    DISCRIMINATING by construction: a replicated batch makes every
    mesh device compute the full inference (N× the FLOPs under SPMD —
    on the shared-core virtual CPU mesh that is N× the wall clock, on
    real chips N× the energy/HBM for no throughput), while the sharded
    arm splits the batch. The gap is workload-sized, far outside the
    measurement-noise band, so convergence is asserted STRICTLY."""
    from netsdb_tpu_torch.parallel.placement import Placement

    return (
        PlacementCandidate("x_replicated", (1,),
                           {"inputs": Placement((("data", 0),),
                                                (None, None))}),
        PlacementCandidate("x_sharded", (1,),
                           {"inputs": Placement((("data", 0),),
                                                ("data", None))}),
    )


def bench_batch_distribution_ab(width: int = 768, batch: int = 4096,
                                labels: int = 16, rounds: int = 4,
                                reps: int = 3,
                                history_path: str = ":memory:",
                                seed: int = 0,
                                advisor_kind: str = "drl",
                                device=None) -> Dict[str, object]:
    """Live A/B where the advisor decides whether the FF inference
    batch is replicated or data-sharded over the mesh — the
    DISCRIMINATING distribution decision (see
    :func:`batch_candidates`): the loser does mesh-size× the compute,
    so the greedy choice must match the measured winner exactly
    (``converged_strict``; the 25%-band fallback of ``_converged`` is
    reserved for genuinely indistinguishable arms, documented there).

    Weights are replicated explicitly; only ``inputs`` consults the
    advisor. Each measured round runs ``reps`` inferences (amortizing
    per-job dispatch overhead) after a warm one. The mesh is the visible
    positions of ``device`` (``parallel.mesh.virtual_devices`` gives a
    CPU run several)."""
    from netsdb_tpu_torch.parallel.placement import Placement

    hdb = HistoryDB(history_path)
    cands = list(batch_candidates())
    if advisor_kind == "drl":
        from netsdb_tpu_torch.learning.rl import DRLPlacementAdvisor

        advisor = DRLPlacementAdvisor(cands, hdb, seed=seed)
    else:
        advisor = PlacementAdvisor(cands, hdb)
    job = "ab-batch-dist"
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((width, width)).astype(np.float32) * 0.02
    b1 = rng.standard_normal((width,)).astype(np.float32) * 0.01
    wo = rng.standard_normal((labels, width)).astype(np.float32) * 0.02
    bo = rng.standard_normal((labels,)).astype(np.float32) * 0.01
    x = rng.standard_normal((batch, width)).astype(np.float32)
    wpl = {n: Placement((("data", 0),), (None, None))
           for n in ("w1", "b1", "wo", "bo")}

    def one_round(placement_override=None):
        root = tempfile.mkdtemp(prefix="ab_batch_")
        try:
            client = Client(Configuration(root_dir=root), device=device)
            if placement_override is None:
                client.set_placement_advisor(advisor, key=job)
            model = FFModel(db="ab", block=(256, 256))
            placements = dict(wpl)
            if placement_override is not None:
                placements["inputs"] = placement_override
            model.setup(client, placements=placements)
            arm = getattr(client, "_advisor_arm", None)
            model.load_weights(client, w1, b1, wo, bo)
            model.load_inputs(client, x)
            model.inference(client)  # warm this arm's program
            _sync(client.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                model.inference(client)
            _sync(client.device)
            return arm, (time.perf_counter() - t0) / reps
        finally:
            shutil.rmtree(root, ignore_errors=True)

    for cand in cands:  # warm both compiled programs, unrecorded
        one_round(placement_override=cand.specs["inputs"])
    chosen = []
    r = 0
    while r < rounds or (r < 2 * rounds and any(
            hdb.mean_elapsed(job, c.label) is None for c in cands)):
        # extra rounds until every arm has a measurement: a stochastic
        # policy that happened to sample one arm only would make the
        # convergence check vacuous
        arm, elapsed = one_round()
        assert arm is not None, "advisor arm was not applied"
        advisor.record(job, arm, elapsed)
        chosen.append((arm.label, round(elapsed, 4)))
        r += 1

    means = {c.label: hdb.mean_elapsed(job, c.label)
             for c in advisor.candidates}
    winner = (advisor.choose(job, explore=False).label
              if advisor_kind == "drl" else advisor.choose(job).label)
    vals = {k: v for k, v in means.items() if v is not None}
    by_mean = min(vals, key=vals.get) if vals else None
    worst = max(vals.values()) if vals else None
    best = min(vals.values()) if vals else None
    return {"advisor": advisor_kind, "rounds": chosen, "mean_s": means,
            "winner": winner, "by_mean": by_mean,
            "gap": round(worst / best, 2) if best else None,
            "converged_strict": winner == by_mean,
            "decisions_recorded": len(hdb.runs(f"{job}:decisions"))}


def bench_fusion_ab(rows: int = 120_000, spine: int = 6,
                    rounds: int = 4, reps: int = 3,
                    history_path: str = ":memory:",
                    seed: int = 0, device=None) -> Dict[str, object]:
    """Live A/B where the advisor decides ``plan_fusion`` for a mixed
    paged/resident job — the fusion decision as a bandit arm
    (:func:`~netsdb_tpu_torch.learning.advisor.fusion_candidates`), driven
    through the same measure-record-choose loop as every placement
    arm.  Each round executes a q06-style paged fold joined against a
    ``spine``-node resident Apply chain under the arm's config, with
    the measured wall recorded against the arm — "first run explores,
    later runs serve the measured winner" (the reference's
    self-learning loop, applied to plan compilation)."""
    from netsdb_tpu_torch.learning.advisor import fusion_candidates
    from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.relational.table import ColumnTable

    hdb = HistoryDB(history_path)
    cands = list(fusion_candidates())
    advisor = PlacementAdvisor(cands, hdb)
    job = "ab-fusion"
    rng = np.random.default_rng(seed)
    li = {
        "l_shipdate": rng.integers(19940101, 19950101, rows,
                                   dtype=np.int32),
        "l_discount": np.full(rows, 0.06, np.float32),
        "l_quantity": np.full(rows, 10.0, np.float32),
        "l_extendedprice": rng.uniform(1000, 2000, rows
                                       ).astype(np.float32),
    }
    dim = {"x": rng.standard_normal(4096).astype(np.float32)}

    def build_sink():
        s = ScanSet("ab", "dim")
        node = s
        for i in range(spine):
            node = Apply(node, lambda t, _i=i: ColumnTable(
                {"x": t["x"] * 1.000001 + _i * 0.0}, t.dicts, t.valid),
                label=f"spine{i}")
        z = Apply(node, lambda t: torch.sum(t["x"]) * 0.0, label="zsum")
        q06 = rdag.q06_sink("ab")
        j = Join(q06.inputs[0], z, fn=lambda rev, v: ColumnTable(
            {"revenue": rev["revenue"] + v}, rev.dicts, rev.valid),
            label="combine")
        return WriteSet(j, "ab", "fusion_out")

    def one_round(arm):
        root = tempfile.mkdtemp(prefix="ab_fusion_")
        try:
            cfg = Configuration(root_dir=root,
                                fusion_cost_source="static")
            cfg.plan_fusion = bool(arm.specs["plan_fusion"])
            client = Client(cfg, device=device)
            client.create_database("ab")
            client.create_set("ab", "lineitem", type_name="table",
                              storage="paged")
            client.send_table("ab", "lineitem", ColumnTable.from_columns(
                li, device="cpu"))
            client.create_set("ab", "dim", type_name="table")
            client.send_table("ab", "dim", ColumnTable.from_columns(
                dim, device=client.device))
            client.execute_computations(build_sink(), job_name=job)  # warm
            _sync(client.device)
            elapsed = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                client.execute_computations(build_sink(), job_name=job)
                _sync(client.device)
                elapsed = min(elapsed, time.perf_counter() - t0)
            return elapsed
        finally:
            shutil.rmtree(root, ignore_errors=True)

    for cand in cands:  # warm both arms' programs, unrecorded
        one_round(cand)
    chosen = []
    for _ in range(rounds):
        cand = advisor.choose(job)
        elapsed = one_round(cand)
        advisor.record(job, cand, elapsed)
        chosen.append((cand.label, round(elapsed, 4)))
    means = {c.label: hdb.mean_elapsed(job, c.label) for c in cands}
    winner = advisor.choose(job).label
    vals = {k: v for k, v in means.items() if v is not None}
    worst = max(vals.values()) if vals else None
    best = min(vals.values()) if vals else None
    return {"rounds": chosen, "mean_s": means, "winner": winner,
            "learned_speedup": round(worst / best, 2) if best else None}


def bench_mapper_ab(rows: int = 120_000, spine: int = 6,
                    rounds: int = 4, reps: int = 3,
                    shape: str = "mixed",
                    history_path: str = ":memory:",
                    seed: int = 0, device=None) -> Dict[str, object]:
    """Live A/B where the advisor decides the fusion MAPPER (optimal
    DP vs greedy whole-run) for one plan SHAPE
    (:func:`~netsdb_tpu_torch.learning.advisor.mapper_candidates`).  The
    history key carries the shape (``ab-mapper:<shape>``), so the
    bandit learns a per-shape winner — ``shape="spine"`` runs the
    resident Apply chain alone (where the DP's segmentation can
    differ), ``shape="mixed"`` the same mixed paged/resident DAG
    :func:`bench_fusion_ab` measures."""
    from netsdb_tpu_torch.learning.advisor import mapper_candidates
    from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.relational.table import ColumnTable

    hdb = HistoryDB(history_path)
    cands = list(mapper_candidates())
    advisor = PlacementAdvisor(cands, hdb)
    job = f"ab-mapper:{shape}"
    rng = np.random.default_rng(seed)
    li = {
        "l_shipdate": rng.integers(19940101, 19950101, rows,
                                   dtype=np.int32),
        "l_discount": np.full(rows, 0.06, np.float32),
        "l_quantity": np.full(rows, 10.0, np.float32),
        "l_extendedprice": rng.uniform(1000, 2000, rows
                                       ).astype(np.float32),
    }
    dim = {"x": rng.standard_normal(4096).astype(np.float32)}

    def build_sink():
        s = ScanSet("ab", "dim")
        node = s
        for i in range(spine):
            node = Apply(node, lambda t, _i=i: ColumnTable(
                {"x": t["x"] * 1.000001 + _i * 0.0}, t.dicts, t.valid),
                label=f"spine{i}")
        if shape == "spine":
            return WriteSet(node, "ab", "mapper_out")
        z = Apply(node, lambda t: torch.sum(t["x"]) * 0.0, label="zsum")
        q06 = rdag.q06_sink("ab")
        j = Join(q06.inputs[0], z, fn=lambda rev, v: ColumnTable(
            {"revenue": rev["revenue"] + v}, rev.dicts, rev.valid),
            label="combine")
        return WriteSet(j, "ab", "mapper_out")

    def one_round(arm):
        root = tempfile.mkdtemp(prefix="ab_mapper_")
        try:
            cfg = Configuration(root_dir=root,
                                fusion_cost_source="static")
            cfg.fusion_mapper = str(arm.specs["fusion_mapper"])
            client = Client(cfg, device=device)
            client.create_database("ab")
            client.create_set("ab", "lineitem", type_name="table",
                              storage="paged")
            client.send_table("ab", "lineitem", ColumnTable.from_columns(
                li, device="cpu"))
            client.create_set("ab", "dim", type_name="table")
            client.send_table("ab", "dim", ColumnTable.from_columns(
                dim, device=client.device))

            def one():
                client.execute_computations(build_sink(), job_name=job)
                _sync(client.device)

            one()  # warm
            elapsed = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                one()
                elapsed = min(elapsed, time.perf_counter() - t0)
            return elapsed
        finally:
            shutil.rmtree(root, ignore_errors=True)

    for cand in cands:  # warm both arms' programs, unrecorded
        one_round(cand)
    chosen = []
    for _ in range(rounds):
        cand = advisor.choose(job)
        elapsed = one_round(cand)
        advisor.record(job, cand, elapsed)
        chosen.append((cand.label, round(elapsed, 4)))
    means = {c.label: hdb.mean_elapsed(job, c.label) for c in cands}
    winner = advisor.choose(job).label
    vals = {k: v for k, v in means.items() if v is not None}
    worst = max(vals.values()) if vals else None
    best = min(vals.values()) if vals else None
    return {"shape": shape, "rounds": chosen, "mean_s": means,
            "winner": winner,
            "learned_speedup": round(worst / best, 2) if best else None}


def bench_distribution_ab(scale: int = 16, rounds: int = 4,
                          history_path: str = ":memory:",
                          seed: int = 0,
                          advisor_kind: str = "rule",
                          device=None) -> Dict[str, object]:
    """Live A/B where the advisor decides a SET'S PLACEMENT: each round
    creates the TPC-H ``orders`` set with NO explicit placement — the
    installed advisor's arm supplies one (replicated = broadcast join,
    or row-sharded = repartitioned build) — then runs the q12 suite
    DAG distributed over the placed sets and records the measured wall
    time against the arm that was actually applied (the reference's
    RLClient driving live scheduling, ``RLClient.h:18-38``).

    Needs a multi-position mesh to have signal (on one card every
    placement degrades to the trivial mesh); the tests run it on eight
    virtual CPU positions (``parallel.mesh.virtual_devices``)."""
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.relational.queries import tables_from_rows
    from netsdb_tpu_torch.storage.store import SetIdentifier
    from netsdb_tpu_torch.workloads import tpch

    hdb = HistoryDB(history_path)
    cands = list(distribution_candidates())
    if advisor_kind == "drl":
        from netsdb_tpu_torch.learning.rl import DRLPlacementAdvisor

        advisor = DRLPlacementAdvisor(cands, hdb, seed=seed)
    elif advisor_kind == "rule":
        advisor = PlacementAdvisor(cands, hdb)
    else:
        raise ValueError(f"advisor_kind must be 'rule' or 'drl', "
                         f"got {advisor_kind!r}")
    job = "ab-distribution"
    tables = tables_from_rows(tpch.generate(scale=scale, seed=seed),
                              device="cpu")
    chosen = []
    applied_labels = []

    def one_round(placement_override=None):
        """One job under either an explicit placement (warmup) or the
        advisor's choice (measured). The fact placement is EXPLICIT
        (always row-sharded); the advisor only decides the dimension
        set. Returns (applied arm, placement label, elapsed)."""
        from netsdb_tpu_torch.parallel.placement import Placement as _P

        root = tempfile.mkdtemp(prefix="ab_dist_")
        try:
            client = Client(Configuration(root_dir=root), device=device)
            if placement_override is None:
                client.set_placement_advisor(advisor, key=job)
            client.create_database("d")
            client.create_set("d", "lineitem", type_name="table",
                              placement=_P.data_parallel(ndim=1))
            client.create_set("d", "orders", type_name="table",
                              placement=placement_override)
            arm = getattr(client, "_advisor_arm", None)
            pl = client.store.placement_of(SetIdentifier("d", "orders"))
            for n in ("lineitem", "orders"):
                client.send_table("d", n, tables[n])
            sink = rdag.suite_sink_for(client, "d", "q12")
            t0 = time.perf_counter()
            client.execute_computations(sink, job_name=job)
            _sync(client.device)
            return (arm, pl.label() if pl is not None else None,
                    time.perf_counter() - t0)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # warm every arm's compiled program once, UNRECORDED: the measured
    # rounds must compare placements, not first compiles (cold-compile
    # walls are pure noise)
    for cand in cands:
        one_round(placement_override=cand.specs["placement"])
    for _ in range(rounds):
        arm, pl_label, elapsed = one_round()
        assert arm is not None, "advisor arm was not applied"
        applied_labels.append((arm.label, pl_label))
        advisor.record(job, arm, elapsed)
        chosen.append((arm.label, round(elapsed, 4)))

    means = {c.label: hdb.mean_elapsed(job, c.label)
             for c in advisor.candidates}
    if advisor_kind == "drl":
        winner = advisor.choose(job, explore=False).label
    else:
        winner = advisor.choose(job).label
    worst = max(v for v in means.values() if v is not None)
    best = min(v for v in means.values() if v is not None)
    out = {"advisor": advisor_kind, "rounds": chosen, "mean_s": means,
           "winner": winner, "applied": applied_labels,
           "decisions_recorded": len(hdb.runs(f"{job}:decisions")),
           "learned_speedup": round(worst / best, 2) if best else None}
    if advisor_kind == "drl":
        out["converged"] = _converged(winner, means)
    return out


def bench_rebalance_ab(rows: int = 24_000, rounds: int = 2,
                       queries: int = 20,
                       history_path: str = ":memory:",
                       seed: int = 0, device=None) -> Dict[str, object]:
    """Live A/B where the advisor decides ``config.rebalance`` for a
    skewed serving pool — the self-rebalancing loop as a bandit arm
    (:func:`~netsdb_tpu_torch.learning.advisor.rebalance_candidates`).

    Each round spins a fresh 4-daemon pool, ingests an 80/20
    hot/cold pair of range-sharded tables, registers a 5th daemon
    mid-run, then serves a skewed routed-read mix and records the
    measured wall against the arm. The ``rebalance_on`` arm drives
    the FULL advisor protocol on the live pool —
    :meth:`~netsdb_tpu_torch.serve.rebalance.Rebalancer.advise` measures
    baseline routed throughput, applies the skew-planner's moves,
    re-measures, and commits (ticking ``rebalance.advisor_commits``)
    or reverts the campaign — while ``rebalance_frozen`` leaves the
    new member slot-less. Exactness is asserted every round: the
    scanned-back tables must be row-exact regardless of arm."""
    from netsdb_tpu_torch.learning.advisor import rebalance_candidates
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.serve.server import ServeController
    from netsdb_tpu_torch.workloads.serve_bench import scaleout_table

    hdb = HistoryDB(history_path)
    cands = list(rebalance_candidates())
    advisor = PlacementAdvisor(cands, hdb)
    job = "ab-rebalance"
    hot = scaleout_table(rows, seed=seed + 1)
    cold = scaleout_table(max(rows // 10, 8), seed=seed + 2)
    decisions = []

    def one_round(arm):
        root = tempfile.mkdtemp(prefix="ab_rebalance_")
        daemons = []
        client = None
        try:
            on = bool(arm.specs["rebalance"])
            workers = []
            for i in range(3):
                w = ServeController(Configuration(
                    root_dir=f"{root}/w{i}", rebalance=on), port=0,
                    device=device)
                w.start()
                daemons.append(w)
                workers.append(w)
            leader = ServeController(
                Configuration(root_dir=f"{root}/leader", rebalance=on),
                port=0, device=device,
                workers=[f"127.0.0.1:{w.port}" for w in workers])
            leader.start()
            daemons.append(leader)
            client = RemoteClient(f"127.0.0.1:{leader.port}")
            client.create_database("ab")
            client.create_set("ab", "hot", type_name="table",
                              placement="range")
            client.create_set("ab", "cold", type_name="table",
                              placement="range")
            client.send_table("ab", "hot", hot)
            client.send_table("ab", "cold", cold)
            w4 = ServeController(Configuration(
                root_dir=f"{root}/w4", rebalance=on), port=0,
                device=device)
            w4.start()
            daemons.append(w4)
            # register only — the move decision belongs to the
            # measured advisor pass below, not the registration
            leader.add_worker(f"127.0.0.1:{w4.port}", campaign=False)

            def routed_throughput() -> float:
                t0 = time.perf_counter()
                for i in range(queries):
                    name = "hot" if i % 5 else "cold"
                    t = client.get_table_streamed("ab", name)
                    want = rows if name == "hot" else cold.num_rows
                    if t.num_rows != want:
                        raise AssertionError(
                            f"{name}: {t.num_rows} != {want}")
                return queries / (time.perf_counter() - t0)

            if on:
                verdict = leader.rebalancer.advise(routed_throughput)
                decisions.append((arm.label, verdict["decision"],
                                  len(verdict.get("moves") or [])))
            t0 = time.perf_counter()
            routed_throughput()
            elapsed = time.perf_counter() - t0
            # exactness gate: the campaign (or its absence) must not
            # change a single row the clients see
            back = client.get_table_streamed("ab", "hot")
            if back.num_rows != rows:
                raise AssertionError(
                    f"hot rows drifted: {back.num_rows} != {rows}")
            return elapsed
        finally:
            if client is not None:
                client.close()
            for d in daemons:
                d.shutdown()
            shutil.rmtree(root, ignore_errors=True)

    for cand in cands:  # warm both arms' pools, unrecorded
        one_round(cand)
    chosen = []
    for _ in range(rounds):
        cand = advisor.choose(job)
        elapsed = one_round(cand)
        advisor.record(job, cand, elapsed)
        chosen.append((cand.label, round(elapsed, 4)))
    means = {c.label: hdb.mean_elapsed(job, c.label) for c in cands}
    winner = advisor.choose(job).label
    vals = {k: v for k, v in means.items() if v is not None}
    worst = max(vals.values()) if vals else None
    best = min(vals.values()) if vals else None
    return {"rounds": chosen, "mean_s": means, "winner": winner,
            "advise_decisions": decisions,
            "learned_speedup": round(worst / best, 2) if best else None}
