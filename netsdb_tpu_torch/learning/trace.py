"""TPC-H self-learning trace generation & training — the port's
``netsdb_tpu/learning/trace.py``.

Reference: ``src/tpch/source/tpchPrepareTraining.cc`` (builds
LambdaStatistics / PartitionSchemeStatistics / EnvironmentStatistics
tables from initial runs), ``tpchGenTrace.cc`` (for each partition
scheme: recreate + reload every table partitioned by that scheme's
lambda, run the query suite, append RUN_STAT rows — the traces shipped
in ``gen_trace.sql``), and ``tpchTraining1.cc`` (feed state/reward to
the RL server per scheme). README workflow: ``README.md:216-256``.

Here the three programs are functions over the same stores:

- :func:`prepare_training` — harvest candidate partition lambdas per
  table (the reference reads the LAMBDA table its SelfLearningDB filled
  during initial runs; we declare the join/group-by keys the ten queries
  actually use) and enumerate partition schemes into a :class:`TraceDB`.
- :func:`gen_trace` — per scheme: reload tables hash-dispatched by the
  scheme's lambda (``storage.dispatcher.HashPolicy`` over shard sets =
  the reference's per-node partitioned reload), run the queries, record
  RUN_STAT rows.
- :func:`train` — replay the trace through the in-process actor-critic
  (:class:`~netsdb_tpu_torch.learning.rl.DRLPlacementAdvisor`), returning the
  learned best scheme per query.
"""

from __future__ import annotations

import dataclasses
import sqlite3
import time
from typing import Dict, List, Optional, Sequence, Tuple

from netsdb_tpu_torch.learning.advisor import PlacementCandidate
from netsdb_tpu_torch.learning.history import HistoryDB
from netsdb_tpu_torch.learning.rl import DRLPlacementAdvisor
from netsdb_tpu_torch.storage.dispatcher import HashPolicy, dispatch_to_sets
from netsdb_tpu_torch.workloads import tpch


@dataclasses.dataclass(frozen=True)
class PartitionLambda:
    """A candidate hash-partition key for one table — the reference's
    ``LambdaIdentifier`` (jobName, computationName, lambdaName) resolved
    to what it actually denotes: a key column."""
    lambda_id: int
    table: str
    column: str


@dataclasses.dataclass(frozen=True)
class PartitionScheme:
    """One lambda per table — reference PartitionSchemeStatistics row
    (customerLambda, lineitemLambda, orderLambda, ...)."""
    scheme_id: int
    lambdas: Tuple[PartitionLambda, ...]

    @property
    def label(self) -> str:
        return "scheme:" + ",".join(
            f"{l.table}.{l.column}" for l in self.lambdas)

    def column_for(self, table: str) -> Optional[str]:
        for l in self.lambdas:
            if l.table == table:
                return l.column
        return None


# The partition-key candidates the ten implemented queries exercise
# (join keys and group-by keys in workloads/tpch.py; the reference's
# LAMBDA table records the same attribute-access lambdas from its runs).
CANDIDATE_LAMBDAS: Dict[str, Tuple[str, ...]] = {
    "customer": ("c_custkey", "c_nationkey"),
    "lineitem": ("l_orderkey", "l_partkey"),
    "orders": ("o_orderkey", "o_custkey"),
    "part": ("p_partkey",),
    "supplier": ("s_suppkey", "s_nationkey"),
    "partsupp": ("ps_partkey", "ps_suppkey"),
    "region": ("r_regionkey",),
    "nation": ("n_nationkey", "n_regionkey"),
}

DEFAULT_QUERIES = ("q01", "q02", "q03", "q04", "q06",
                   "q12", "q13", "q14", "q17", "q22")

# The partition key each query actually needs per table (its join/probe
# key in workloads/tpch.py). When the active scheme partitions a table
# by a different key, the engine must re-shuffle that table before the
# co-partitioned join — precisely the cost the reference's self-learning
# observes in RUN_STAT and learns to avoid (documentation.md:5-10: the
# win is reusing a placement that matches the workload's keys).
QUERY_JOIN_KEYS: Dict[str, Dict[str, str]] = {
    "q01": {},  # single-table scan+aggregate
    "q02": {"part": "p_partkey", "partsupp": "ps_partkey",
            "supplier": "s_suppkey", "nation": "n_nationkey",
            "region": "r_regionkey"},
    "q03": {"customer": "c_custkey", "orders": "o_custkey",
            "lineitem": "l_orderkey"},
    "q04": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
    "q06": {},  # single-table scan
    "q12": {"orders": "o_orderkey", "lineitem": "l_orderkey"},
    "q13": {"customer": "c_custkey", "orders": "o_custkey"},
    "q14": {"lineitem": "l_partkey", "part": "p_partkey"},
    "q17": {"lineitem": "l_partkey", "part": "p_partkey"},
    "q22": {"customer": "c_custkey", "orders": "o_custkey"},
}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS lambda_statistics (
    lambda_id INTEGER PRIMARY KEY, table_name TEXT, column_name TEXT);
CREATE TABLE IF NOT EXISTS partition_scheme_statistics (
    scheme_id INTEGER PRIMARY KEY, label TEXT, lambda_ids TEXT);
CREATE TABLE IF NOT EXISTS environment_statistics (
    env_id INTEGER PRIMARY KEY, data_scale INTEGER, num_nodes INTEGER,
    ts REAL);
CREATE TABLE IF NOT EXISTS run_stat (
    run_id INTEGER PRIMARY KEY AUTOINCREMENT, scheme_id INTEGER,
    query_name TEXT, elapsed_s REAL, ts REAL);
"""


class TraceDB:
    """The four statistics tables + RUN_STAT, as in the reference's
    self-learning sqlite DB (``tpchPrepareTraining.cc`` comments list
    the schema; trace rows: ``gen_trace.sql``)."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path)
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    # -- prepare-training writes --------------------------------------
    def put_lambda(self, lam: PartitionLambda) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO lambda_statistics VALUES (?, ?, ?)",
            (lam.lambda_id, lam.table, lam.column))

    def put_scheme(self, scheme: PartitionScheme) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO partition_scheme_statistics "
            "VALUES (?, ?, ?)",
            (scheme.scheme_id, scheme.label,
             ",".join(str(l.lambda_id) for l in scheme.lambdas)))

    def put_environment(self, data_scale: int, num_nodes: int) -> None:
        self._conn.execute(
            "INSERT INTO environment_statistics "
            "(data_scale, num_nodes, ts) VALUES (?, ?, ?)",
            (data_scale, num_nodes, time.time()))
        self._conn.commit()

    # -- trace writes/reads -------------------------------------------
    def record_run(self, scheme_id: int, query_name: str,
                   elapsed_s: float) -> None:
        self._conn.execute(
            "INSERT INTO run_stat (scheme_id, query_name, elapsed_s, ts) "
            "VALUES (?, ?, ?, ?)",
            (scheme_id, query_name, elapsed_s, time.time()))
        self._conn.commit()

    def runs(self, query_name: Optional[str] = None) -> List[Dict]:
        q = ("SELECT scheme_id, query_name, elapsed_s FROM run_stat"
             + (" WHERE query_name = ?" if query_name else ""))
        cur = self._conn.execute(q, (query_name,) if query_name else ())
        return [{"scheme_id": s, "query": n, "elapsed_s": e}
                for s, n, e in cur.fetchall()]

    def schemes(self) -> List[PartitionScheme]:
        lams = {i: PartitionLambda(i, t, c) for i, t, c in self._conn.execute(
            "SELECT lambda_id, table_name, column_name "
            "FROM lambda_statistics")}
        out = []
        for sid, _label, ids in self._conn.execute(
                "SELECT scheme_id, label, lambda_ids "
                "FROM partition_scheme_statistics"):
            out.append(PartitionScheme(
                sid, tuple(lams[int(i)] for i in ids.split(","))))
        return sorted(out, key=lambda s: s.scheme_id)

    def close(self) -> None:
        self._conn.close()


def prepare_training(trace_db: TraceDB, data_scale: int = 1,
                     num_nodes: int = 1,
                     candidates: Optional[Dict[str, Sequence[str]]] = None,
                     ) -> List[PartitionScheme]:
    """Build the statistics tables and enumerate partition schemes.

    Scheme enumeration mirrors the reference's: a baseline scheme of
    each table's primary candidate, plus one variant per alternative
    lambda (vary one table at a time) — not the full cross product,
    which the reference also avoids (its schemes come from observed
    lambda combinations)."""
    candidates = {t: tuple(v) for t, v in (candidates
                                           or CANDIDATE_LAMBDAS).items()}
    lambda_ids: Dict[Tuple[str, str], PartitionLambda] = {}
    next_id = 1
    for table, cols in sorted(candidates.items()):
        for col in cols:
            lam = PartitionLambda(next_id, table, col)
            lambda_ids[(table, col)] = lam
            trace_db.put_lambda(lam)
            next_id += 1

    baseline = tuple(lambda_ids[(t, cols[0])]
                     for t, cols in sorted(candidates.items()))
    schemes = [PartitionScheme(0, baseline)]
    sid = 1
    for table, cols in sorted(candidates.items()):
        for col in cols[1:]:
            variant = tuple(lambda_ids[(t, col if t == table else c[0])]
                            for t, c in sorted(candidates.items()))
            schemes.append(PartitionScheme(sid, variant))
            sid += 1
    for s in schemes:
        trace_db.put_scheme(s)
    trace_db.put_environment(data_scale, num_nodes)
    return schemes


def load_partitioned(client, scheme: PartitionScheme, db: str = "tpch",
                     tables: Optional[Dict] = None, scale: int = 1,
                     seed: int = 0, n_shards: int = 2) -> None:
    """Reload every table under the scheme: whole-table set for the
    queries plus hash-dispatched shard sets (the reference recreates
    each set with the scheme's partition lambda and re-sends the data —
    ``tpchGenTrace.cc:1028-1072``)."""
    tables = tables or tpch.generate(scale, seed)
    tpch.load_tables(client, db=db, tables=tables)
    for name, rows in tables.items():
        col = scheme.column_for(name)
        if col is None:
            continue
        for i in range(n_shards):  # a reload replaces the old partitioning
            shard = f"{name}_shard{i}"
            if client.set_exists(db, shard):
                client.clear_set(db, shard)
        dispatch_to_sets(client, db, name, rows, n_shards,
                         policy=HashPolicy(lambda r, c=col: r[c]))


def gen_trace(client, trace_db: TraceDB,
              schemes: Optional[Sequence[PartitionScheme]] = None,
              queries: Sequence[str] = DEFAULT_QUERIES,
              db: str = "tpch", scale: int = 1, seed: int = 0,
              n_shards: int = 2) -> None:
    """Run the suite once per scheme, recording RUN_STAT rows —
    ``tpchGenTrace.cc``'s main loop.

    The recorded time is repartition cost + query cost. Repartition
    happens for every table whose scheme key differs from the key the
    query joins on (``QUERY_JOIN_KEYS``): those rows are re-dispatched
    into join-keyed shard sets first, the single-controller stand-in for
    the reference's cross-node shuffle. A scheme matching the workload's
    join keys therefore genuinely runs faster — the signal the
    reference's RUN_STAT captures."""
    schemes = list(schemes) if schemes is not None else trace_db.schemes()
    tables = tpch.generate(scale, seed)
    for scheme in schemes:
        load_partitioned(client, scheme, db=db, tables=tables,
                         n_shards=n_shards)
        for qname in queries:
            t0 = time.perf_counter()
            for table, req_key in QUERY_JOIN_KEYS.get(qname, {}).items():
                if scheme.column_for(table) == req_key:
                    continue  # co-partitioned already: no shuffle
                for i in range(n_shards):
                    shard = f"{table}_reshuffle_shard{i}"
                    if client.set_exists(db, shard):
                        client.clear_set(db, shard)
                dispatch_to_sets(
                    client, db, f"{table}_reshuffle", tables[table],
                    n_shards,
                    policy=HashPolicy(lambda r, c=req_key: r[c]))
            tpch.run_query(client, qname, db=db)
            trace_db.record_run(scheme.scheme_id, qname,
                                time.perf_counter() - t0)


def _scheme_candidate(scheme: PartitionScheme) -> PlacementCandidate:
    return PlacementCandidate(label=scheme.label, mesh_shape=(1,),
                              specs={l.table: (l.column,)
                                     for l in scheme.lambdas})


def train(trace_db: TraceDB, query_name: str,
          schemes: Optional[Sequence[PartitionScheme]] = None,
          epochs: int = 4, seed: int = 0) -> PartitionScheme:
    """Replay the recorded trace through the actor-critic and return the
    scheme the learned policy picks for this query —
    ``tpchTraining1.cc``'s train-from-RUN_STAT loop, with the in-process
    :class:`DRLPlacementAdvisor` standing in for the A3C server."""
    schemes = list(schemes) if schemes is not None else trace_db.schemes()
    by_id = {s.scheme_id: s for s in schemes}
    cands = [_scheme_candidate(s) for s in schemes]
    advisor = DRLPlacementAdvisor(cands, db=HistoryDB(), seed=seed)
    runs = [r for r in trace_db.runs(query_name)
            if r["scheme_id"] in by_id]
    if not runs:
        raise ValueError(f"no trace rows for {query_name!r}")
    for _ in range(epochs):
        for r in runs:
            idx = [s.scheme_id for s in schemes].index(r["scheme_id"])
            advisor.record(query_name, cands[idx], r["elapsed_s"])
    best = advisor.choose(query_name, explore=False)
    return schemes[cands.index(best)]
