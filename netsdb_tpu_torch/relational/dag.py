"""Columnar queries as Computation DAGs over stored sets — counterpart
of ``netsdb_tpu/relational/dag.py``.

A query is an ``Apply`` (or a chain of tuple-passing ``Join``\\s ending in
one) over the column tables scanned from relation sets, run through
``Client.execute_computations``. The result is itself a relation (a
small ``ColumnTable`` with group-key code columns, aggregate columns and
a ``valid`` mask over non-empty groups) or, for the suite, the core's
raw tensors, stored into the sink's output set like the reference's
OUTPUT sets.

Every body folds each scanned table's validity into its columns
(:func:`_fold_mask`) before the core runs, so invalid rows (a filtered
stored table, the build side of Q03) never contribute: -1 keys are
dropped by the kernels' orphan-key rule, measures are 0.

The physical plan comes from ``client.analyze_set`` summaries collected
at ingest, closed over by the body and named in its label.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import (FoldSpec, single_pass,
                                        tree_add_states)
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.planner import (JoinPlan,
                                                 plan_join_from_stats)
from netsdb_tpu_torch.relational.queries import _SUITE_CORES
from netsdb_tpu_torch.relational.stats import ColumnStats, inject_stats
from netsdb_tpu_torch.relational.table import (ColumnTable, date_to_int,
                                               int_to_date)


def _q03_filter_node(db: str, segment_code: int, d: int, jp_cust,
                     orders_set: str, customer_set: str):
    """Customer- and date-qualified orders: one builder for
    ``q03_sink``'s inline build side and ``q03_build_sink``'s stage."""

    def filter_orders(orders: ColumnTable, cust: ColumnTable) -> ColumnTable:
        cust_ok = (cust["c_mktsegment"] == segment_code) & cust.mask()
        _, chit = K.pk_fk_join(cust["c_custkey"], orders["o_custkey"],
                               cust_ok, plan=jp_cust)
        return orders.filter(chit & (orders["o_orderdate"] < d))

    return Join(ScanSet(db, orders_set), ScanSet(db, customer_set),
                fn=filter_orders,
                label=f"q03filter:{segment_code}:{d}:{jp_cust.key_space}")


def q01_sink(db: str, lineitem_set: str = "lineitem",
             delta_date: str = "1998-09-02",
             output_set: str = "q01_out") -> WriteSet:
    """Pricing summary: SCAN(lineitem) → APPLY(q01 fold) → OUTPUT. One
    row per (returnflag, linestatus) group: code columns with the
    input's dictionaries, aggregate columns, ``valid`` over non-empty
    groups."""
    from netsdb_tpu_torch.relational.folds import fold_q01

    delta = date_to_int(delta_date)
    base = fold_q01({}, {}, {}, delta_date=delta_date)

    def fin(state, src) -> ColumnTable:
        sums, counts = state
        n_ls = len(src.dicts["l_linestatus"])
        n_groups = len(src.dicts["l_returnflag"]) * n_ls
        gid = torch.arange(n_groups, dtype=torch.int32, device=counts.device)
        cnt_f = counts.clamp(min=1).to(torch.float32)
        return ColumnTable(
            cols={
                "l_returnflag": torch.div(gid, n_ls, rounding_mode="floor"),
                "l_linestatus": gid % n_ls,
                "sum_qty": sums[0], "sum_base_price": sums[1],
                "sum_disc_price": sums[2], "sum_charge": sums[3],
                "sum_disc": sums[4], "count": counts,
                "avg_qty": sums[0] / cnt_f,
                "avg_price": sums[1] / cnt_f,
                "avg_disc": sums[4] / cnt_f,
            },
            dicts={"l_returnflag": src.dicts["l_returnflag"],
                   "l_linestatus": src.dicts["l_linestatus"]},
            valid=counts > 0)

    return WriteSet(Apply(ScanSet(db, lineitem_set),
                          fold=FoldSpec(base.passes, fin,
                                        state_merge=tree_add_states),
                          label=f"cq01:{delta}"),
                    db, output_set)


def q06_sink(db: str, lineitem_set: str = "lineitem",
             d0: str = "1994-01-01", d1: str = "1995-01-01",
             disc: float = 0.06, qty: int = 24,
             output_set: str = "q06_out") -> WriteSet:
    """Revenue forecast: one filtered reduction; a 1-row relation
    {revenue}."""
    from netsdb_tpu_torch.relational.folds import fold_q06

    a, b = date_to_int(d0), date_to_int(d1)
    base = fold_q06({}, {}, {}, d0=d0, d1=d1, disc=disc, qty=qty)

    def fin(state, src) -> ColumnTable:
        return ColumnTable(cols={"revenue": state[None]})

    return WriteSet(Apply(ScanSet(db, lineitem_set),
                          fold=FoldSpec(base.passes, fin,
                                        state_merge=tree_add_states),
                          label=f"cq06:{a}:{b}:{disc}:{qty}"),
                    db, output_set)


def q03_sink(db: str, n_orders: int, n_customers: int, segment_code: int,
             date: str = "1995-03-15", k: int = 10,
             lineitem_set: str = "lineitem", orders_set: str = "orders",
             customer_set: str = "customer",
             output_set: str = "q03_out") -> WriteSet:
    """Top unshipped orders over three stored sets: SCAN(orders) ⋈
    SCAN(customer) → SCAN(lineitem) ⋈ · → OUTPUT, LUT joins with the
    caller's key spaces (:func:`q03_sink_for` derives them from the
    stored statistics). Result: a k-row relation {okey, odate, revenue}
    masked to real hits."""
    d = date_to_int(date)
    jp_cust = JoinPlan("lut", n_customers)
    jp_orders = JoinPlan("lut", n_orders)
    filtered = _q03_filter_node(db, segment_code, d, jp_cust,
                                orders_set, customer_set)
    joined = Join(ScanSet(db, lineitem_set), filtered,
                  fold=q03_probe_fold(d, k, jp_orders),
                  label=f"q03join:{d}:{k}:{n_orders}")
    return WriteSet(joined, db, output_set)


def q03_build_sink(db: str, n_customers: int, segment_code: int,
                   date: str = "1995-03-15",
                   orders_set: str = "orders",
                   customer_set: str = "customer",
                   output_set: str = "q03_build") -> WriteSet:
    """Stage 1 of the two-stage Q03: the filtered build side (qualified
    orders) materialised into its own set."""
    node = _q03_filter_node(db, segment_code, date_to_int(date),
                            JoinPlan("lut", n_customers),
                            orders_set, customer_set)
    return WriteSet(node, db, output_set)


def q03_probe_sink(db: str, n_orders: int, date: str = "1995-03-15",
                   k: int = 10, lineitem_set: str = "lineitem",
                   build_set: str = "q03_build",
                   output_set: str = "q03_out") -> WriteSet:
    """Stage 2: probe a pre-built orders set with lineitem."""
    d = date_to_int(date)
    joined = Join(ScanSet(db, lineitem_set), ScanSet(db, build_set),
                  fold=q03_probe_fold(d, k, JoinPlan("lut", n_orders)),
                  label=f"q03probe:{d}:{k}:{n_orders}")
    return WriteSet(joined, db, output_set)


def q03_probe_fold(d: int, k: int, jp_orders) -> FoldSpec:
    """Lineitem fold against an orders build side. The revenue
    accumulator lives in the build side's row space; the join plan is
    derived from the build block's own row count (the key space bounds
    it), and ``merge`` re-takes the top k of two partitions' outputs."""

    def _block_plan(orders: ColumnTable, n_probe: int):
        from netsdb_tpu_torch.relational import tuning

        ks = jp_orders.key_space
        return plan_join_from_stats(
            ColumnStats(orders.num_rows, 0, ks - 1, -1), n_probe,
            tuning.device_kind(orders.device))

    def init(prev, src, orders):
        return torch.zeros((orders.num_rows,), dtype=torch.float32,
                           device=orders.device)

    def step(rev_acc, li: ColumnTable, orders: ColumnTable):
        li, orders = _fold_mask(li), _fold_mask(orders)
        oidx, ohit = K.pk_fk_join(orders["o_orderkey"], li["l_orderkey"],
                                  orders["o_orderkey"] >= 0,
                                  plan=_block_plan(orders, li.num_rows))
        li_ok = ohit & (li["l_shipdate"] > d)
        return rev_acc + K.segment_sum(
            li["l_extendedprice"] * (1.0 - li["l_discount"]), oidx,
            orders.num_rows, li_ok)

    def fin(rev_acc, src, orders: ColumnTable) -> ColumnTable:
        orders = _fold_mask(orders)
        top_idx, top_ok = K.top_k_masked(rev_acc,
                                         min(k, rev_acc.shape[0]),
                                         rev_acc > 0)
        return ColumnTable(
            cols={"okey": K.take(orders["o_orderkey"], top_idx),
                  "odate": K.take(orders["o_orderdate"], top_idx),
                  "revenue": K.take(rev_acc, top_idx)},
            valid=top_ok)

    def merge(a: ColumnTable, b: ColumnTable) -> ColumnTable:
        rev = torch.cat([a["revenue"], b["revenue"]])
        valid = torch.cat([a.mask(), b.mask()])
        idx, ok = K.top_k_masked(rev, min(k, rev.shape[0]),
                                 valid & (rev > 0))
        cat = lambda c: K.take(torch.cat([a[c], b[c]]), idx)
        return ColumnTable(cols={"okey": cat("okey"), "odate": cat("odate"),
                                 "revenue": K.take(rev, idx)},
                           valid=ok)

    return single_pass(init, step, fin, merge,
                       probe_key="l_orderkey", build_key="o_orderkey",
                       probe_columns=("l_shipdate", "l_extendedprice",
                                      "l_discount"))


def q03_sink_for(client, db: str, segment: str = "BUILDING",
                 date: str = "1995-03-15", k: int = 10) -> WriteSet:
    """q03's static parameters (key spaces, segment code) from the
    stored sets' ``analyze_set`` summaries, never the tables."""
    orders = client.analyze_set(db, "orders")
    cust = client.analyze_set(db, "customer")
    seg_dict = cust["dicts"]["c_mktsegment"]
    return q03_sink(
        db,
        n_orders=orders["stats"]["o_orderkey"].key_space,
        n_customers=cust["stats"]["c_custkey"].key_space,
        # -1 for an unknown segment matches nothing: an empty result
        segment_code=(seg_dict.index(segment) if segment in seg_dict
                      else -1),
        date=date, k=k)


def q03_rows(result: ColumnTable) -> list:
    """A q03 result relation decoded to the row engine's output shape."""
    ok = result.mask().cpu().numpy()
    okey = result["okey"].cpu().numpy()
    odate = result["odate"].cpu().numpy()
    rev = result["revenue"].cpu().numpy()
    rows = [{"okey": int(okey[j]), "odate": int_to_date(int(odate[j])),
             "revenue": float(rev[j])}
            for j in range(len(ok)) if ok[j]]
    rows.sort(key=lambda r: (-r["revenue"], r["odate"]))
    return rows


# ------------------------------------------- whole suite via the set API
# the stored sets each query core scans, fact table first or last
_QUERY_TABLES = {
    "q01": ("lineitem",),
    "q02": ("part", "supplier", "nation", "region", "partsupp"),
    "q03": ("customer", "orders", "lineitem"),
    "q04": ("orders", "lineitem"),
    "q06": ("lineitem",),
    "q12": ("orders", "lineitem"),
    "q13": ("customer", "orders"),
    "q14": ("lineitem", "part"),
    "q17": ("lineitem", "part"),
    "q22": ("customer", "orders"),
}

FACT_TABLES = ("lineitem", "orders")


def _fold_mask(t: ColumnTable) -> ColumnTable:
    """Fold validity into the columns, no compaction: invalid rows get
    -1 in int and code columns, False in bool columns and 0 in
    measures."""
    if t.valid is None:
        return t
    m = t.valid
    cols = {}
    for name, c in t.cols.items():
        if c.dtype == torch.bool:
            cols[name] = c & m
        elif c.is_floating_point():
            cols[name] = torch.where(m, c, 0.0)
        else:
            cols[name] = torch.where(m, c, -1)
    return ColumnTable(cols, t.dicts, None)


def suite_sink_for(client, db: str, qname: str,
                   output_set: Optional[str] = None, **params) -> WriteSet:
    """Any of the ten cores as a DAG over stored sets. The scanned
    tables chain into one application through tuple-passing binary
    Joins; the body folds each table's mask into its columns, injects
    the statistics captured from ``client.analyze_set`` and runs the
    same core as the direct path (``queries._SUITE_CORES``), so the
    output is the core's raw tensors. The label carries a hash of the
    captured statistics. No streamable fold is attached while
    relations cannot be paged (ROADMAP.md A6, part 2)."""
    if qname not in _QUERY_TABLES:
        raise KeyError(f"unknown suite query {qname!r}; "
                       f"have {sorted(_QUERY_TABLES)}")
    names = _QUERY_TABLES[qname]
    core, args_fn = _SUITE_CORES[qname]
    info = {n: client.analyze_set(db, n) for n in names}
    captured = {n: dict(info[n]["stats"]) for n in names}
    stats_tag = hashlib.blake2s(
        repr(sorted((n, sorted((c, s.n_rows, s.min_val, s.max_val)
                               for c, s in cs.items()))
                    for n, cs in captured.items())).encode()
    ).hexdigest()[:12]

    def run_core(*tabs) -> tuple:
        tables = {n: inject_stats(_fold_mask(t), captured[n])
                  for n, t in zip(names, tabs)}
        out = core(*args_fn(tables, **params))
        return out if isinstance(out, tuple) else (out,)

    label = f"suite:{qname}:{params}:{stats_tag}"
    node = ScanSet(db, names[0])
    if len(names) == 1:
        node = Apply(node, lambda t: run_core(t), label=label)
    else:
        for n in names[1:-1]:
            node = Join(node, ScanSet(db, n),
                        fn=lambda a, b: (a + (b,) if isinstance(a, tuple)
                                         else (a, b)),
                        label=f"gather:{n}", passthrough=True)
        node = Join(node, ScanSet(db, names[-1]),
                    fn=lambda a, b: run_core(*(a + (b,) if isinstance(a, tuple)
                                               else (a, b))),
                    label=label)
    return WriteSet(node, db, output_set or f"{qname}_out")


def run_query(client, sink: WriteSet, job_name: Optional[str] = None):
    """Run one columnar sink; returns its result (also stored in the
    sink's output set)."""
    name = job_name or f"dag-{sink.set_name}"
    results = client.execute_computations(sink, job_name=name)
    return next(iter(results.values()))
