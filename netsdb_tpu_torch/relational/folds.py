"""Streamable decompositions of the TPC-H cores — counterpart of
``netsdb_tpu/relational/folds.py``.

A :class:`~netsdb_tpu_torch.plan.fold.FoldSpec` gives a query an init /
per-chunk step / finalize form over its fact table, the reference's
page-by-page pipeline contract (``src/storage/headers/PageScanner.h:
25-34``), with the dimension tables resident. Every step first folds the
chunk's validity into its columns (``dag._fold_mask``: invalid rows get
-1 keys and 0 measures, which the kernels' orphan-key rule drops) and
then runs the same expressions as the whole-table core, accumulating
instead of reducing once. Join plans come from captured statistics
(:func:`plan_from_captured`), never from the streamed columns.

``dag.q01_sink`` and ``dag.q06_sink`` derive their whole-relation path
from Q01's and Q06's folds; ``dag.suite_sink_for`` attaches the query's
fold from :data:`SUITE_FOLDS`, which the executor streams when the fact
set is paged. Q17 has two passes (the per-part average before the
pricing), so its stream is read twice.

Steps launch no host synchronisation: the dictionary predicates become
device LUTs once, in ``init``, and ride in the state. A step may update
its own state in place; it never writes a chunk, whose columns may be
the device cache's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from netsdb_tpu_torch.plan.fold import FoldSpec, single_pass
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.planner import JoinPlan, plan_join_from_stats
from netsdb_tpu_torch.relational.stats import ColumnStats
from netsdb_tpu_torch.relational.table import date_to_int

Captured = Dict[str, Dict[str, ColumnStats]]


def plan_from_captured(cap: Captured, nrows: Dict[str, int],
                       build_tab: str, build_col: str,
                       probe_tab: str, probe_col: str,
                       kind: Optional[str] = None) -> JoinPlan:
    """``planner.plan_join`` from captured summaries instead of live
    tables, with the same widening rule (the plan's key space bounds
    both columns, so orphan foreign keys stay in range)."""
    bs = cap[build_tab][build_col]
    ks = max(bs.key_space, cap[probe_tab][probe_col].key_space)
    merged = ColumnStats(bs.n_rows, bs.min_val, max(bs.max_val, ks - 1),
                         bs.n_distinct)
    return plan_join_from_stats(merged, nrows[probe_tab], kind)


def _fm(t):
    from netsdb_tpu_torch.relational.dag import _fold_mask

    return _fold_mask(t)


def _lut(dictionary, pred, device) -> torch.Tensor:
    from netsdb_tpu_torch.relational.queries import _lut as lut

    return lut(dictionary, pred, device)


_I32_MAX = 2147483647


# ---------------------------------------------------------------- Q01
def fold_q01(cap: Captured, dicts, nrows, *, delta_date: str = "1998-09-02"
             ) -> FoldSpec:
    from netsdb_tpu_torch.relational.queries import _q01_fold

    delta = date_to_int(delta_date)

    def shape(src):
        n_ls = len(src.dicts["l_linestatus"])
        return n_ls, len(src.dicts["l_returnflag"]) * n_ls

    def init(prev, src):
        _, g = shape(src)
        dev = src.device
        return (torch.zeros((5, g), dtype=torch.float32, device=dev),
                torch.zeros((g,), dtype=torch.int32, device=dev))

    def step(st, t):
        t = _fm(t)
        n_ls, g = shape(t)
        s, c = _q01_fold(g, n_ls, t["l_returnflag"], t["l_linestatus"],
                         t["l_quantity"], t["l_extendedprice"],
                         t["l_discount"], t["l_tax"],
                         t["l_shipdate"] <= delta)
        return (st[0] + s, st[1] + c)

    return single_pass(init, step, lambda st, src: (st[0], st[1]))


# ---------------------------------------------------------------- Q06
def fold_q06(cap: Captured, dicts, nrows, *, d0: str = "1994-01-01",
             d1: str = "1995-01-01", disc: float = 0.06, qty: int = 24
             ) -> FoldSpec:
    a, b = date_to_int(d0), date_to_int(d1)

    def step(st, t):
        t = _fm(t)
        ship, discount = t["l_shipdate"], t["l_discount"]
        # the reference closes over disc: its bounds are Python floats
        mask = ((ship >= a) & (ship < b)
                & (discount >= disc - 0.011) & (discount <= disc + 0.011)
                & (t["l_quantity"] < qty))
        return st + torch.where(mask, t["l_extendedprice"] * discount,
                                0.0).sum()

    return single_pass(
        lambda prev, src: torch.zeros((), dtype=torch.float32,
                                      device=src.device),
        step, lambda st, src: (st,))


# ---------------------------------------------------------------- Q02
def fold_q02(cap: Captured, dicts, nrows, *, size: int = 15,
             type_suffix: str = "BRUSHED", region: str = "EUROPE"
             ) -> FoldSpec:
    """Minimum-cost supplier per part over a streamed partsupp. Chunks
    arbitrate lexicographically on (cost, global row id): the chunk
    winner's ``_rowid`` breaks cost ties like the whole-table core's
    first-row-wins minimum over row numbers, so the outputs are the
    same. The supplier side's region chain runs once, in init."""
    jp_part = plan_from_captured(cap, nrows, "part", "p_partkey",
                                 "partsupp", "ps_partkey")
    jp_sup = plan_from_captured(cap, nrows, "supplier", "s_suppkey",
                                "partsupp", "ps_suppkey")
    jp_nat = plan_from_captured(cap, nrows, "nation", "n_nationkey",
                                "supplier", "s_nationkey")
    jp_reg = plan_from_captured(cap, nrows, "region", "r_regionkey",
                                "nation", "n_regionkey")
    n_part = jp_part.key_space

    def init(prev, src, part, sup, nat, reg):
        part, sup, nat, reg = _fm(part), _fm(sup), _fm(nat), _fm(reg)
        dev = part.device
        type_ok = _lut(part.dicts["p_type"],
                       lambda s: s.endswith(type_suffix), dev)
        part_ok = (part["p_size"] == size) & K.take(type_ok, part["p_type"])
        nidx, nhit = K.pk_fk_join(nat["n_nationkey"], sup["s_nationkey"],
                                  plan=jp_nat)
        sup_region = K.take(nat["n_regionkey"], nidx)
        ridx, rhit = K.pk_fk_join(reg["r_regionkey"], sup_region,
                                  plan=jp_reg)
        sup_ok = (nhit & rhit
                  & (K.take(reg["r_name"], ridx)
                     == reg.code("r_name", region)))
        return {"has": torch.zeros(n_part, dtype=torch.bool, device=dev),
                "cmin": torch.full((n_part,), float("inf"),
                                   dtype=torch.float32, device=dev),
                "rowid": torch.full((n_part,), _I32_MAX, dtype=torch.int32,
                                    device=dev),
                "sup_row": torch.zeros(n_part, dtype=torch.int32,
                                       device=dev),
                "part_ok": part_ok, "sup_ok": sup_ok, "nidx": nidx}

    def step(st, t, part, sup, nat, reg):
        t, part, sup = _fm(t), _fm(part), _fm(sup)
        ps_part, ps_cost = t["ps_partkey"], t["ps_supplycost"]
        _, phit = K.pk_fk_join(part["p_partkey"], ps_part, st["part_ok"],
                               plan=jp_part)
        sidx, shit = K.pk_fk_join(sup["s_suppkey"], t["ps_suppkey"],
                                  st["sup_ok"], plan=jp_sup)
        valid = phit & shit
        cmin_c = K.segment_min(ps_cost, ps_part, n_part, valid)
        at_min = valid & (ps_cost == K.take(cmin_c, ps_part))
        n = ps_part.shape[0]
        local = torch.arange(n, dtype=torch.int32, device=ps_part.device)
        win_local = K.segment_min(local, ps_part, n_part, at_min)
        has_c = win_local < _I32_MAX
        wl = win_local.clamp(0, max(n - 1, 0))
        rowid_c = torch.where(has_c, K.take(t["_rowid"], wl), _I32_MAX)
        sup_row_c = torch.where(has_c, K.take(sidx, wl), 0)
        better = has_c & (~st["has"] | (cmin_c < st["cmin"])
                          | ((cmin_c == st["cmin"])
                             & (rowid_c < st["rowid"])))
        st["has"] |= has_c
        st["cmin"] = torch.where(better, cmin_c, st["cmin"])
        st["rowid"] = torch.where(better, rowid_c, st["rowid"])
        st["sup_row"] = torch.where(better, sup_row_c, st["sup_row"])
        return st

    def fin(st, src, part, sup, nat, reg):
        has = st["has"]
        nat_row = torch.where(has, K.take(st["nidx"], st["sup_row"]), 0)
        ints = torch.stack([has.to(torch.int32), st["sup_row"], nat_row])
        return (ints, st["cmin"])

    def merge(a, b):
        # grace partitions hold disjoint part keys (both sides hashed on
        # the part key): where b found a winner take b, else a
        (ai, ac), (bi, bc) = a, b
        bhas = bi[0] > 0
        return (torch.where(bhas[None, :], bi, ai),
                torch.where(bhas, bc, ac))

    return single_pass(init, step, fin, merge,
                       probe_key="ps_partkey", build_key="p_partkey",
                       probe_columns=("ps_suppkey", "ps_supplycost"))


# ---------------------------------------------------------------- Q03
def fold_q03(cap: Captured, dicts, nrows, *, segment: str = "BUILDING",
             date: str = "1995-03-15", k: int = 10) -> FoldSpec:
    """Streamed lineitem against resident customer and orders; the state
    is the core's own (key space,) revenue and order-date accumulators,
    so finalize's top k packs the core's output. The customer ⋈ orders
    qualification runs once, in init."""
    d = date_to_int(date)
    jp_cust = plan_from_captured(cap, nrows, "customer", "c_custkey",
                                 "orders", "o_custkey")
    jp_orders = plan_from_captured(cap, nrows, "orders", "o_orderkey",
                                   "lineitem", "l_orderkey")
    n_orders = jp_orders.key_space

    def init(prev, src, cust, orders):
        cust, orders = _fm(cust), _fm(orders)
        dev = orders.device
        cust_ok = cust["c_mktsegment"] == cust.code("c_mktsegment", segment)
        _, chit = K.pk_fk_join(cust["c_custkey"], orders["o_custkey"],
                               cust_ok, plan=jp_cust)
        order_ok = chit & (orders["o_orderdate"] < d)
        return (torch.zeros(n_orders, dtype=torch.float32, device=dev),
                torch.full((n_orders,), _I32_MAX, dtype=torch.int32,
                           device=dev),
                order_ok)

    def step(st, t, cust, orders):
        t, orders = _fm(t), _fm(orders)
        rev_acc, od_acc, order_ok = st
        l_okey = t["l_orderkey"]
        oidx, ohit = K.pk_fk_join(orders["o_orderkey"], l_okey, order_ok,
                                  plan=jp_orders)
        li_ok = ohit & (t["l_shipdate"] > d)
        rev_acc += K.segment_sum(
            t["l_extendedprice"] * (1.0 - t["l_discount"]), l_okey,
            n_orders, li_ok)
        torch.minimum(od_acc, K.segment_min(
            K.take(orders["o_orderdate"], oidx), l_okey, n_orders, li_ok),
            out=od_acc)
        return st

    def fin(st, src, cust, orders):
        rev, odate = st[0], st[1]
        top_idx, top_ok = K.top_k_masked(rev, k, rev > 0)
        ints = torch.stack([top_idx, top_ok.to(torch.int32),
                            K.take(odate, top_idx)])
        return (ints, K.take(rev, top_idx))

    return single_pass(init, step, fin)


# ---------------------------------------------------------------- Q04
def fold_q04(cap: Captured, dicts, nrows, *, d0: str = "1993-07-01",
             d1: str = "1993-10-01") -> FoldSpec:
    a, b = date_to_int(d0), date_to_int(d1)
    jp_li = plan_from_captured(cap, nrows, "lineitem", "l_orderkey",
                               "orders", "o_orderkey")

    def init(prev, src, orders):
        return torch.zeros(nrows["orders"], dtype=torch.bool,
                           device=orders.device)

    def step(st, t, orders):
        t, orders = _fm(t), _fm(orders)
        late = t["l_commitdate"] < t["l_receiptdate"]
        st |= K.member(t["l_orderkey"], orders["o_orderkey"], late,
                       plan=jp_li)
        return st

    def fin(st, src, orders):
        orders = _fm(orders)
        n_pri = len(orders.dicts["o_orderpriority"])
        o_date = orders["o_orderdate"]
        in_q = (o_date >= a) & (o_date < b)
        return (K.segment_count(orders["o_orderpriority"], n_pri,
                                st & in_q),)

    return single_pass(init, step, fin)


# ---------------------------------------------------------------- Q12
def fold_q12(cap: Captured, dicts, nrows, *, mode1: str = "MAIL",
             mode2: str = "SHIP", d0: str = "1994-01-01",
             d1: str = "1995-01-01") -> FoldSpec:
    a, b = date_to_int(d0), date_to_int(d1)
    jp_orders = plan_from_captured(cap, nrows, "orders", "o_orderkey",
                                   "lineitem", "l_orderkey")
    li_dicts = dicts["lineitem"]
    n_modes = len(li_dicts["l_shipmode"])
    m1 = li_dicts["l_shipmode"].index(mode1)
    m2 = li_dicts["l_shipmode"].index(mode2)

    def init(prev, src, orders):
        hi = _lut(orders.dicts["o_orderpriority"],
                  lambda s: s in ("1-URGENT", "2-HIGH"), orders.device)
        return (torch.zeros((2, n_modes), dtype=torch.int32,
                            device=orders.device), hi)

    def step(st, t, orders):
        t, orders = _fm(t), _fm(orders)
        counts, hi = st
        l_mode = t["l_shipmode"]
        mask = (((l_mode == m1) | (l_mode == m2))
                & (t["l_commitdate"] < t["l_receiptdate"])
                & (t["l_shipdate"] < t["l_commitdate"])
                & (t["l_receiptdate"] >= a) & (t["l_receiptdate"] < b))
        oidx, ohit = K.pk_fk_join(orders["o_orderkey"], t["l_orderkey"],
                                  plan=jp_orders)
        mask = mask & ohit
        high = K.take(hi, K.take(orders["o_orderpriority"], oidx))
        counts[0] += K.segment_count(l_mode, n_modes, mask & high)
        counts[1] += K.segment_count(l_mode, n_modes, mask & ~high)
        return st

    # a paged orders build: partitions hold disjoint order keys, so the
    # per-mode counts add across partition outputs
    return single_pass(init, step, lambda st, src, orders: (st[0],),
                       merge=lambda x, y: (x[0] + y[0],),
                       probe_key="l_orderkey", build_key="o_orderkey",
                       probe_columns=("l_shipmode", "l_shipdate",
                                      "l_commitdate", "l_receiptdate"))


# ---------------------------------------------------------------- Q13
_Q13_CAP = 256  # the histogram domain of queries._Q13_CAP


def fold_q13(cap: Captured, dicts, nrows, *, word1: str = "special",
             word2: str = "requests") -> FoldSpec:
    import re

    n_cust = cap["customer"]["c_custkey"].key_space
    pat = re.compile(f"{re.escape(word1)}.*{re.escape(word2)}")

    def init(prev, src, cust):
        keep = (_lut(src.dicts["o_comment"], lambda s: not pat.search(s),
                     cust.device)
                if "o_comment" in src.dicts else None)
        return (torch.zeros(n_cust, dtype=torch.int32, device=cust.device),
                keep)

    def step(st, t, cust):
        t = _fm(t)
        counts, keep_lut = st
        keep = (K.take(keep_lut, t["o_comment"]) if keep_lut is not None
                else t["o_custkey"] >= 0)
        counts += K.segment_count(t["o_custkey"], n_cust, keep)
        return st

    def fin(st, src, cust):
        cust = _fm(cust)
        c_key = cust["c_custkey"]
        real = c_key >= 0  # grace partitions pad with invalid rows, which
        # must not count as customers without orders
        per_cust = torch.where(real, K.take(st[0], c_key), 0)
        hist = K.bincount_masked(per_cust.clamp(max=_Q13_CAP - 1), _Q13_CAP,
                                 real)
        maxc = (per_cust.max().clamp(min=0) if per_cust.numel() else
                torch.zeros((), dtype=torch.int32, device=c_key.device))
        return (hist, maxc)

    # a paged customer build: each customer and its orders land in one
    # partition, so the histograms add and the max is the max of maxima
    return single_pass(init, step, fin,
                       merge=lambda x, y: (x[0] + y[0],
                                           torch.maximum(x[1], y[1])),
                       probe_key="o_custkey", build_key="c_custkey",
                       probe_columns=("o_comment",))


# ---------------------------------------------------------------- Q14
def fold_q14(cap: Captured, dicts, nrows, *, d0: str = "1995-09-01",
             d1: str = "1995-10-01") -> FoldSpec:
    a, b = date_to_int(d0), date_to_int(d1)
    jp_part = plan_from_captured(cap, nrows, "part", "p_partkey",
                                 "lineitem", "l_partkey")

    def init(prev, src, part):
        promo = _lut(part.dicts["p_type"], lambda s: s.startswith("PROMO"),
                     part.device)
        return (torch.zeros(2, dtype=torch.float32, device=part.device),
                promo)

    def step(st, t, part):
        t, part = _fm(t), _fm(part)
        acc, promo = st
        mask = (t["l_shipdate"] >= a) & (t["l_shipdate"] < b)
        pidx, phit = K.pk_fk_join(part["p_partkey"], t["l_partkey"],
                                  plan=jp_part)
        mask = mask & phit
        rev = torch.where(mask, t["l_extendedprice"]
                          * (1.0 - t["l_discount"]), 0.0)
        is_promo = K.take(promo, K.take(part["p_type"], pidx))
        acc += torch.stack([torch.where(is_promo, rev, 0.0).sum(),
                            rev.sum()])
        return st

    return single_pass(init, step, lambda st, src, part: (st[0],))


# ---------------------------------------------------------------- Q17
def fold_q17(cap: Captured, dicts, nrows, *, brand: str = "Brand#23",
             container: str = "MED BOX") -> FoldSpec:
    jp_part = plan_from_captured(cap, nrows, "part", "p_partkey",
                                 "lineitem", "l_partkey")
    ks = jp_part.key_space

    def part_hit(t, part):
        part_ok = ((part["p_brand"] == part.code("p_brand", brand))
                   & (part["p_container"] == part.code("p_container",
                                                       container)))
        _, phit = K.pk_fk_join(part["p_partkey"], t["l_partkey"], part_ok,
                               plan=jp_part)
        return phit

    # pass 1: per-part quantity sum and count over qualifying rows
    def init1(prev, src, part):
        dev = part.device
        return (torch.zeros(ks, dtype=torch.float32, device=dev),
                torch.zeros(ks, dtype=torch.int32, device=dev))

    def step1(st, t, part):
        t, part = _fm(t), _fm(part)
        phit = part_hit(t, part)
        qty = t["l_quantity"].to(torch.float32)
        st[0].add_(K.segment_sum(qty, t["l_partkey"], ks, phit))
        st[1].add_(K.segment_count(t["l_partkey"], ks, phit))
        return st

    # pass 2: price the rows under 0.2 x the pass-1 average
    def init2(prev, src, part):
        s, c = prev
        avg = s / c.clamp(min=1).to(torch.float32)
        return (avg, torch.zeros((), dtype=torch.float32,
                                 device=part.device))

    def step2(st, t, part):
        t, part = _fm(t), _fm(part)
        avg, acc = st
        phit = part_hit(t, part)
        qty = t["l_quantity"].to(torch.float32)
        small = phit & (qty < 0.2 * K.take(avg, t["l_partkey"]))
        acc += torch.where(small, t["l_extendedprice"], 0.0).sum()
        return st

    return FoldSpec(((init1, step1), (init2, step2)),
                    lambda st, src, part: (st[1] / 7.0,))


# ---------------------------------------------------------------- Q22
def fold_q22(cap: Captured, dicts, nrows,
             *, prefixes: Tuple[str, ...] = ("13", "31", "23", "29", "30",
                                             "18", "17")) -> FoldSpec:
    from netsdb_tpu_torch.relational.queries import q22_code_lut

    jp_cust = plan_from_captured(cap, nrows, "orders", "o_custkey",
                                 "customer", "c_custkey")
    n_pref = len(sorted(set(prefixes)))

    def init(prev, src, cust):
        return torch.zeros(nrows["customer"], dtype=torch.bool,
                           device=cust.device)

    def step(st, t, cust):
        t, cust = _fm(t), _fm(cust)
        st |= K.member(t["o_custkey"], cust["c_custkey"],
                       t["o_custkey"] >= 0, plan=jp_cust)
        return st

    def fin(st, src, cust):
        cust = _fm(cust)
        _, code_lut = q22_code_lut(cust.dicts["c_phone"], prefixes,
                                   cust.device)
        pref = K.take(code_lut, cust["c_phone"])
        in_pref = pref >= 0
        c_bal = cust["c_acctbal"]
        pos = in_pref & (c_bal > 0)
        avg = (torch.where(pos, c_bal, 0.0).sum()
               / pos.to(torch.int32).sum().clamp(min=1))
        sel = in_pref & (c_bal > avg) & ~st
        seg = pref.clamp(0, n_pref - 1)
        return (torch.stack(
            [K.segment_count(seg, n_pref, sel).to(torch.float32),
             K.segment_sum(c_bal, seg, n_pref, sel)]),)

    return single_pass(init, step, fin)


# ---------------------------------------------------------------- registry
#: query → (the fact set streamed when it is paged, its fold). All ten
#: suite queries decompose; a fold-less consumer of a paged set gets the
#: executor's assembled relation.
SUITE_FOLDS: Dict[str, Tuple[str, Callable[..., FoldSpec]]] = {
    "q01": ("lineitem", fold_q01),
    "q02": ("partsupp", fold_q02),
    "q03": ("lineitem", fold_q03),
    "q04": ("lineitem", fold_q04),
    "q06": ("lineitem", fold_q06),
    "q12": ("lineitem", fold_q12),
    "q13": ("orders", fold_q13),
    "q14": ("lineitem", fold_q14),
    "q17": ("lineitem", fold_q17),
    "q22": ("orders", fold_q22),
}
