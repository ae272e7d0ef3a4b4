"""Columnar TPC-H queries — counterpart of
``netsdb_tpu/relational/queries.py``.

The ten queries the reference implements (``src/tpch/source/Query01..
22``), each a core of torch ops over the columns of its tables: filters
are masks, group-bys segment reductions, joins LUT or sort probes
(:mod:`~netsdb_tpu_torch.relational.kernels`). String and LIKE
predicates run once over the host dictionary and reach the rows as a
code lookup. Every op of a core runs on the device its tables live on;
the only host work is the dictionary predicates, and reading the small
results back in the ``cqXX`` wrappers.

Each core is the reference's core op for op, with ``jnp.take`` as
:func:`~netsdb_tpu_torch.relational.kernels.take` (an index outside the
column gives the same fill value). Scalar parameters keep the
reference's arithmetic: a float threshold the reference computes in
float32 inside its jitted core is computed in float32 here. The physical
choices (join strategy, segment method) come from the statistics the
tables carry (:mod:`~netsdb_tpu_torch.relational.planner`).

``cqXX(tables)`` returns the same Python structure as the reference's
``cqXX``; ``_SUITE_CORES`` maps each query to its (core, argument
builder) pair, which the set-API DAGs (``relational/dag.py``) run over
stored sets.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational import planner as P
from netsdb_tpu_torch.relational.stats import key_space
from netsdb_tpu_torch.relational.table import (ColumnTable, date_to_int,
                                               int_to_date)

Tables = Dict[str, ColumnTable]

_I32_MAX = 2147483647


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's traced scalar."""
    return float(np.float32(x))


def _upload(host: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device``: through page-locked memory on a
    card, so the copy is queued behind the stream's work instead of
    synchronising the host with it."""
    t = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _lut(dictionary: List[str], pred: Callable[[str], bool],
         device) -> torch.Tensor:
    """A string predicate evaluated once over a dictionary → a bool LUT
    over its codes, on ``device``."""
    host = np.fromiter((pred(s) for s in dictionary), np.bool_,
                       len(dictionary))
    return _upload(host, device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ct(tables: Tables, name: str) -> ColumnTable:
    """A table for the direct path, compacted if it carries a validity
    mask (the cores assume every row is real; the DAG path folds the
    mask into the columns instead)."""
    return tables[name].compact()


# ---------------------------------------------------------------- Q01
def _q01_fold(n_groups, n_ls, rf, ls, qty, price, disc, tax, mask):
    """Shared Q01 reduction (the direct core and ``dag.q01_sink``)."""
    seg = rf * n_ls + ls
    qty = qty.to(torch.float32)
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    rows = [K.segment_sum(v, seg, n_groups, mask)
            for v in (qty, price, disc_price, charge, disc)]
    # counts stay int32: a float32 count saturates at 2^24 rows a group
    return torch.stack(rows), K.segment_count(seg, n_groups, mask)


def _q01_core(n_groups, n_ls, ship, rf, ls, qty, price, disc, tax, delta):
    return _q01_fold(n_groups, n_ls, rf, ls, qty, price, disc, tax,
                     ship <= delta)


def _args_q01(tables: Tables, delta_date: str = "1998-09-02"):
    li = _ct(tables, "lineitem")
    n_ls = len(li.dicts["l_linestatus"])
    n_groups = len(li.dicts["l_returnflag"]) * n_ls
    return (n_groups, n_ls, li["l_shipdate"], li["l_returnflag"],
            li["l_linestatus"], li["l_quantity"], li["l_extendedprice"],
            li["l_discount"], li["l_tax"], date_to_int(delta_date))


def cq01(tables: Tables, delta_date: str = "1998-09-02"):
    """Pricing summary report: one segment-reduction pass over lineitem."""
    li = _ct(tables, "lineitem")
    n_ls = len(li.dicts["l_linestatus"])
    n_groups = len(li.dicts["l_returnflag"]) * n_ls
    sums, counts = _q01_core(*_args_q01(tables, delta_date))
    sums, counts = _host(sums), _host(counts)
    names = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "sum_disc")
    out = []
    for g in range(n_groups):
        cnt = int(counts[g])
        if cnt == 0:
            continue
        key = (li.decode("l_returnflag", g // n_ls),
               li.decode("l_linestatus", g % n_ls))
        v = {names[i]: float(sums[i, g]) for i in range(5)}
        v["count"] = cnt
        v["avg_qty"] = v["sum_qty"] / cnt
        v["avg_price"] = v["sum_base_price"] / cnt
        v["avg_disc"] = v["sum_disc"] / cnt
        out.append((key, v))
    out.sort(key=lambda kv: kv[0])
    return out


# ---------------------------------------------------------------- Q02
def _q02_core(jp_part, jp_sup, jp_nat, jp_reg,
              p_key, p_size, p_type, ps_part, ps_supp, ps_cost,
              s_key, s_nat, r_key, r_name, n_key, n_reg,
              type_ok, size, region_code):
    n_part = jp_part.key_space
    part_ok = (p_size == size) & K.take(type_ok, p_type)
    # partsupp ⋈ part, restricted to the qualifying parts
    _, phit = K.pk_fk_join(p_key, ps_part, part_ok, plan=jp_part)
    # supplier ⋈ nation ⋈ region, on the supplier side; nation columns
    # come through the join's row index
    nidx, nhit = K.pk_fk_join(n_key, s_nat, plan=jp_nat)
    sup_region = K.take(n_reg, nidx)
    ridx, rhit = K.pk_fk_join(r_key, sup_region, plan=jp_reg)
    in_region = nhit & rhit & (K.take(r_name, ridx) == region_code)
    # partsupp ⋈ supplier
    sidx, shit = K.pk_fk_join(s_key, ps_supp, in_region, plan=jp_sup)
    valid = phit & shit
    # min cost per part, then the first row reaching it
    cost_min = K.segment_min(ps_cost, ps_part, n_part, valid)
    at_min = valid & (ps_cost == K.take(cost_min, ps_part))
    n_ps = ps_part.shape[0]
    rows = torch.arange(n_ps, dtype=torch.int32, device=ps_part.device)
    winner = K.segment_min(rows, ps_part, n_part, at_min)
    has = winner < _I32_MAX
    winner_c = winner.clamp(0, max(n_ps - 1, 0))
    # parts that do not qualify hold zeros
    sup_row = torch.where(has, K.take(sidx, winner_c), 0)
    nat_row = torch.where(has, K.take(nidx, sup_row), 0)
    ints = torch.stack([has.to(torch.int32), sup_row, nat_row])
    return ints, cost_min


def _args_q02(tables: Tables, size: int = 15, type_suffix: str = "BRUSHED",
              region: str = "EUROPE"):
    part, ps = _ct(tables, "part"), _ct(tables, "partsupp")
    sup, nat, reg = (_ct(tables, "supplier"), _ct(tables, "nation"),
                     _ct(tables, "region"))
    type_ok = _lut(part.dicts["p_type"], lambda s: s.endswith(type_suffix),
                   part.device)
    return (P.plan_join(part, "p_partkey", ps, "ps_partkey"),
            P.plan_join(sup, "s_suppkey", ps, "ps_suppkey"),
            P.plan_join(nat, "n_nationkey", sup, "s_nationkey"),
            P.plan_join(reg, "r_regionkey", nat, "n_regionkey"),
            part["p_partkey"], part["p_size"], part["p_type"],
            ps["ps_partkey"], ps["ps_suppkey"], ps["ps_supplycost"],
            sup["s_suppkey"], sup["s_nationkey"],
            reg["r_regionkey"], reg["r_name"],
            nat["n_nationkey"], nat["n_regionkey"],
            type_ok, size, reg.code("r_name", region))


def cq02(tables: Tables, size: int = 15, type_suffix: str = "BRUSHED",
         region: str = "EUROPE"):
    """Minimum-cost supplier per qualifying part."""
    sup, nat = _ct(tables, "supplier"), _ct(tables, "nation")
    ints, cost_min = _q02_core(*_args_q02(tables, size, type_suffix, region))
    ints, cost_min = _host(ints), _host(cost_min)
    s_names = _host(sup["s_name"])
    n_names = _host(nat["n_name"])
    out = []
    for pk in np.nonzero(ints[0])[0]:
        pk = int(pk)
        out.append((pk, {"partkey": pk, "cost": float(cost_min[pk]),
                         "s_name": sup.decode(
                             "s_name", int(s_names[ints[1, pk]])),
                         "n_name": nat.decode(
                             "n_name", int(n_names[ints[2, pk]]))}))
    return out


# ---------------------------------------------------------------- Q03
def _q03_core(jp_orders, k, jp_cust, c_key, c_seg, o_key, o_cust, o_date,
              l_okey, l_ship, l_price, l_disc, seg_code, d):
    n_orders = jp_orders.key_space
    cust_ok = c_seg == seg_code
    _, chit = K.pk_fk_join(c_key, o_cust, cust_ok, plan=jp_cust)
    order_ok = chit & (o_date < d)
    oidx, ohit = K.pk_fk_join(o_key, l_okey, order_ok, plan=jp_orders)
    li_ok = ohit & (l_ship > d)
    rev = K.segment_sum(l_price * (1.0 - l_disc), l_okey, n_orders, li_ok)
    odate_per_order = K.segment_min(K.take(o_date, oidx), l_okey, n_orders,
                                    li_ok)
    top_idx, top_ok = K.top_k_masked(rev, k, rev > 0)
    ints = torch.stack([top_idx, top_ok.to(torch.int32),
                        K.take(odate_per_order, top_idx)])
    return ints, K.take(rev, top_idx)


def _args_q03(tables: Tables, segment: str = "BUILDING",
              date: str = "1995-03-15", k: int = 10):
    cust, orders, li = (_ct(tables, "customer"), _ct(tables, "orders"),
                        _ct(tables, "lineitem"))
    return (P.plan_join(orders, "o_orderkey", li, "l_orderkey"), k,
            P.plan_join(cust, "c_custkey", orders, "o_custkey"),
            cust["c_custkey"],
            cust["c_mktsegment"], orders["o_orderkey"], orders["o_custkey"],
            orders["o_orderdate"], li["l_orderkey"], li["l_shipdate"],
            li["l_extendedprice"], li["l_discount"],
            cust.code("c_mktsegment", segment), date_to_int(date))


def cq03(tables: Tables, segment: str = "BUILDING",
         date: str = "1995-03-15", k: int = 10):
    """Top unshipped orders by revenue."""
    ints, rev = _q03_core(*_args_q03(tables, segment, date, k))
    ints, rev = _host(ints), _host(rev)
    rows = [{"okey": int(ints[0, j]), "odate": int_to_date(int(ints[2, j])),
             "revenue": float(rev[j])}
            for j in range(ints.shape[1]) if ints[1, j]]
    rows.sort(key=lambda r: (-r["revenue"], r["odate"]))
    return rows


# ---------------------------------------------------------------- Q04
def _q04_core(n_pri, jp_li, o_key, o_date, o_pri, l_okey, l_commit,
              l_receipt, a, b):
    late = l_commit < l_receipt
    has_late = K.member(l_okey, o_key, late, plan=jp_li)
    in_q = (o_date >= a) & (o_date < b)
    return K.segment_count(o_pri, n_pri, has_late & in_q)


def _args_q04(tables: Tables, d0: str = "1993-07-01",
              d1: str = "1993-10-01"):
    orders, li = _ct(tables, "orders"), _ct(tables, "lineitem")
    n_pri = len(orders.dicts["o_orderpriority"])
    return (n_pri, P.plan_join(li, "l_orderkey", orders, "o_orderkey"),
            orders["o_orderkey"], orders["o_orderdate"],
            orders["o_orderpriority"], li["l_orderkey"], li["l_commitdate"],
            li["l_receiptdate"], date_to_int(d0), date_to_int(d1))


def cq04(tables: Tables, d0: str = "1993-07-01", d1: str = "1993-10-01"):
    """Orders with at least one late lineitem, counted per priority."""
    orders = _ct(tables, "orders")
    n_pri = len(orders.dicts["o_orderpriority"])
    counts = _host(_q04_core(*_args_q04(tables, d0, d1)))
    out = [(orders.decode("o_orderpriority", i), int(counts[i]))
           for i in range(n_pri) if counts[i]]
    out.sort(key=lambda kv: kv[0])
    return out


# ---------------------------------------------------------------- Q06
def _q06_core(ship, discount, quantity, price, a, b, disc, qty):
    # the reference traces disc: its bounds are float32 arithmetic
    lo = _f32(np.float32(disc) - np.float32(0.011))
    hi = _f32(np.float32(disc) + np.float32(0.011))
    mask = ((ship >= a) & (ship < b) & (discount >= lo) & (discount <= hi)
            & (quantity < qty))
    return torch.where(mask, price * discount, 0.0).sum()


def _args_q06(tables: Tables, d0: str = "1994-01-01",
              d1: str = "1995-01-01", disc: float = 0.06, qty: int = 24):
    li = _ct(tables, "lineitem")
    return (li["l_shipdate"], li["l_discount"],
            li["l_quantity"], li["l_extendedprice"],
            date_to_int(d0), date_to_int(d1), disc, qty)


def cq06(tables: Tables, d0: str = "1994-01-01", d1: str = "1995-01-01",
         disc: float = 0.06, qty: int = 24):
    """Revenue-change forecast: one filtered reduction."""
    rev = float(_q06_core(*_args_q06(tables, d0, d1, disc, qty)))
    return [("revenue", rev)]


# ---------------------------------------------------------------- Q12
def _q12_core(n_modes, jp_orders, o_key, o_pri, l_okey, l_mode, l_ship,
              l_commit, l_receipt, hi_lut, m1, m2, a, b):
    mask = (((l_mode == m1) | (l_mode == m2))
            & (l_commit < l_receipt) & (l_ship < l_commit)
            & (l_receipt >= a) & (l_receipt < b))
    oidx, ohit = K.pk_fk_join(o_key, l_okey, plan=jp_orders)
    mask = mask & ohit
    high = K.take(hi_lut, K.take(o_pri, oidx))
    return torch.stack([K.segment_count(l_mode, n_modes, mask & high),
                        K.segment_count(l_mode, n_modes, mask & ~high)])


def _args_q12(tables: Tables, mode1: str = "MAIL", mode2: str = "SHIP",
              d0: str = "1994-01-01", d1: str = "1995-01-01"):
    orders, li = _ct(tables, "orders"), _ct(tables, "lineitem")
    n_modes = len(li.dicts["l_shipmode"])
    m1, m2 = li.code("l_shipmode", mode1), li.code("l_shipmode", mode2)
    hi = _lut(orders.dicts["o_orderpriority"],
              lambda s: s in ("1-URGENT", "2-HIGH"), orders.device)
    return (n_modes, P.plan_join(orders, "o_orderkey", li, "l_orderkey"),
            orders["o_orderkey"], orders["o_orderpriority"],
            li["l_orderkey"], li["l_shipmode"], li["l_shipdate"],
            li["l_commitdate"], li["l_receiptdate"], hi, m1, m2,
            date_to_int(d0), date_to_int(d1))


def cq12(tables: Tables, mode1: str = "MAIL", mode2: str = "SHIP",
         d0: str = "1994-01-01", d1: str = "1995-01-01"):
    """High- and low-priority lineitems per ship mode."""
    li = _ct(tables, "lineitem")
    m1, m2 = li.code("l_shipmode", mode1), li.code("l_shipmode", mode2)
    packed = _host(_q12_core(*_args_q12(tables, mode1, mode2, d0, d1)))
    out = [(li.decode("l_shipmode", m),
            {"high": int(packed[0, m]), "low": int(packed[1, m])})
           for m in (m1, m2)
           if m >= 0 and packed[0, m] + packed[1, m] > 0]
    out.sort(key=lambda kv: kv[0])
    return out


# ---------------------------------------------------------------- Q13
# Static histogram domain: per-customer order counts stay far below this
# at any dbgen scale; a count at or over it is caught and recounted
# exactly on the host.
_Q13_CAP = 256


def _q13_core(n_cust, cap, o_cust, keep, c_key):
    counts = K.segment_count(o_cust, n_cust, keep)
    per_cust = K.take(counts, c_key)
    hist = K.bincount_masked(torch.clamp(per_cust, max=cap - 1), cap)
    maxc = (per_cust.max().clamp(min=0) if per_cust.numel()
            else torch.zeros((), dtype=torch.int32, device=c_key.device))
    return hist, maxc


def _q13_per_cust(n_cust, o_cust, keep, c_key):
    return K.take(K.segment_count(o_cust, n_cust, keep), c_key)


def _q13_keep(tables: Tables, word1: str, word2: str) -> torch.Tensor:
    orders = _ct(tables, "orders")
    if "o_comment" in orders.dicts:
        pat = re.compile(f"{re.escape(word1)}.*{re.escape(word2)}")
        keep_lut = _lut(orders.dicts["o_comment"],
                        lambda s: not pat.search(s), orders.device)
        return K.take(keep_lut, orders["o_comment"])
    return torch.ones((orders.num_rows,), dtype=torch.bool,
                      device=orders.device)


def _args_q13(tables: Tables, word1: str = "special",
              word2: str = "requests"):
    cust, orders = _ct(tables, "customer"), _ct(tables, "orders")
    return (key_space(cust, "c_custkey"), _Q13_CAP, orders["o_custkey"],
            _q13_keep(tables, word1, word2), cust["c_custkey"])


def cq13(tables: Tables, word1: str = "special", word2: str = "requests"):
    """Histogram of per-customer order counts, zero included (the
    left-outer-join semantics)."""
    args = _args_q13(tables, word1, word2)
    hist, maxc = _q13_core(*args)
    hist, maxc = _host(hist), int(maxc)
    if maxc >= _Q13_CAP:  # beyond any dbgen shape: exact host recount
        n_cust, _, o_cust, keep, c_key = args
        per = _host(_q13_per_cust(n_cust, o_cust, keep, c_key))
        hist = np.bincount(per, minlength=maxc + 1)
    return [(i, int(hist[i])) for i in range(maxc + 1) if hist[i]]


# ---------------------------------------------------------------- Q14
def _q14_core(jp_part, p_key, p_type, l_part, l_ship, l_price, l_disc,
              promo_lut, a, b):
    mask = (l_ship >= a) & (l_ship < b)
    pidx, phit = K.pk_fk_join(p_key, l_part, plan=jp_part)
    mask = mask & phit
    rev = torch.where(mask, l_price * (1.0 - l_disc), 0.0)
    is_promo = K.take(promo_lut, K.take(p_type, pidx))
    return torch.stack([torch.where(is_promo, rev, 0.0).sum(), rev.sum()])


def _args_q14(tables: Tables, d0: str = "1995-09-01",
              d1: str = "1995-10-01"):
    li, part = _ct(tables, "lineitem"), _ct(tables, "part")
    promo = _lut(part.dicts["p_type"], lambda s: s.startswith("PROMO"),
                 part.device)
    return (P.plan_join(part, "p_partkey", li, "l_partkey"),
            part["p_partkey"], part["p_type"], li["l_partkey"],
            li["l_shipdate"], li["l_extendedprice"], li["l_discount"],
            promo, date_to_int(d0), date_to_int(d1))


def cq14(tables: Tables, d0: str = "1995-09-01", d1: str = "1995-10-01"):
    """Percentage of revenue from promo parts."""
    pr, total = _host(_q14_core(*_args_q14(tables, d0, d1)))
    pct = 100.0 * float(pr) / float(total) if total else 0.0
    return [("promo_revenue_pct", pct)]


# ---------------------------------------------------------------- Q17
def _q17_core(jp_part, p_key, p_brand, p_cont, l_part, l_qty, l_price,
              brand_code, cont_code):
    part_ok = (p_brand == brand_code) & (p_cont == cont_code)
    _, phit = K.pk_fk_join(p_key, l_part, part_ok, plan=jp_part)
    qty = l_qty.to(torch.float32)
    avg = K.segment_mean(qty, l_part, jp_part.key_space, phit)
    small = phit & (qty < 0.2 * K.take(avg, l_part))
    return torch.where(small, l_price, 0.0).sum() / 7.0


def _args_q17(tables: Tables, brand: str = "Brand#23",
              container: str = "MED BOX"):
    li, part = _ct(tables, "lineitem"), _ct(tables, "part")
    return (P.plan_join(part, "p_partkey", li, "l_partkey"),
            part["p_partkey"],
            part["p_brand"], part["p_container"], li["l_partkey"],
            li["l_quantity"], li["l_extendedprice"],
            part.code("p_brand", brand),
            part.code("p_container", container))


def cq17(tables: Tables, brand: str = "Brand#23", container: str = "MED BOX"):
    """Revenue from small-quantity orders of one brand and container."""
    total = float(_q17_core(*_args_q17(tables, brand, container)))
    return [("avg_yearly", total)] if total else []


# ---------------------------------------------------------------- Q22
def _q22_core(n_pref, jp_cust, c_key, c_phone, c_bal, o_cust, code_lut):
    pref = K.take(code_lut, c_phone)
    in_pref = pref >= 0
    pos = in_pref & (c_bal > 0)
    avg = (torch.where(pos, c_bal, 0.0).sum()
           / pos.to(torch.int32).sum().clamp(min=1))
    rich = in_pref & (c_bal > avg)
    has_orders = K.member(o_cust, c_key, plan=jp_cust)
    sel = rich & ~has_orders
    seg = pref.clamp(0, n_pref - 1)
    return torch.stack([
        K.segment_count(seg, n_pref, sel).to(torch.float32),
        K.segment_sum(c_bal, seg, n_pref, sel)])


def q22_code_lut(phone_dict: List[str], prefixes: Sequence[str],
                 device=None) -> Tuple[List[str], torch.Tensor]:
    """Phone dictionary → prefix-group code LUT on ``device`` (CUDA
    unless asked; -1 = no group)."""
    pref_list = sorted(set(prefixes))
    pref_idx = {p: i for i, p in enumerate(pref_list)}
    lut = np.fromiter((pref_idx.get(s[:2], -1) for s in phone_dict),
                      np.int32, len(phone_dict))
    return pref_list, _upload(lut, resolve_device(device))


def _args_q22(tables: Tables,
              prefixes: Sequence[str] = ("13", "31", "23", "29", "30",
                                         "18", "17")):
    cust, orders = _ct(tables, "customer"), _ct(tables, "orders")
    pref_list, code_lut = q22_code_lut(cust.dicts["c_phone"], prefixes,
                                       cust.device)
    return (len(pref_list),
            P.plan_join(orders, "o_custkey", cust, "c_custkey"),
            cust["c_custkey"], cust["c_phone"],
            cust["c_acctbal"], orders["o_custkey"], code_lut)


def cq22(tables: Tables,
         prefixes: Tuple[str, ...] = ("13", "31", "23", "29", "30", "18",
                                      "17")):
    """Well-funded customers with no orders, grouped by phone prefix."""
    pref_list = sorted(set(prefixes))
    packed = _host(_q22_core(*_args_q22(tables, prefixes)))
    return [(pref_list[i], {"n": int(packed[0, i]),
                            "bal": float(packed[1, i])})
            for i in range(len(pref_list)) if packed[0, i]]


COLUMNAR_QUERIES: Dict[str, Callable] = {
    "q01": cq01, "q02": cq02, "q03": cq03, "q04": cq04, "q06": cq06,
    "q12": cq12, "q13": cq13, "q14": cq14, "q17": cq17, "q22": cq22,
}


def tables_from_rows(data: Dict[str, List[dict]], device=None) -> Tables:
    """Column tables on ``device`` (CUDA unless asked) from the row dicts
    of a TPC-H generator, with their statistics collected on the host at
    ingest."""
    return {name: ColumnTable.from_rows(rows, device=device)
            for name, rows in data.items() if rows}


# ------------------------------------------------------- the suite
_SUITE_CORES: Dict[str, Tuple[Callable, Callable]] = {
    "q01": (_q01_core, _args_q01), "q02": (_q02_core, _args_q02),
    "q03": (_q03_core, _args_q03), "q04": (_q04_core, _args_q04),
    "q06": (_q06_core, _args_q06), "q12": (_q12_core, _args_q12),
    "q13": (_q13_core, _args_q13), "q14": (_q14_core, _args_q14),
    "q17": (_q17_core, _args_q17), "q22": (_q22_core, _args_q22),
}

_SLOT = object()  # placeholder for a tensor in an argument template


def suite_args_split(tables: Tables):
    """Every core's arguments split into templates (statics, with
    ``_SLOT`` where a tensor goes) and the tensors themselves."""
    templates: Dict[str, list] = {}
    arrays: Dict[str, list] = {}
    for name, (_core, args_fn) in _SUITE_CORES.items():
        t, arr = [], []
        for a in args_fn(tables):
            if isinstance(a, torch.Tensor):
                t.append(_SLOT)
                arr.append(a)
            else:
                t.append(a)
        templates[name] = t
        arrays[name] = arr
    return templates, arrays


def compile_suite(tables: Tables) -> Callable[[], Dict[str, object]]:
    """The ten-query suite as one callable: each call runs the ten
    cores in turn and returns ``{name: raw core output}``. The plans and
    arguments are fixed once here, and, as the reference fuses the suite
    into one jitted program, the ten cores are one program of the
    executor's compiled-program cache (one CUDA graph on the card, the
    tables' columns read in place)."""
    from netsdb_tpu_torch.plan.executor import run_program

    templates, arrays = suite_args_split(tables)

    def cores(arrays):
        out = {}
        for name, t in templates.items():
            it = iter(arrays[name])
            rebuilt = [next(it) if x is _SLOT else x for x in t]
            out[name] = _SUITE_CORES[name][0](*rebuilt)
        return out

    def runner():
        return run_program("suite::tpch", cores, arrays, ref_args=(0,))

    runner.arrays = arrays
    runner.templates = templates
    return runner
