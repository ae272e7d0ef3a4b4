"""TPC-H over host records — counterpart of
``netsdb_tpu/workloads/tpch.py``.

The reference's queries 01/02/03/04/06/12/13/14/17/22
(``src/tpch/source/Query*/``) as Computation DAGs over object sets of
row dicts: Scan → Filter → Join → Aggregate → Write on the executor's
host-record path, the same DAGs node for node. Dates are ISO strings
(range predicates are string compares). ``generate()`` makes a seeded
micro-instance of the eight tables; ``parse_tbl``/``load_tbl_dir`` read
dbgen ``.tbl`` files into row dicts, and ``parse_tbl_columnar``/
``load_tbl_dir_columnar`` into numpy columns (the native parser,
``native/tblparse.cpp``, when it builds) and column tables.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List

from netsdb_tpu_torch.plan.computations import (
    Aggregate, Apply, Filter, Join, ScanSet, WriteSet,
)

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_MODES = ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL", "FOB", "REG AIR"]
_BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
_CONTAINERS = ["SM CASE", "MED BOX", "LG JAR", "WRAP PACK", "JUMBO PKG"]
_TYPES = ["PROMO BURNISHED", "STANDARD POLISHED", "ECONOMY ANODIZED",
          "PROMO PLATED", "MEDIUM BRUSHED"]
_FLAGS = [("R", "F"), ("A", "F"), ("N", "O")]


def _date(rng, y0=1992, y1=1998) -> str:
    return f"{rng.randint(y0, y1):04d}-{rng.randint(1, 12):02d}-{rng.randint(1, 28):02d}"


def generate(scale: int = 1, seed: int = 0) -> Dict[str, List[Dict[str, Any]]]:
    """Micro TPC-H instance: ~scale x (5 regions, 10 nations, 20 suppliers,
    50 customers, 40 parts, 80 partsupps, 150 orders, ~450 lineitems)."""
    rng = random.Random(seed)
    region = [{"r_regionkey": i, "r_name": n}
              for i, n in enumerate(["AFRICA", "AMERICA", "ASIA", "EUROPE",
                                     "MIDDLE EAST"])]
    nation = [{"n_nationkey": i, "n_name": f"NATION{i}",
               "n_regionkey": i % 5} for i in range(10)]
    supplier = [{"s_suppkey": i, "s_name": f"Supplier{i}",
                 "s_nationkey": rng.randrange(10),
                 "s_acctbal": round(rng.uniform(-999, 9999), 2)}
                for i in range(20 * scale)]
    customer = [{"c_custkey": i, "c_name": f"Customer{i}",
                 "c_nationkey": rng.randrange(10),
                 "c_mktsegment": rng.choice(_SEGMENTS),
                 "c_acctbal": round(rng.uniform(-999, 9999), 2),
                 "c_phone": f"{rng.randint(10, 34)}-{rng.randint(100, 999)}-{rng.randint(1000, 9999)}"}
                for i in range(50 * scale)]
    part = [{"p_partkey": i, "p_name": f"part {i}",
             "p_brand": rng.choice(_BRANDS), "p_type": rng.choice(_TYPES),
             "p_size": rng.randint(1, 50),
             "p_container": rng.choice(_CONTAINERS),
             "p_retailprice": round(rng.uniform(900, 2000), 2)}
            for i in range(40 * scale)]
    partsupp = [{"ps_partkey": rng.randrange(40 * scale),
                 "ps_suppkey": rng.randrange(20 * scale),
                 "ps_supplycost": round(rng.uniform(1, 1000), 2),
                 "ps_availqty": rng.randint(1, 9999)}
                for _ in range(80 * scale)]
    comment_words = ["express", "special", "pending", "requests", "deposits",
                     "accounts", "packages", "final"]
    orders, lineitem = [], []
    for okey in range(150 * scale):
        ckey = rng.randrange(50 * scale)
        odate = _date(rng)
        orders.append({"o_orderkey": okey, "o_custkey": ckey,
                       "o_orderdate": odate,
                       "o_orderpriority": rng.choice(_PRIORITIES),
                       "o_shippriority": 0,
                       "o_totalprice": 0.0,
                       "o_comment": " ".join(rng.choices(comment_words, k=4))})
        for _ in range(rng.randint(1, 5)):
            rf, ls = rng.choice(_FLAGS)
            ship = _date(rng)
            commit = _date(rng)
            receipt = _date(rng)
            lineitem.append({
                "l_orderkey": okey,
                "l_partkey": rng.randrange(40 * scale),
                "l_suppkey": rng.randrange(20 * scale),
                "l_quantity": rng.randint(1, 50),
                "l_extendedprice": round(rng.uniform(1000, 100000), 2),
                "l_discount": round(rng.uniform(0.0, 0.1), 2),
                "l_tax": round(rng.uniform(0.0, 0.08), 2),
                "l_returnflag": rf, "l_linestatus": ls,
                "l_shipdate": ship, "l_commitdate": commit,
                "l_receiptdate": receipt,
                "l_shipmode": rng.choice(_MODES),
            })
    return {"region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "part": part, "partsupp": partsupp,
            "orders": orders, "lineitem": lineitem}


# dbgen column layouts (official TPC-H spec order) — the reference's
# ``tpchDataLoader.cc`` parses the same pipe-separated .tbl files.
# (name, type) with type in {int, float, str}.
_TBL_SCHEMAS: Dict[str, List[tuple]] = {
    "region": [("r_regionkey", int), ("r_name", str), ("r_comment", str)],
    "nation": [("n_nationkey", int), ("n_name", str),
               ("n_regionkey", int), ("n_comment", str)],
    "supplier": [("s_suppkey", int), ("s_name", str), ("s_address", str),
                 ("s_nationkey", int), ("s_phone", str),
                 ("s_acctbal", float), ("s_comment", str)],
    "customer": [("c_custkey", int), ("c_name", str), ("c_address", str),
                 ("c_nationkey", int), ("c_phone", str),
                 ("c_acctbal", float), ("c_mktsegment", str),
                 ("c_comment", str)],
    "part": [("p_partkey", int), ("p_name", str), ("p_mfgr", str),
             ("p_brand", str), ("p_type", str), ("p_size", int),
             ("p_container", str), ("p_retailprice", float),
             ("p_comment", str)],
    "partsupp": [("ps_partkey", int), ("ps_suppkey", int),
                 ("ps_availqty", int), ("ps_supplycost", float),
                 ("ps_comment", str)],
    "orders": [("o_orderkey", int), ("o_custkey", int),
               ("o_orderstatus", str), ("o_totalprice", float),
               ("o_orderdate", str), ("o_orderpriority", str),
               ("o_clerk", str), ("o_shippriority", int),
               ("o_comment", str)],
    "lineitem": [("l_orderkey", int), ("l_partkey", int),
                 ("l_suppkey", int), ("l_linenumber", int),
                 ("l_quantity", float), ("l_extendedprice", float),
                 ("l_discount", float), ("l_tax", float),
                 ("l_returnflag", str), ("l_linestatus", str),
                 ("l_shipdate", str), ("l_commitdate", str),
                 ("l_receiptdate", str), ("l_shipinstruct", str),
                 ("l_shipmode", str), ("l_comment", str)],
}


def write_tbl_dir(tables: Dict[str, List[Dict[str, Any]]],
                  directory: str) -> Dict[str, str]:
    """Write row dicts (e.g. :func:`generate`'s) as dbgen ``.tbl`` files:
    the fields of ``_TBL_SCHEMAS`` order, pipe-separated with dbgen's
    trailing pipe; a field a row lacks is written as its type's zero
    (0, 0.0, empty). Floats round-trip exactly (``repr``). Returns
    {table: path}."""
    import os

    os.makedirs(directory, exist_ok=True)
    zero = {int: 0, float: 0.0, str: ""}
    paths = {}
    for table, rows in tables.items():
        schema = _TBL_SCHEMAS[table]
        path = os.path.join(directory, f"{table}.tbl")
        with open(path, "w") as f:
            for r in rows:
                f.write("|".join(repr(typ(r.get(n, zero[typ])))
                                 if typ is float else
                                 str(typ(r.get(n, zero[typ])))
                                 for n, typ in schema) + "|\n")
        paths[table] = path
    return paths


def parse_tbl(path: str, table: str) -> List[Dict[str, Any]]:
    """Parse one dbgen ``.tbl`` file (pipe-separated, trailing pipe) into
    row dicts — ``tpchDataLoader.cc``'s per-table parse loop."""
    schema = _TBL_SCHEMAS.get(table)
    if schema is None:
        raise ValueError(f"unknown TPC-H table {table!r}; "
                         f"one of {sorted(_TBL_SCHEMAS)}")
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\r\n")
            if not line:
                continue
            fields = line.split("|")
            if fields and fields[-1] == "":
                fields.pop()  # dbgen's trailing delimiter
            if len(fields) != len(schema):
                raise ValueError(
                    f"{path}:{lineno}: expected {len(schema)} fields for "
                    f"{table}, got {len(fields)}")
            rows.append({name: typ(val)
                         for (name, typ), val in zip(schema, fields)})
    return rows


def parse_tbl_columnar(path: str, table: str):
    """Columnar parse → {column: numpy array}. Uses the native C++
    parser (``native/tblparse.cpp``) when available — the reference's
    C++ loader role, an order of magnitude faster than row dicts — and
    falls back to transposing the Python row parser."""
    schema = _TBL_SCHEMAS.get(table)
    if schema is None:
        raise ValueError(f"unknown TPC-H table {table!r}; "
                         f"one of {sorted(_TBL_SCHEMAS)}")
    from netsdb_tpu_torch.native import tblparse

    cols = tblparse.parse_columnar(path, schema)
    if cols is not None:
        return cols
    import numpy as np

    rows = parse_tbl(path, table)
    return {name: np.array([r[name] for r in rows],
                           dtype=(np.int64 if typ is int else
                                  np.float64 if typ is float else object))
            for name, typ in schema}


def load_tbl_dir(client, directory: str, db: str = "tpch",
                 tables=None) -> Dict[str, int]:
    """Load a dbgen output directory (``<table>.tbl`` files) — the
    reference's data-loading workflow (``README.md:216-256``:
    dbgen then tpchDataLoader), each table into an object set of host
    records. Returns {table: row count}."""
    import os

    counts = {}
    client.create_database(db)
    for table in (tables or sorted(_TBL_SCHEMAS)):
        path = os.path.join(directory, f"{table}.tbl")
        if not os.path.exists(path):
            continue
        rows = parse_tbl(path, table)
        if not client.set_exists(db, table):
            client.create_set(db, table, type_name="object")
        client.clear_set(db, table)
        client.send_data(db, table, rows)
        counts[table] = len(rows)
    return counts


def load_tbl_dir_columnar(client, directory: str, db: str = "tpch",
                          tables=None) -> Dict[str, int]:
    """Columnar dbgen ingestion: ``<table>.tbl`` → one ColumnTable per
    set on the client's device (native parser fast path), the input
    format of the device relational engine
    (:mod:`netsdb_tpu_torch.relational`). Returns {table: row count}."""
    import os

    from netsdb_tpu_torch.relational.table import ColumnTable

    date_cols = {"o_orderdate", "l_shipdate", "l_commitdate",
                 "l_receiptdate"}
    counts = {}
    client.create_database(db)
    for table in (tables or sorted(_TBL_SCHEMAS)):
        path = os.path.join(directory, f"{table}.tbl")
        if not os.path.exists(path):
            continue
        cols = parse_tbl_columnar(path, table)
        ct = ColumnTable.from_columns(cols, date_cols=date_cols,
                                      device=client.device)
        set_name = f"{table}_columnar"
        if not client.set_exists(db, set_name):
            client.create_set(db, set_name, type_name="columnar")
        client.clear_set(db, set_name)
        client.send_data(db, set_name, [ct])
        counts[table] = ct.num_rows
    return counts


def load_tables(client, db: str = "tpch", tables=None, scale: int = 1,
                seed: int = 0) -> None:
    """``tpchDataLoader`` analogue."""
    tables = tables or generate(scale, seed)
    client.create_database(db)
    for name, rows in tables.items():
        if not client.set_exists(db, name):
            client.create_set(db, name, type_name="object")
        client.clear_set(db, name)
        client.send_data(db, name, rows)


def _dict_to_rows():
    return lambda d: sorted(d.items())


# ---------------------------------------------------------------- Q01
def q01(db: str = "tpch", delta_date: str = "1998-09-02") -> WriteSet:
    """Pricing summary report (ref ``src/tpch/source/Query01``): filter
    shipdate, group by (returnflag, linestatus), sum qty/price/disc
    price/charge + counts."""
    li = Filter(ScanSet(db, "lineitem"),
                lambda l: l["l_shipdate"] <= delta_date, label="shipdate<=d")

    def value(l):
        disc_price = l["l_extendedprice"] * (1 - l["l_discount"])
        return {"sum_qty": l["l_quantity"],
                "sum_base_price": l["l_extendedprice"],
                "sum_disc_price": disc_price,
                "sum_charge": disc_price * (1 + l["l_tax"]),
                "sum_disc": l["l_discount"], "count": 1}

    def combine(a, b):
        return {k: a[k] + b[k] for k in a}

    agg = Aggregate(li, key=lambda l: (l["l_returnflag"], l["l_linestatus"]),
                    value=value, combine=combine, label="Q01Agg")

    def finalize(d):
        out = []
        for k, v in sorted(d.items()):
            v = dict(v)
            v["avg_qty"] = v["sum_qty"] / v["count"]
            v["avg_price"] = v["sum_base_price"] / v["count"]
            v["avg_disc"] = v["sum_disc"] / v["count"]
            out.append((k, v))
        return out

    return WriteSet(Apply(agg, finalize, label="Q01Finalize"), db, "q01_out")


# ---------------------------------------------------------------- Q02
def q02(db: str = "tpch", size: int = 15, type_suffix: str = "BRUSHED",
        region: str = "EUROPE") -> WriteSet:
    """Minimum-cost supplier (ref ``Query02``): parts of a size/type in a
    region, suppliers achieving the min supplycost."""
    nr = Join(Filter(ScanSet(db, "region"), lambda r: r["r_name"] == region,
                     label="region"),
              ScanSet(db, "nation"),
              left_key=lambda r: r["r_regionkey"],
              right_key=lambda n: n["n_regionkey"],
              project=lambda r, n: n, label="nation⋈region")
    sup = Join(nr, ScanSet(db, "supplier"),
               left_key=lambda n: n["n_nationkey"],
               right_key=lambda s: s["s_nationkey"],
               project=lambda n, s: {**s, "n_name": n["n_name"]},
               label="supplier⋈nation")
    parts = Filter(ScanSet(db, "part"),
                   lambda p: p["p_size"] == size
                   and p["p_type"].endswith(type_suffix), label="part filter")
    ps = Join(parts, ScanSet(db, "partsupp"),
              left_key=lambda p: p["p_partkey"],
              right_key=lambda x: x["ps_partkey"],
              project=lambda p, x: {**x, "p_partkey": p["p_partkey"]},
              label="part⋈partsupp")
    full = Join(ps, sup, left_key=lambda x: x["ps_suppkey"],
                right_key=lambda s: s["s_suppkey"],
                project=lambda x, s: {"partkey": x["p_partkey"],
                                      "cost": x["ps_supplycost"],
                                      "s_name": s["s_name"],
                                      "n_name": s["n_name"]},
                label="⋈supplier")
    best = Aggregate(full, key=lambda r: r["partkey"], value=lambda r: r,
                     combine=lambda a, b: a if a["cost"] <= b["cost"] else b,
                     label="min cost per part")
    return WriteSet(Apply(best, _dict_to_rows(), label="rows"), db, "q02_out")


# ---------------------------------------------------------------- Q03
def q03(db: str = "tpch", segment: str = "BUILDING",
        date: str = "1995-03-15") -> WriteSet:
    """Shipping priority (ref ``Query03``): top unshipped orders by
    revenue."""
    cust = Filter(ScanSet(db, "customer"),
                  lambda c: c["c_mktsegment"] == segment, label="segment")
    orders = Filter(ScanSet(db, "orders"),
                    lambda o: o["o_orderdate"] < date, label="orderdate<d")
    co = Join(cust, orders, left_key=lambda c: c["c_custkey"],
              right_key=lambda o: o["o_custkey"],
              project=lambda c, o: o, label="cust⋈orders")
    li = Filter(ScanSet(db, "lineitem"), lambda l: l["l_shipdate"] > date,
                label="shipdate>d")
    col = Join(co, li, left_key=lambda o: o["o_orderkey"],
               right_key=lambda l: l["l_orderkey"],
               project=lambda o, l: {
                   "okey": o["o_orderkey"], "odate": o["o_orderdate"],
                   "rev": l["l_extendedprice"] * (1 - l["l_discount"])},
               label="⋈lineitem")
    agg = Aggregate(col, key=lambda r: (r["okey"], r["odate"]),
                    value=lambda r: r["rev"], combine=lambda a, b: a + b,
                    label="revenue per order")

    def top10(d):
        rows = [{"okey": k[0], "odate": k[1], "revenue": v}
                for k, v in d.items()]
        rows.sort(key=lambda r: (-r["revenue"], r["odate"]))
        return rows[:10]

    return WriteSet(Apply(agg, top10, label="top10"), db, "q03_out")


# ---------------------------------------------------------------- Q04
def q04(db: str = "tpch", d0: str = "1993-07-01",
        d1: str = "1993-10-01") -> WriteSet:
    """Order-priority checking (ref ``Query04``): orders in a quarter with
    at least one late lineitem, counted per priority."""
    late = Filter(ScanSet(db, "lineitem"),
                  lambda l: l["l_commitdate"] < l["l_receiptdate"],
                  label="late lineitems")
    late_keys = Aggregate(late, key=lambda l: l["l_orderkey"],
                          value=lambda l: 1, combine=lambda a, b: 1,
                          label="distinct orderkeys")
    orders = Filter(ScanSet(db, "orders"),
                    lambda o: d0 <= o["o_orderdate"] < d1, label="quarter")
    joined = Join(orders, Apply(late_keys, _dict_to_rows(), label="rows"),
                  left_key=lambda o: o["o_orderkey"],
                  right_key=lambda kv: kv[0],
                  project=lambda o, kv: o, label="semi-join")
    counts = Aggregate(joined, key=lambda o: o["o_orderpriority"],
                       value=lambda o: 1, combine=lambda a, b: a + b,
                       label="count per priority")
    return WriteSet(Apply(counts, _dict_to_rows(), label="rows"),
                    db, "q04_out")


# ---------------------------------------------------------------- Q06
def q06(db: str = "tpch", d0: str = "1994-01-01", d1: str = "1995-01-01",
        disc: float = 0.06, qty: int = 24) -> WriteSet:
    """Revenue-change forecast (ref ``Query06``): one filtered sum."""
    li = Filter(
        ScanSet(db, "lineitem"),
        lambda l: (d0 <= l["l_shipdate"] < d1
                   and disc - 0.011 <= l["l_discount"] <= disc + 0.011
                   and l["l_quantity"] < qty),
        label="Q06 filter")
    rev = Aggregate(li, key=lambda l: "revenue",
                    value=lambda l: l["l_extendedprice"] * l["l_discount"],
                    combine=lambda a, b: a + b, label="sum revenue")
    return WriteSet(Apply(rev, _dict_to_rows(), label="rows"), db, "q06_out")


# ---------------------------------------------------------------- Q12
def q12(db: str = "tpch", mode1: str = "MAIL", mode2: str = "SHIP",
        d0: str = "1994-01-01", d1: str = "1995-01-01") -> WriteSet:
    """Shipping modes & order priority (ref ``Query12``)."""
    li = Filter(
        ScanSet(db, "lineitem"),
        lambda l: (l["l_shipmode"] in (mode1, mode2)
                   and l["l_commitdate"] < l["l_receiptdate"]
                   and l["l_shipdate"] < l["l_commitdate"]
                   and d0 <= l["l_receiptdate"] < d1),
        label="Q12 filter")
    jo = Join(li, ScanSet(db, "orders"),
              left_key=lambda l: l["l_orderkey"],
              right_key=lambda o: o["o_orderkey"],
              project=lambda l, o: {"mode": l["l_shipmode"],
                                    "pri": o["o_orderpriority"]},
              label="⋈orders")

    def value(r):
        high = 1 if r["pri"] in ("1-URGENT", "2-HIGH") else 0
        return {"high": high, "low": 1 - high}

    agg = Aggregate(jo, key=lambda r: r["mode"], value=value,
                    combine=lambda a, b: {"high": a["high"] + b["high"],
                                          "low": a["low"] + b["low"]},
                    label="high/low per mode")
    return WriteSet(Apply(agg, _dict_to_rows(), label="rows"), db, "q12_out")


# ---------------------------------------------------------------- Q13
def q13(db: str = "tpch", word1: str = "special",
        word2: str = "requests") -> WriteSet:
    """Customer distribution (ref ``Query13``): histogram of per-customer
    order counts, customers with zero orders included; orders whose
    comment matches %word1%word2% are excluded."""
    import re as _re

    pat = _re.compile(f"{_re.escape(word1)}.*{_re.escape(word2)}")
    keep = Filter(ScanSet(db, "orders"),
                  lambda o: not pat.search(o.get("o_comment", "")),
                  label="comment not like %w1%w2%")
    per_cust = Aggregate(keep,
                         key=lambda o: o["o_custkey"], value=lambda o: 1,
                         combine=lambda a, b: a + b, label="orders per cust")
    custs = ScanSet(db, "customer")

    def left_outer(customers, counts):
        # customers with no orders land in the 0 bucket (left outer join)
        return [{"cust": c["c_custkey"],
                 "n": counts.get(c["c_custkey"], 0)} for c in customers]

    with_counts = Join(custs, per_cust, fn=left_outer, label="cust⟕counts")
    hist = Aggregate(with_counts, key=lambda r: r["n"], value=lambda r: 1,
                     combine=lambda a, b: a + b, label="histogram")
    return WriteSet(Apply(hist, _dict_to_rows(), label="rows"), db, "q13_out")


# ---------------------------------------------------------------- Q14
def q14(db: str = "tpch", d0: str = "1995-09-01",
        d1: str = "1995-10-01") -> WriteSet:
    """Promotion effect (ref ``Query14``): % of revenue from PROMO parts."""
    li = Filter(ScanSet(db, "lineitem"),
                lambda l: d0 <= l["l_shipdate"] < d1, label="month")
    jp = Join(li, ScanSet(db, "part"),
              left_key=lambda l: l["l_partkey"],
              right_key=lambda p: p["p_partkey"],
              project=lambda l, p: {
                  "rev": l["l_extendedprice"] * (1 - l["l_discount"]),
                  "promo": p["p_type"].startswith("PROMO")},
              label="⋈part")
    agg = Aggregate(jp, key=lambda r: "all",
                    value=lambda r: {"promo": r["rev"] if r["promo"] else 0.0,
                                     "total": r["rev"]},
                    combine=lambda a, b: {"promo": a["promo"] + b["promo"],
                                          "total": a["total"] + b["total"]},
                    label="promo/total")

    def ratio(d):
        v = d.get("all", {"promo": 0.0, "total": 0.0})
        pct = 100.0 * v["promo"] / v["total"] if v["total"] else 0.0
        return [("promo_revenue_pct", pct)]

    return WriteSet(Apply(agg, ratio, label="ratio"), db, "q14_out")


# ---------------------------------------------------------------- Q17
def q17(db: str = "tpch", brand: str = "Brand#23",
        container: str = "MED BOX") -> WriteSet:
    """Small-quantity-order revenue (ref ``Query17``): lineitems under
    20% of the part's average quantity."""
    parts = Filter(ScanSet(db, "part"),
                   lambda p: p["p_brand"] == brand
                   and p["p_container"] == container, label="brand+container")
    li_parts = Join(ScanSet(db, "lineitem"), parts,
                    left_key=lambda l: l["l_partkey"],
                    right_key=lambda p: p["p_partkey"],
                    project=lambda l, p: l, label="⋈part")
    avg_qty = Aggregate(li_parts, key=lambda l: l["l_partkey"],
                        value=lambda l: {"sum": l["l_quantity"], "n": 1},
                        combine=lambda a, b: {"sum": a["sum"] + b["sum"],
                                              "n": a["n"] + b["n"]},
                        label="avg qty per part")
    small = Join(li_parts, Apply(avg_qty, _dict_to_rows(), label="rows"),
                 left_key=lambda l: l["l_partkey"],
                 right_key=lambda kv: kv[0],
                 project=lambda l, kv: {
                     "price": l["l_extendedprice"],
                     "small": l["l_quantity"] < 0.2 * kv[1]["sum"] / kv[1]["n"]},
                 label="⋈avg")
    total = Aggregate(Filter(small, lambda r: r["small"], label="small only"),
                      key=lambda r: "avg_yearly",
                      value=lambda r: r["price"] / 7.0,
                      combine=lambda a, b: a + b, label="sum/7")
    return WriteSet(Apply(total, _dict_to_rows(), label="rows"),
                    db, "q17_out")


# ---------------------------------------------------------------- Q22
def q22(db: str = "tpch", prefixes=("13", "31", "23", "29", "30", "18", "17")
        ) -> WriteSet:
    """Global sales opportunity (ref ``Query22``): well-funded customers
    with no orders, grouped by phone prefix."""
    custs = Filter(ScanSet(db, "customer"),
                   lambda c: c["c_phone"][:2] in prefixes, label="prefix")
    # avg positive acctbal among the prefix customers
    avg = Aggregate(custs, key=lambda c: "avg",
                    value=lambda c: ({"sum": c["c_acctbal"], "n": 1}
                                     if c["c_acctbal"] > 0
                                     else {"sum": 0.0, "n": 0}),
                    combine=lambda a, b: {"sum": a["sum"] + b["sum"],
                                          "n": a["n"] + b["n"]},
                    label="avg positive acctbal")
    rich = Join(custs, Apply(avg, _dict_to_rows(), label="rows"),
                left_key=lambda c: "avg", right_key=lambda kv: kv[0],
                project=lambda c, kv: (c, kv[1]["sum"] / max(kv[1]["n"], 1)),
                label="⋈avg")
    rich = Filter(rich, lambda cv: cv[0]["c_acctbal"] > cv[1],
                  label="acctbal>avg")
    ordered_custs = Aggregate(ScanSet(db, "orders"),
                              key=lambda o: o["o_custkey"], value=lambda o: 1,
                              combine=lambda a, b: 1, label="custs w/ orders")

    def anti_join(rich_rows, ordered):
        have = set(ordered.keys())
        return [c for c, _ in rich_rows if c["c_custkey"] not in have]

    no_orders = Join(rich, ordered_custs, fn=anti_join, label="anti-join")
    byprefix = Aggregate(no_orders, key=lambda c: c["c_phone"][:2],
                         value=lambda c: {"n": 1, "bal": c["c_acctbal"]},
                         combine=lambda a, b: {"n": a["n"] + b["n"],
                                               "bal": a["bal"] + b["bal"]},
                         label="per prefix")
    return WriteSet(Apply(byprefix, _dict_to_rows(), label="rows"),
                    db, "q22_out")


QUERIES: Dict[str, Callable[..., WriteSet]] = {
    "q01": q01, "q02": q02, "q03": q03, "q04": q04, "q06": q06,
    "q12": q12, "q13": q13, "q14": q14, "q17": q17, "q22": q22,
}


def run_query(client, name: str, db: str = "tpch", **kwargs):
    """Execute one query, return its result rows."""
    sink = QUERIES[name](db=db, **kwargs)
    res = client.execute_computations(sink, job_name=f"tpch-{name}")
    return next(iter(res.values()))
