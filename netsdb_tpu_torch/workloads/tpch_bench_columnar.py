"""Columnar tpchBench on the device engine — counterpart of
``netsdb_tpu/workloads/tpch_bench_columnar.py``.

The nested Customer → Order → LineItem records columnarise at ingest:
customers as one table, the nesting flattened into a triples table
(customer, supplier, part) — what the reference's
``CustomerMultiSelection`` computes per query. Each query shape is then
a few torch ops on the tables' device:

- the int and string selections and their negations → masks;
- the group-by supplier → segment counts over (supplier, customer);
- the count → the valid rows;
- the top-k Jaccard (``TopJaccard.h:17``) → a customer × part
  membership matrix built once by a scatter-max, then per query part set
  one matrix-vector product (every intersection at once), the union by
  inclusion-exclusion and a stable descending sort, so equal scores keep
  the lower customer first, as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.queries import _upload
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.workloads.tpch_bench import Customer


# ------------------------------------------------------------- ingest
def columnarize(customers: Sequence[Customer], device=None
                ) -> Dict[str, ColumnTable]:
    """Nested customers → flat column tables on ``device`` (CUDA unless
    asked), with their statistics collected on the host."""
    segs = sorted({c.mktsegment for c in customers})
    seg_code = {s: i for i, s in enumerate(segs)}
    n = len(customers)
    cust = ColumnTable.from_columns({
        "custKey": np.fromiter((c.custKey for c in customers), np.int32, n),
        "nationKey": np.fromiter((c.nationKey for c in customers),
                                 np.int32, n),
        "mktsegment": np.fromiter((seg_code[c.mktsegment]
                                   for c in customers), np.int32, n),
        "accbal": np.fromiter((c.accbal for c in customers), np.float32, n),
    }, dicts={"mktsegment": segs}, device=device)

    sup_names = sorted({li.supplierName for c in customers
                        for o in c.orders for li in o.lineItems})
    sup_code = {s: i for i, s in enumerate(sup_names)}
    ck, sup, part = [], [], []
    for c in customers:
        for o in c.orders:
            for li in o.lineItems:
                ck.append(c.custKey)
                sup.append(sup_code[li.supplierName])
                part.append(li.partKey)
    triples = ColumnTable.from_columns({
        "custKey": np.asarray(ck, np.int32),
        "supplier": np.asarray(sup, np.int32),
        "partKey": np.asarray(part, np.int32),
    }, dicts={"supplier": sup_names}, device=device)
    return {"customers": cust, "triples": triples}


# --------------------------------------------------------- selections
def selections(tables: Dict[str, ColumnTable], threshold: int = 0,
               segment: str = "BUILDING"):
    """The four selection variants (int / string, plain / negated) as
    masks."""
    cust = tables["customers"]
    int_sel = cust["custKey"] > threshold
    str_sel = cust["mktsegment"] == cust.code("mktsegment", segment)
    return int_sel, ~int_sel, str_sel, ~str_sel


# --------------------------------------------------- group-by supplier
def group_by_supplier(tables: Dict[str, ColumnTable]):
    """``(pair counts (n_suppliers, n_customers), per-supplier
    totals)``: the fixed-shape aggregate behind ``SupplierInfo``."""
    from netsdb_tpu_torch.relational.stats import key_space

    t = tables["triples"]
    n_sup = len(t.dicts["supplier"])
    n_cust = key_space(tables["customers"], "custKey")
    pair = t["supplier"] * n_cust + t["custKey"]
    pair_counts = K.segment_count(pair, n_sup * n_cust)
    per = K.segment_count(t["supplier"], n_sup)
    return pair_counts.reshape(n_sup, n_cust), per


def count_customers(tables: Dict[str, ColumnTable]) -> int:
    return tables["customers"].num_rows


# ------------------------------------------------------ top-k jaccard
def _membership_matrix(n_cust: int, n_parts: int, custKey: torch.Tensor,
                       partKey: torch.Tensor) -> torch.Tensor:
    """(n_cust, n_parts) f32 0/1 membership, built once per request. Part
    keys are clipped into range, a negative flat index counts from the
    end and one still out of range is dropped, as the reference's
    scatter does; the scatter itself writes only in-range indices (a
    dropped row writes 0, the identity of the max, at a slot spread by
    its row number)."""
    size = n_cust * n_parts
    flat = custKey.long() * n_parts + partKey.long().clamp(0, n_parts - 1)
    flat = torch.where(flat < 0, flat + size, flat)
    ok = (flat >= 0) & (flat < size)
    rows = torch.arange(flat.shape[0], device=flat.device)
    idx = torch.where(ok, flat, rows % max(size, 1))
    m = torch.zeros(size, dtype=torch.float32, device=flat.device)
    m.scatter_reduce_(0, idx, ok.to(torch.float32), reduce="amax")
    return m.reshape(n_cust, n_parts)


def _jaccard_core(member: torch.Tensor, query_vec: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    sizes = member.sum(dim=1)
    inter = member @ query_vec  # every intersection in one product
    union = sizes + query_vec.sum() - inter
    j = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                    torch.zeros_like(inter))
    idx, _ = K.top_k_masked(j, k)
    return j.index_select(0, idx.long()), idx


def _jaccard_shape(tables: Dict[str, ColumnTable],
                   query_parts: Sequence[int]) -> Tuple[int, int]:
    from netsdb_tpu_torch.relational.stats import key_space

    n_cust = key_space(tables["customers"], "custKey")
    n_parts = max(key_space(tables["triples"], "partKey"),
                  max(query_parts, default=0) + 1)
    return n_cust, n_parts


def top_jaccard(tables: Dict[str, ColumnTable],
                query_parts: Sequence[int], k: int = 5,
                member: Optional[torch.Tensor] = None
                ) -> List[Tuple[float, int]]:
    """Top-k customers by Jaccard similarity of their part sets against
    ``query_parts``: ``[(score, custKey)]`` best first, ties by custKey
    ascending. ``member`` is the membership matrix when the caller built
    it (over a mesh)."""
    t = tables["triples"]
    n_cust, n_parts = _jaccard_shape(tables, query_parts)
    if member is None:
        member = _membership_matrix(n_cust, n_parts, t["custKey"],
                                    t["partKey"])
    q = np.zeros((n_parts,), np.float32)
    for p in set(query_parts):
        q[p] = 1.0
    vals, idx = _jaccard_core(member, _upload(q, member.device), k)
    out = sorted(zip(vals.cpu().tolist(), idx.cpu().tolist()),
                 key=lambda si: (-si[0], si[1]))
    return [(float(s), int(i)) for s, i in out]


# ----------------------------------------------------------- bench
def bench_columns(n_customers: int = 100_000, max_orders: int = 4,
                  max_items: int = 5, n_parts: int = 2048,
                  n_suppliers: int = 64, seed: int = 0
                  ) -> Dict[str, Tuple[Dict[str, np.ndarray],
                                       Dict[str, list]]]:
    """Host columns of the bench, drawn from ``seed`` in bulk: about
    ``n_customers × (max_orders + 1) // 2 × (max_items + 1) // 2``
    triples over ``n_parts`` parts (the reference's bench draws), and a
    customers table for the selections. Returns ``{name: (columns,
    dictionaries)}``."""
    rng = np.random.default_rng(seed)
    n_rows = n_customers * ((max_orders + 1) // 2) * ((max_items + 1) // 2)
    ck = np.repeat(np.arange(n_customers, dtype=np.int32),
                   n_rows // n_customers)
    triples = {"custKey": ck,
               "supplier": rng.integers(0, n_suppliers,
                                        len(ck)).astype(np.int32),
               "partKey": rng.integers(0, n_parts, len(ck)).astype(np.int32)}
    segs = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
    customers = {"custKey": np.arange(n_customers, dtype=np.int32),
                 "nationKey": rng.integers(0, 25, n_customers).astype(
                     np.int32),
                 "mktsegment": rng.integers(0, len(segs), n_customers
                                            ).astype(np.int32),
                 "accbal": rng.uniform(-999, 9999, n_customers).astype(
                     np.float32)}
    return {"customers": (customers, {"mktsegment": segs}),
            "triples": (triples, {"supplier": [f"Supplier{i}" for i in
                                               range(n_suppliers)]})}


def bench_tpch_bench(n_customers: int = 100_000, max_orders: int = 4,
                     max_items: int = 5, n_parts: int = 2048,
                     n_suppliers: int = 64, k: int = 10, seed: int = 0,
                     iters: int = 10, device=None) -> Dict[str, object]:
    """The Jaccard top-k at a scale the host path cannot touch (about
    1 M triples) on ``device`` (CUDA unless asked), timed by
    ``relational.bench``'s timer (CUDA events on a card, the host clock
    on the CPU, which ``device`` names): the median over ``iters``
    queries against a membership matrix built once."""
    from netsdb_tpu_torch.config import resolve_device
    from netsdb_tpu_torch.relational.bench import _timer

    dev = resolve_device(device)
    cols, _ = bench_columns(n_customers, max_orders, max_items, n_parts,
                            n_suppliers, seed)["triples"]
    ck = torch.from_numpy(cols["custKey"]).to(dev)
    pk = torch.from_numpy(cols["partKey"]).to(dev)
    member = _membership_matrix(n_customers, n_parts, ck, pk)
    rng = np.random.default_rng(seed + 1)
    q = torch.from_numpy((rng.random(n_parts) < 0.05).astype(
        np.float32)).to(dev)
    timer = _timer(dev)
    _jaccard_core(member, q, k)  # warm-up
    ms = float(np.median([timer(lambda: _jaccard_core(member, q, k))
                          for _ in range(iters)]))
    return {"triples": int(len(ck)), "customers": n_customers,
            "parts": n_parts, "device": str(dev), "jaccard_ms": ms}


def queries_on_sets(client, db: str = "tpchbench", threshold: int = 0,
                    segment: str = "BUILDING",
                    query_parts: Sequence[int] = (0,), k: int = 5):
    """The whole family against the stored relation sets ``customers``
    and ``triples`` of ``client`` (sent with ``send_table``): returns
    ``{selections, pair_counts, per_supplier, count, top_jaccard}``.

    Over placed sets (the reference's distributed run) the kernels run on
    each mesh position's rows: the selections per customer block
    (concatenated in position order, padding rows included, as the
    reference's sharded masks are), the supplier counts and the
    membership matrix as per-position partials combined in position order
    (a sum, a maximum), the Jaccard top-k once over the merged matrix;
    padding rows fold to -1 keys like every placed table's."""
    from netsdb_tpu_torch.parallel.mesh import move
    from netsdb_tpu_torch.parallel.placement import (is_placed_table,
                                                     local_tables)
    from netsdb_tpu_torch.relational.dag import _fold_mask
    from netsdb_tpu_torch.relational.stats import analyze_table, inject_stats

    names = ("customers", "triples")
    raw = {n: client.get_table(db, n) for n in names}
    if not any(is_placed_table(t) for t in raw.values()):
        cust_mask = raw["customers"].mask()
        tables = {n: inject_stats(_fold_mask(t), analyze_table(t))
                  for n, t in raw.items()}
        sels = tuple(m & cust_mask
                     for m in selections(tables, threshold, segment))
        pair, per = group_by_supplier(tables)
        return {"selections": sels, "pair_counts": pair,
                "per_supplier": per, "count": int(cust_mask.sum()),
                "top_jaccard": top_jaccard(tables, list(query_parts), k)}
    stats = {n: analyze_table(t) for n, t in raw.items()}

    def locals_of(n):
        t = raw[n]
        parts = local_tables(t) if is_placed_table(t) else [t]
        if is_placed_table(t) and \
                next(iter(t.cols.values())).spec[0] is None:
            parts = parts[:1]  # replicated: one copy is the relation
        return parts, [inject_stats(_fold_mask(p), stats[n]) for p in parts]

    raw_custs, custs = locals_of("customers")
    _, trips = locals_of("triples")
    dev0 = custs[0].device
    sels = None
    count = 0
    for r, c in zip(raw_custs, custs):
        raw_mask = r.mask()
        part = [move(s & raw_mask, dev0)
                for s in selections({"customers": c}, threshold, segment)]
        sels = part if sels is None else [torch.cat([a, b])
                                          for a, b in zip(sels, part)]
        count += int(raw_mask.sum())
    whole = {"customers": custs[0], "triples": trips[0]}
    n_cust, n_parts = _jaccard_shape(whole, list(query_parts))
    pair = per = member = None
    for t in trips:
        tabs = {"customers": custs[0].to(t.device), "triples": t}
        p, q = group_by_supplier(tabs)
        m = _membership_matrix(n_cust, n_parts, t["custKey"], t["partKey"])
        if pair is None:
            pair, per, member = move(p, dev0), move(q, dev0), move(m, dev0)
        else:
            pair = pair + move(p, dev0)
            per = per + move(q, dev0)
            member = torch.maximum(member, move(m, dev0))
    return {"selections": tuple(sels), "pair_counts": pair,
            "per_supplier": per, "count": count,
            "top_jaccard": top_jaccard(whole, list(query_parts), k,
                                       member=member)}