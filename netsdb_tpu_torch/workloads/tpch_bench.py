"""tpchBench over nested host records — counterpart of
``netsdb_tpu/workloads/tpch_bench.py`` (the reference's
``src/tpchBench`` Customer⋈Order⋈LineItem family).

``Customer`` holds a list of ``Order``s, each a list of ``LineItem``s
(``src/tpchBench/headers/Customer.h:25-40``). The query shapes run as
host DAGs through the executor's record path: int and string selections
and their negations (``CustomerIntegerSelection[Not].h``,
``CustomerStringSelection[Not].h``), the flatten into (customer,
supplier, part) triples (``CustomerMultiSelection.h``), the group-by
supplier (``CustomerSupplierPartGroupBy.h``), the count
(``CountCustomer.h``) and the top-k Jaccard over part sets
(``TopJaccard.h:17``), a single-group aggregate merging bounded heaps.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Dict, FrozenSet, List, Sequence, Tuple

from netsdb_tpu_torch.plan.computations import (
    Aggregate, Filter, MultiApply, ScanSet, WriteSet,
)


@dataclasses.dataclass
class LineItem:
    """``src/tpchBench/headers/LineItem.h`` — reduced to the fields the
    benchmark queries read (part + supplier identity)."""

    lineNumber: int
    partKey: int
    supplierName: str


@dataclasses.dataclass
class Order:
    orderKey: int
    lineItems: List[LineItem]


@dataclasses.dataclass
class Customer:
    """Nested customer object (``Customer.h:25-40``)."""

    custKey: int
    name: str
    nationKey: int
    mktsegment: str
    accbal: float
    orders: List[Order]


@dataclasses.dataclass
class CustomerSupplierPartFlat:
    """``CustomerSupplierPartFlat.h:12`` — one flattened triple."""

    customerName: str
    supplierName: str
    partKey: int


def generate(num_customers: int = 50, max_orders: int = 4,
             max_items: int = 5, num_parts: int = 60,
             num_suppliers: int = 12, seed: int = 0) -> List[Customer]:
    """Seeded nested instance — the reference's ``generateSmallDataset``
    in its tpchBench drivers."""
    rng = random.Random(seed)
    segs = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
    out = []
    order_key = 0
    for ck in range(num_customers):
        orders = []
        for _ in range(rng.randrange(1, max_orders + 1)):
            items = [LineItem(lineNumber=i,
                              partKey=rng.randrange(num_parts),
                              supplierName=f"Supplier{rng.randrange(num_suppliers)}")
                     for i in range(rng.randrange(1, max_items + 1))]
            orders.append(Order(orderKey=order_key, lineItems=items))
            order_key += 1
        out.append(Customer(custKey=ck, name=f"Customer{ck}",
                            nationKey=rng.randrange(25),
                            mktsegment=rng.choice(segs),
                            accbal=round(rng.uniform(-999, 9999), 2),
                            orders=orders))
    return out


def load(client, customers: Sequence[Customer], db: str = "tpchbench") -> None:
    client.create_database(db)
    if not client.set_exists(db, "customers"):
        client.create_set(db, "customers", type_name="object")
    client.clear_set(db, "customers")
    client.send_data(db, "customers", list(customers))


# --- selections -------------------------------------------------------

def customer_int_selection(db: str = "tpchbench", threshold: int = 0,
                           negate: bool = False) -> WriteSet:
    """``CustomerIntegerSelection[Not]`` — custKey predicate."""
    scan = ScanSet(db, "customers")
    if negate:
        pred = lambda c, t=threshold: not (c.custKey > t)
    else:
        pred = lambda c, t=threshold: c.custKey > t
    f = Filter(scan, pred, label=f"custkey{'_not' if negate else ''}>{threshold}")
    return WriteSet(f, db, "selected_int" + ("_not" if negate else ""))


def customer_string_selection(db: str = "tpchbench", segment: str = "BUILDING",
                              negate: bool = False) -> WriteSet:
    """``CustomerStringSelection[Not]`` — mktsegment predicate."""
    scan = ScanSet(db, "customers")
    if negate:
        pred = lambda c, s=segment: c.mktsegment != s
    else:
        pred = lambda c, s=segment: c.mktsegment == s
    f = Filter(scan, pred, label=f"seg{'_not' if negate else ''}={segment}")
    return WriteSet(f, db, "selected_str" + ("_not" if negate else ""))


# --- flatten + group-by ----------------------------------------------

def _flatten_customer(c: Customer) -> List[CustomerSupplierPartFlat]:
    return [CustomerSupplierPartFlat(c.name, li.supplierName, li.partKey)
            for o in c.orders for li in o.lineItems]


def flatten_triples(db: str = "tpchbench") -> WriteSet:
    """``CustomerMultiSelection`` — explode the nested object graph into
    (customer, supplier, part) triples (a FLATTEN atom)."""
    scan = ScanSet(db, "customers")
    m = MultiApply(scan, _flatten_customer, label="cust_supplier_part")
    return WriteSet(m, db, "triples")


def group_by_supplier(db: str = "tpchbench") -> WriteSet:
    """``CustomerSupplierPartGroupBy`` → ``SupplierInfo``: supplier name
    → {customer name → sorted part keys}."""
    scan = ScanSet(db, "triples")

    def combine(a: Dict[str, List[int]], b: Dict[str, List[int]]):
        # ``a`` is the Aggregate's own accumulator (the first ``value`` of
        # its key, a fresh dict), so ``b`` folds into it in place: the
        # same dict as a copy per triple, in time linear in the triples
        for cust, parts in b.items():
            a.setdefault(cust, []).extend(parts)
        return a

    agg = Aggregate(scan,
                    key=lambda t: t.supplierName,
                    value=lambda t: {t.customerName: [t.partKey]},
                    combine=combine, label="supplier_info")
    return WriteSet(agg, db, "supplier_info")


def count_customers(db: str = "tpchbench") -> WriteSet:
    """``CountCustomer``/``CountAggregation`` — single-group count."""
    scan = ScanSet(db, "customers")
    agg = Aggregate(scan, key=lambda c: 0, value=lambda c: 1,
                    combine=lambda a, b: a + b, label="count")
    return WriteSet(agg, db, "customer_count")


# --- top-K jaccard ----------------------------------------------------

def _part_set(c: Customer) -> FrozenSet[int]:
    return frozenset(li.partKey for o in c.orders for li in o.lineItems)


def top_jaccard(db: str = "tpchbench", query_parts: Sequence[int] = (),
                k: int = 5) -> WriteSet:
    """``TopJaccard : TopKComp<Customer, double, Handle<AllParts>>`` —
    score every customer by Jaccard(parts(c), query) and keep the top
    K. The reference's TopKComp is an aggregation maintaining a bounded
    heap; same here, as a single-group Aggregate whose combiner merges
    heaps (so it distributes exactly like ClusterAggregateComp)."""
    q = frozenset(query_parts)
    scan = ScanSet(db, "customers")

    def score(c: Customer) -> List[Tuple[float, int, str]]:
        parts = _part_set(c)
        denom = len(parts | q)
        j = (len(parts & q) / denom) if denom else 0.0
        return [(j, c.custKey, c.name)]

    def combine(a: List, b: List) -> List:
        return heapq.nlargest(k, a + b)

    agg = Aggregate(scan, key=lambda c: 0, value=score, combine=combine,
                    label=f"top{k}_jaccard")
    return WriteSet(agg, db, "top_jaccard")
