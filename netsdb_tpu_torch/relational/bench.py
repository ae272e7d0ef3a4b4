"""TPC-H columnar benchmark at dbgen scale — counterpart of
``netsdb_tpu/relational/bench.py``.

:func:`generate_columnar` builds the eight TPC-H tables as columns with
dbgen's row counts (lineitem 6M·SF, orders 1.5M·SF, customer 150k·SF,
part 200k·SF, partsupp 4 per part, supplier 10k·SF, nation 25, region
5), the value ranges of dbgen and the real TPC-H enumerations,
dictionary-encoded. The columns are drawn in numpy from the seed (in the
reference generator's order, so a seed gives the reference's data),
analysed on the host and moved to the device once.
:func:`bench_queries` and :func:`bench_suite` time the queries on the
tables' device with CUDA events (the host clock on the CPU).

Run: ``python -m netsdb_tpu_torch.relational.bench [SF] [ITERS]``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from netsdb_tpu_torch.relational.queries import (COLUMNAR_QUERIES, Tables,
                                                 compile_suite)
from netsdb_tpu_torch.relational.table import ColumnTable

# the reference's published cluster wall times, seconds (BASELINE.md §6;
# its scale factor is unrecorded): a figure beside ours, not a speed-up
PUBLISHED = {"q01": 13.4, "q02": 77.4, "q04": 188.5}


def generate_host(sf: float = 0.1, seed: int = 0):
    """The tables' host columns and dictionaries:
    ``{name: (cols, dicts)}`` of numpy arrays."""
    rng = np.random.default_rng(seed)
    n_li = int(6_000_000 * sf)
    n_ord = int(1_500_000 * sf)
    n_cust = int(150_000 * sf)
    n_part = int(200_000 * sf)
    n_sup = max(int(10_000 * sf), 1)

    def dates(n):
        return (rng.integers(1992, 1999, n) * 10000
                + rng.integers(1, 13, n) * 100
                + rng.integers(1, 29, n)).astype(np.int32)

    flags = ["A", "N", "R"]
    status = ["F", "O"]
    modes = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
    prios = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
    segs = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
    brands = sorted(f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6))
    containers = sorted(["SM CASE", "MED BOX", "LG JAR", "WRAP PACK",
                         "JUMBO PKG"])
    types = sorted(["PROMO BURNISHED", "STANDARD POLISHED",
                    "ECONOMY ANODIZED", "PROMO PLATED", "MEDIUM BRUSHED"])

    commit = dates(n_li)
    lineitem = {
        "l_orderkey": rng.integers(0, n_ord, n_li).astype(np.int32),
        "l_partkey": rng.integers(0, n_part, n_li).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.int32),
        "l_extendedprice": rng.uniform(1000, 100000, n_li).astype(np.float32),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2
                               ).astype(np.float32),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2).astype(np.float32),
        "l_returnflag": rng.integers(0, 3, n_li).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n_li).astype(np.int32),
        "l_shipmode": rng.integers(0, 7, n_li).astype(np.int32),
        "l_shipdate": dates(n_li),
        "l_commitdate": commit,
        "l_receiptdate": commit + rng.integers(-5, 15, n_li).astype(np.int32),
    }
    orders = {
        "o_orderkey": np.arange(n_ord, dtype=np.int32),
        "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int32),
        "o_orderdate": dates(n_ord),
        "o_orderpriority": rng.integers(0, 5, n_ord).astype(np.int32),
    }
    # dbgen phone country codes are 10..34; Q22 groups by the 2-character
    # prefix, so 25 representative numbers make the dictionary
    phones = [f"{cc}-555-{cc:03d}-{cc * 37 % 10000:04d}"
              for cc in range(10, 35)]
    customer = {
        "c_custkey": np.arange(n_cust, dtype=np.int32),
        "c_mktsegment": rng.integers(0, 5, n_cust).astype(np.int32),
        "c_acctbal": rng.uniform(-999, 9999, n_cust).astype(np.float32),
        "c_phone": rng.integers(0, len(phones), n_cust).astype(np.int32),
    }
    part = {
        "p_partkey": np.arange(n_part, dtype=np.int32),
        "p_brand": rng.integers(0, len(brands), n_part).astype(np.int32),
        "p_container": rng.integers(0, len(containers), n_part
                                    ).astype(np.int32),
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_type": rng.integers(0, len(types), n_part).astype(np.int32),
    }
    n_ps = 4 * n_part  # dbgen: four suppliers per part
    partsupp = {
        "ps_partkey": np.repeat(np.arange(n_part, dtype=np.int32), 4),
        "ps_suppkey": rng.integers(0, n_sup, n_ps).astype(np.int32),
        "ps_supplycost": rng.uniform(1, 1000, n_ps).astype(np.float32),
    }
    supplier = {
        "s_suppkey": np.arange(n_sup, dtype=np.int32),
        "s_nationkey": rng.integers(0, 25, n_sup).astype(np.int32),
        "s_name": np.arange(n_sup, dtype=np.int32),
    }
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int32),
        "n_regionkey": np.arange(25, dtype=np.int32) % 5,
        "n_name": np.arange(25, dtype=np.int32),
    }
    region = {
        "r_regionkey": np.arange(5, dtype=np.int32),
        "r_name": np.arange(5, dtype=np.int32),
    }
    return {
        "lineitem": (lineitem, {"l_returnflag": flags,
                                "l_linestatus": status,
                                "l_shipmode": modes}),
        "orders": (orders, {"o_orderpriority": prios}),
        "customer": (customer, {"c_mktsegment": segs, "c_phone": phones}),
        "part": (part, {"p_brand": brands, "p_container": containers,
                        "p_type": types}),
        "partsupp": (partsupp, {}),
        "supplier": (supplier, {"s_name": [f"Supplier#{i:09d}"
                                           for i in range(n_sup)]}),
        "nation": (nation, {"n_name": [f"NATION{i:02d}" for i in range(25)]}),
        "region": (region, {"r_name": ["AFRICA", "AMERICA", "ASIA",
                                       "EUROPE", "MIDDLE EAST"]}),
    }


def generate_columnar(sf: float = 0.1, seed: int = 0,
                      device=None) -> Tables:
    """The eight tables on ``device`` (CUDA unless asked), drawn on the
    host from ``seed``, analysed there and uploaded once."""
    return {name: ColumnTable.from_columns(cols, dicts, device=device)
            for name, (cols, dicts) in generate_host(sf, seed).items()}


def _timer(device) -> Callable[[Callable[[], object]], float]:
    """Milliseconds of one call, by CUDA events on a card (the call's
    own result read back included), by the host clock on the CPU."""
    dev = torch.device(device)

    def run(fn):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    return run


def bench_queries(tables: Tables,
                  names=("q01", "q02", "q03", "q04", "q06", "q12", "q13",
                         "q14", "q17", "q22"),
                  iters: int = 10) -> Dict[str, Dict[str, float]]:
    """Per query: the first call's ms and the p50 of ``iters`` more, and
    lineitem rows per second at the p50. Each call reads its result
    back to the host, as ``cqXX`` does."""
    timer = _timer(tables["lineitem"].device)
    n_li = tables["lineitem"].num_rows
    out: Dict[str, Dict[str, float]] = {}
    for name in names:
        fn = COLUMNAR_QUERIES[name]
        first = timer(lambda: fn(tables))
        times = sorted(timer(lambda: fn(tables)) for _ in range(iters))
        p50 = times[len(times) // 2]
        out[name] = {"ms_p50": p50, "first_ms": first,
                     "lineitem_rows_per_s": n_li / (p50 / 1e3)}
    return out


def bench_suite(tables: Tables, iters: int = 10) -> Dict[str, float]:
    """The ten cores in turn per call (``compile_suite``): the p50 ms of
    the whole suite."""
    suite = compile_suite(tables)
    timer = _timer(tables["lineitem"].device)
    first = timer(suite)
    times = sorted(timer(suite) for _ in range(iters))
    return {"all_ten_queries_ms": times[len(times) // 2],
            "first_ms": first}


def main(sf: float = 0.1, iters: int = 10, device=None):
    tables = generate_columnar(sf, device=device)
    res = bench_queries(tables, iters=iters)
    for name, secs in PUBLISHED.items():
        res[name]["reference_cluster_s"] = secs
    return {"scale_factor": sf,
            "lineitem_rows": tables["lineitem"].num_rows,
            "device": str(tables["lineitem"].device),
            "queries": res, "suite": bench_suite(tables, iters=iters)}


if __name__ == "__main__":
    args = sys.argv[1:]
    # lint: disable=print-ban -- the module's script entry: its JSON result on stdout is its output
    print(json.dumps(main(float(args[0]) if args else 0.1,
                          int(args[1]) if len(args) > 1 else 10)))
