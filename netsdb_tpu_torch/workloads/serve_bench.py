"""The scale-out workload of the reference's ``workloads/serve_bench.py``
(``:661-792``), in torch: the q01-shaped table with integer measures, its
scatterable fold sink, the shuffle-join sink and the byte-equality probe.
The pool tests and ``chip_smoke.py`` phase 17 run them. The bench loops
themselves (``run_scaleout_bench``, ``run_serving_bench``) are ROADMAP.md
A8."""

from __future__ import annotations

import numpy as np
import torch

from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import single_pass, tree_add_states
from netsdb_tpu_torch.relational.table import ColumnTable


def scaleout_table(rows: int, seed: int = 0) -> ColumnTable:
    """The q01-style workload with INTEGER measures (the reference's draws
    in the same order): partial sums stay exact, so an N-daemon
    scatter-gather result equals the one-daemon run byte for byte. The
    columns are host tensors."""
    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(19920101, 19981231, rows, dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows, dtype=np.int32),
        "l_price": rng.integers(1, 1000, rows, dtype=np.int32),
    }
    return ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()},
                       {"l_returnflag": ["A", "N", "R"],
                        "l_linestatus": ["F", "O"]})


def scaleout_q01_sink(db: str, cutoff: int = 19980902,
                      lineitem_set: str = "lineitem",
                      output_set: str = "scale_q01_out") -> WriteSet:
    """SCAN(lineitem) → APPLY(int group-by fold) → OUTPUT: per
    (returnflag, linestatus) group, int32 count, sum(qty) and sum(price)
    under a shipdate cutoff; a single-pass fold with ``state_merge``
    (tree add) — the scatterable q01 shape with exact accumulators."""
    n_groups = 6  # 3 returnflags x 2 linestatuses

    def init(prev, src):
        z = torch.zeros((n_groups,), dtype=torch.int32, device=src.device)
        return (z, z.clone(), z.clone())

    def step(state, chunk):
        counts, qty, price = state
        ok = chunk.mask() & (chunk["l_shipdate"] <= cutoff)
        gid = torch.where(ok, chunk["l_returnflag"] * 2
                          + chunk["l_linestatus"], 0).long()
        zero = torch.zeros((), dtype=torch.int32, device=ok.device)
        return (counts.index_add(0, gid, ok.to(torch.int32)),
                qty.index_add(0, gid, torch.where(
                    ok, chunk["l_quantity"], zero)),
                price.index_add(0, gid, torch.where(
                    ok, chunk["l_price"], zero)))

    def fin(state, src):
        counts, qty, price = state
        gid = torch.arange(n_groups, dtype=torch.int32, device=counts.device)
        return ColumnTable(
            cols={"l_returnflag": torch.div(gid, 2, rounding_mode="floor"),
                  "l_linestatus": gid % 2, "count": counts,
                  "sum_qty": qty, "sum_price": price},
            dicts={"l_returnflag": src.dicts["l_returnflag"],
                   "l_linestatus": src.dicts["l_linestatus"]},
            valid=counts > 0)

    return WriteSet(Apply(ScanSet(db, lineitem_set),
                          fold=single_pass(init, step, fin,
                                           state_merge=tree_add_states),
                          label=f"scaleq01:{cutoff}"),
                    db, output_set)


def scaleout_join_sink(db: str, key_space: int,
                       lineitem_set: str = "lineitem",
                       orders_set: str = "orders",
                       output_set: str = "scale_join_out") -> WriteSet:
    """Per-order sum of lineitem prices through a LUT probe, with integer
    accumulators; declared probe/build keys and an output merge make it a
    distributed-shuffle join over a pool, every order's lineitems on its
    key's bucket, so the sharded result equals the one-daemon run byte for
    byte."""

    def init(prev, src, orders):
        return torch.zeros((orders.num_rows,), dtype=torch.int32,
                           device=orders.device)

    def step(acc, li, orders):
        dev = orders.device
        lut = torch.full((key_space,), -1, dtype=torch.int32, device=dev)
        lut[orders["o_orderkey"].long()] = torch.arange(
            orders.num_rows, dtype=torch.int32, device=dev)
        oidx = lut[li["l_orderkey"].long()]
        ok = (oidx >= 0) & li.mask()
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return acc.index_add(0, torch.where(ok, oidx, zero).long(),
                             torch.where(ok, li["l_price"], zero))

    def fin(acc, src, orders):
        return ColumnTable(cols={"okey": orders["o_orderkey"], "rev": acc},
                           valid=acc > 0)

    def merge(a, b):
        return ColumnTable(
            cols={"okey": torch.cat([a["okey"], b["okey"]]),
                  "rev": torch.cat([a["rev"], b["rev"]])},
            valid=torch.cat([a.mask(), b.mask()]))

    return WriteSet(
        Join(ScanSet(db, lineitem_set), ScanSet(db, orders_set),
             fold=single_pass(init, step, fin, merge,
                              probe_key="l_orderkey",
                              build_key="o_orderkey",
                              probe_columns=("l_price",)),
             label=f"scalejoin:{key_space}"),
        db, output_set)


def _scale_rows(client, db: str, out_set: str):
    """Decoded, canonically ordered result rows (the byte-equality
    probe)."""
    t = client.get_table(db, out_set)
    ok = (t.valid.detach().cpu().numpy() if t.valid is not None
          else np.ones(t.num_rows, bool))
    names = sorted(t.cols)
    host = {n: t.cols[n].detach().cpu().numpy() for n in names}
    return sorted(tuple(int(host[n][i]) for n in names)
                  for i in range(t.num_rows) if ok[i])
