"""Hash-repartition shuffle with ROW outputs — counterpart of
``netsdb_tpu/relational/shuffle.py``.

The reference's partitioned join materialises distributed row sets:
each node hashes its join keys, per-destination combiner threads stream
rows to the owning node, and the joined tuples land in a partitioned set
(``PipelineStage.cc:1652-1728``). Here, as in the JAX package:

- the shuffle is ONE all-to-all over the mesh axis
  (:func:`~netsdb_tpu_torch.parallel.mesh.position_all_to_all`);
- destination buckets have a fixed capacity (``slack`` times the mean
  bucket, plus 16) with a validity mask and an overflow count summed over
  the positions — a full bucket drops rows and counts them, it never
  grows (:func:`check_overflow`);
- co-location is by ``key % n`` and each shard works on the compressed
  key ``key // n``: floor mod and floor division, as in jnp, so a -1
  padding key lands on shard ``n - 1`` with the compressed key -1 that
  every join drops.

:class:`ShardedRows` is the distributed table: its columns are
row-sharded :class:`~netsdb_tpu_torch.parallel.mesh.ShardedTensor` s, so
a downstream stage (:func:`local_join`, :func:`segment_sum_by_key`,
:func:`distributed_top_k`) runs on each position's rows with no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, move,
                                            position_all_to_all,
                                            position_gather, position_sum,
                                            visible_devices)
from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.planner import JoinPlan
from netsdb_tpu_torch.relational.sharded import shard_fact_columns


def _floor_div(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.div(a, n, rounding_mode="floor")


def _group(mesh: Mesh, axis: str) -> list:
    """The positions of the shuffle's axis. The shuffle runs over 1-d
    meshes (the reference's placements are)."""
    groups = mesh.axis_groups(axis)
    if len(groups) != 1:
        raise ValueError(f"the row shuffle runs over a 1-d mesh; "
                         f"{mesh.shape} has other axes")
    return groups[0]


def _sharded(mesh: Mesh, axis: str, blocks: List[torch.Tensor]
             ) -> ShardedTensor:
    shards = np.empty(mesh.devices.shape, dtype=object)
    for p, b in zip(_group(mesh, axis), blocks):
        shards[p] = b
    n = sum(b.shape[0] for b in blocks)
    return ShardedTensor(shards, mesh, (axis,), (n,) + tuple(
        blocks[0].shape[1:]))


def _blocks(x, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """The row blocks of ``x`` at the axis' positions: the shards of a
    value laid out so, else the dense value split (its length a multiple
    of the axis size)."""
    group = _group(mesh, axis)
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and x.spec[0] == axis:
            return [x.shards[p] for p in group]
        x = x.to_dense()
    n = len(group)
    return [move(b, mesh.devices[p])
            for b, p in zip(torch.chunk(x, n), group)]


def _length(x) -> int:
    return int(x.shape[0])


@dataclasses.dataclass
class ShardedRows:
    """A distributed row set: each column a row-sharded ``ShardedTensor``
    over ``mesh``; ``valid`` marks live rows (bucket padding is False).
    ``overflow`` counts rows dropped because a destination bucket filled
    — verify it is 0 (:func:`check_overflow`) or re-run with more
    ``slack``."""

    cols: Dict[str, ShardedTensor]
    valid: ShardedTensor
    mesh: Mesh
    axis: str
    overflow: torch.Tensor

    @property
    def rows_per_shard(self) -> int:
        return self.valid.shape[0] // self.mesh.shape[self.axis]

    def local(self, i: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Position ``i``'s columns and validity."""
        p = _group(self.mesh, self.axis)[i]
        return ({k: c.shards[p] for k, c in self.cols.items()},
                self.valid.shards[p])


def check_overflow(t: ShardedRows) -> None:
    n = int(t.overflow)
    if n:
        raise ValueError(
            f"hash shuffle dropped {n} rows (bucket capacity too small);"
            " re-run with a larger slack factor")


def _bucket_local(cols: Dict[str, torch.Tensor], key: torch.Tensor,
                  valid: torch.Tensor, n_shards: int, cap: int):
    """Pack one position's rows into (n_shards, cap) destination buckets,
    dropping overflow with a count: valid rows sorted stably by
    destination, each row's rank within its destination its slot."""
    dev = key.device
    dest = torch.remainder(key, n_shards)
    sort_key = torch.where(valid, dest, torch.full_like(dest, n_shards))
    order = torch.sort(sort_key, stable=True).indices
    dest_s = sort_key[order]
    first = torch.searchsorted(
        dest_s, torch.arange(n_shards, device=dev, dtype=dest_s.dtype),
        side="left")
    n = dest.shape[0]
    rank = (torch.arange(n, device=dev)
            - first[dest_s.clamp(0, n_shards - 1).long()])
    live = dest_s < n_shards
    ok = live & (rank < cap)
    # dropped rows write the spare slot n_shards*cap, cut off below
    slot = torch.where(ok, dest_s.long() * cap + rank,
                       torch.full_like(rank, n_shards * cap))
    out = {}
    for name, c in cols.items():
        buf = c.new_zeros((n_shards * cap + 1,) + c.shape[1:])
        buf[slot] = c[order]
        out[name] = buf[:-1].reshape((n_shards, cap) + c.shape[1:])
    vbuf = torch.zeros(n_shards * cap + 1, dtype=torch.bool, device=dev)
    vbuf[slot] = ok
    overflow = (live & (rank >= cap)).sum().to(torch.int32)
    return out, vbuf[:-1].reshape(n_shards, cap), overflow


def hash_repartition(mesh: Mesh, axis: str, cols: Dict[str, object],
                     key_col: str, slack: float = 2.0,
                     valid=None) -> ShardedRows:
    """Repartition a row-sharded table so that all rows with equal
    ``cols[key_col]`` land on shard ``key % n_shards``.

    Every output column keeps its input name; rows are padded to the
    static bucket capacity ``cap = slack * mean_bucket + 16``. ``valid``
    marks live input rows (a ``ShardedRows`` result being re-shuffled:
    its padding rows must not travel)."""
    if "__valid__" in cols:
        raise ValueError("column name '__valid__' is reserved by "
                         "hash_repartition (internal validity mask)")
    n_shards = mesh.shape[axis]
    group = _group(mesh, axis)
    payload = dict(cols)
    if valid is not None:
        payload["__valid__"] = valid
    n = _length(next(iter(payload.values())))
    if n % n_shards == 0 and all(
            isinstance(v, ShardedTensor) and v.mesh is mesh
            and v.spec[0] == axis for v in payload.values()):
        blocks = {k: _blocks(v, mesh, axis) for k, v in payload.items()}
        pad_valid = [torch.ones(b.shape[0], dtype=torch.bool,
                                device=b.device)
                     for b in next(iter(blocks.values()))]
        padded = n
    else:
        dense = {k: (v.to_dense() if isinstance(v, ShardedTensor) else v)
                 for k, v in payload.items()}
        dense, pv = shard_fact_columns(dense, n_shards)
        blocks = {k: _blocks(v, mesh, axis) for k, v in dense.items()}
        pad_valid = _blocks(pv, mesh, axis)
        padded = pv.shape[0]
    in_valid = blocks.pop("__valid__", None)
    per_shard = padded // n_shards
    cap = int(slack * (per_shard / n_shards)) + 16
    names = sorted(blocks)
    bucketed, bvalid, overflow = [], [], []
    for i in range(n_shards):
        v = pad_valid[i] if in_valid is None else (pad_valid[i]
                                                   & in_valid[i])
        c = {k: blocks[k][i] for k in names}
        b, bv, of = _bucket_local(c, c[key_col], v, n_shards, cap)
        bucketed.append(b)
        bvalid.append(bv)
        overflow.append(of)
    out_cols = {}
    for k in names:
        ex = position_all_to_all([b[k] for b in bucketed], 0, 0)
        out_cols[k] = _sharded(mesh, axis, [e.reshape((-1,) + e.shape[2:])
                                            for e in ex])
    ex_valid = position_all_to_all(bvalid, 0, 0)
    obs.REGISTRY.counter("shuffle.repartitions").inc()
    return ShardedRows(out_cols,
                       _sharded(mesh, axis, [e.reshape(-1) for e in ex_valid]),
                       mesh, axis, position_sum(overflow,
                                                mesh.devices[group[0]]))


def compressed_key_space(global_key_space: int, n_shards: int) -> int:
    """Per-shard key-space bound after modulo placement: local key is
    ``key // n_shards``."""
    return -(-global_key_space // n_shards) + 1


def hash_join(mesh: Mesh, axis: str, build: Dict[str, object],
              build_key: str, probe: Dict[str, object], probe_key: str,
              key_space: int, build_mask_fn: Optional[Callable] = None,
              slack: float = 2.0, build_valid=None,
              probe_valid=None) -> ShardedRows:
    """Distributed hash-partitioned equi-join with row output: both sides
    repartitioned by key (two all-to-alls), then each shard joins its
    co-located partitions over the COMPRESSED key space. The result
    carries every probe column plus every build column (gathered through
    the join) and the ``hit`` validity. ``build_mask_fn(cols)`` filters
    build rows; build keys must be unique among surviving rows."""
    clash = (set(build) - {build_key}) & set(probe)
    if clash:
        raise ValueError(
            f"hash_join column name collision {sorted(clash)}: rename a "
            "side's columns (build columns would silently shadow probe)")
    b = hash_repartition(mesh, axis, build, build_key, slack, build_valid)
    p = hash_repartition(mesh, axis, probe, probe_key, slack, probe_valid)
    nb = _length(next(iter(build.values())))
    npr = _length(next(iter(probe.values())))
    return local_join(b, p, build_key, probe_key, key_space, nb, npr,
                      build_mask_fn)


def local_join(b: ShardedRows, p: ShardedRows, build_key: str,
               probe_key: str, key_space: int, build_rows: int,
               probe_rows: int,
               build_mask_fn: Optional[Callable] = None) -> ShardedRows:
    """Per-shard join of two ALREADY co-partitioned row sets over the
    compressed key space — the local half of :func:`hash_join`, for a
    DAG that composes the shuffle (``Partition`` nodes) and the join as
    separate stages. The per-shard plan comes from the single-device
    planner's cost model, fed the per-shard row counts of the pre-shuffle
    inputs and the compressed key space."""
    from netsdb_tpu_torch.relational.planner import plan_join_from_stats
    from netsdb_tpu_torch.relational.stats import ColumnStats

    mesh, axis = b.mesh, b.axis
    n_shards = mesh.shape[axis]
    local_ks = compressed_key_space(key_space, n_shards)
    jp = plan_join_from_stats(
        ColumnStats(build_rows // n_shards + 1, 0, local_ks - 1, -1),
        probe_rows // n_shards + 1)
    jp = JoinPlan(jp.strategy, local_ks)
    out_names = sorted(set(p.cols) | (set(b.cols) - {build_key}))
    per_col: Dict[str, List[torch.Tensor]] = {k: [] for k in out_names}
    hits = []
    for i in range(n_shards):
        bc, bvalid = b.local(i)
        pc, pvalid = p.local(i)
        bmask = bvalid
        if build_mask_fn is not None:
            bmask = bmask & build_mask_fn(bc)
        idx, hit = K.pk_fk_join(_floor_div(bc[build_key], n_shards),
                                _floor_div(pc[probe_key], n_shards),
                                bmask, pvalid, plan=jp)
        out = dict(pc)
        for name in bc:
            if name != build_key:
                out[name] = K.take(bc[name], idx)
        for k in out_names:
            per_col[k].append(out[k])
        hits.append(hit)
    return ShardedRows({k: _sharded(mesh, axis, v)
                        for k, v in per_col.items()},
                       _sharded(mesh, axis, hits), mesh, axis,
                       b.overflow + move(p.overflow, b.overflow.device))


def segment_sum_by_key(t: ShardedRows, key_col: str, value_col: str,
                       key_space: int, extra_min_col: Optional[str] = None):
    """Per-key sums over a repartition result, computed on each shard
    alone (keys are co-located, so no collective). Returns row-sharded
    segment arrays whose global index is ``shard * local_ks + key // n``
    (and the per-key minima of ``extra_min_col`` alongside)."""
    n_shards = t.mesh.shape[t.axis]
    local_ks = compressed_key_space(key_space, n_shards)
    sums, mins = [], []
    for i in range(n_shards):
        c, valid = t.local(i)
        ck = _floor_div(c[key_col], n_shards)
        sums.append(K.segment_sum(c[value_col], ck, local_ks, valid))
        if extra_min_col is not None:
            mins.append(K.segment_min(c[extra_min_col], ck, local_ks,
                                      valid))
    out = _sharded(t.mesh, t.axis, sums)
    if extra_min_col is None:
        return out
    return out, _sharded(t.mesh, t.axis, mins)


def _stable_top(s: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The k largest entries and their indices, ties to the lower index
    (``lax.top_k``'s order), by a stable descending sort."""
    vals, idx = torch.sort(s, descending=True, stable=True)
    return vals[:k], idx[:k]


def distributed_top_k(mesh: Mesh, axis: str, scores, k: int,
                      mask=None) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Global top-k over a row-sharded score vector whose global position
    encodes the key as ``local_index * n + shard``: a local top-k per
    shard, a gather of the n*k candidates in position order, the final
    top-k (the reference's TopK aggregation combine). Always returns k
    entries on the first position's device; slots past the available
    rows hold -inf and key -1. Ties go to the lower candidate index, as
    ``lax.top_k`` breaks them."""
    group = _group(mesh, axis)
    n_shards = len(group)
    sblocks = _blocks(scores, mesh, axis)
    mblocks = _blocks(mask, mesh, axis) if mask is not None else None
    vals, keys = [], []
    for i, s in enumerate(sblocks):
        sm = s if mblocks is None else torch.where(
            mblocks[i], s, torch.full_like(s, float("-inf")))
        v, idx = _stable_top(sm, min(k, sm.shape[0]))
        vals.append(v)
        keys.append(idx.to(torch.int32) * n_shards + i)
    dev0 = mesh.devices[group[0]]
    allv = position_gather(vals, 0, dev0)
    allk = position_gather(keys, 0, dev0)
    fk = min(k, allv.shape[0])
    fv, fi = _stable_top(allv, fk)
    fkeys = allk[fi]
    if fk < k:
        fv = torch.cat([fv, fv.new_full((k - fk,), float("-inf"))])
        fkeys = torch.cat([fkeys, fkeys.new_full((k - fk,), -1)])
    return fv, fkeys, fv > float("-inf")


# ------------------------------------------------------------------ Q03
def _mask_o_ok(c):
    return c["o_ok"]


def _mask_c_ok(c):
    return c["c_ok"]


def shuffle_q03(tables, mesh: Mesh, axis: str = "data",
                segment: str = "BUILDING", date: str = "1995-03-15",
                k: int = 10, slack: float = 2.0):
    """The row-output Q03 over a hand mesh (application code uses
    :func:`q03_row_sink_for` over placed sets):

    1. customer ⋈ orders (the planner broadcasts a dimension-sized
       customer, and repartitions both sides when it is fact-scale);
    2. orders and lineitem hash-repartitioned on orderkey and joined per
       shard over compressed keys, giving a sharded joined row table;
    3. a LOCAL per-order revenue and order-date aggregate;
    4. the distributed top-k.

    Returns the row dicts of ``queries.cq03``."""
    from netsdb_tpu_torch.relational import planner as PLN
    from netsdb_tpu_torch.relational.stats import key_space as ks_of
    from netsdb_tpu_torch.relational.table import date_to_int

    cust, orders, li = (tables["customer"], tables["orders"],
                        tables["lineitem"])
    d = date_to_int(date)
    n_shards = mesh.shape[axis]
    gks = max(ks_of(orders, "o_orderkey"), ks_of(li, "l_orderkey"))
    seg_code = cust.code("c_mktsegment", segment)
    cust_ok = cust["c_mktsegment"] == seg_code
    dev = mesh.devices[_group(mesh, axis)[0]]
    cust, orders, li = (t.to(dev) for t in (cust, orders, li))
    cust_ok = cust_ok.to(dev)

    cust_bytes = 8 * cust.num_rows  # the two columns the join carries
    if PLN.plan_distribution(cust_bytes,
                             n_shards).strategy == "broadcast":
        jp_cust = PLN.plan_join(cust, "c_custkey", orders, "o_custkey")
        _, chit = K.pk_fk_join(cust["c_custkey"], orders["o_custkey"],
                               cust_ok, plan=jp_cust)
        o_ok = chit & (orders["o_orderdate"] < d)
        build = {"o_orderkey": orders["o_orderkey"],
                 "o_orderdate": orders["o_orderdate"], "o_ok": o_ok}
        build_valid = None
    else:
        j1 = hash_join(
            mesh, axis,
            build={"c_custkey": cust["c_custkey"], "c_ok": cust_ok},
            build_key="c_custkey",
            probe={"o_orderkey": orders["o_orderkey"],
                   "o_custkey": orders["o_custkey"],
                   "o_orderdate": orders["o_orderdate"]},
            probe_key="o_custkey",
            key_space=max(ks_of(cust, "c_custkey"),
                          ks_of(orders, "o_custkey")),
            build_mask_fn=_mask_c_ok, slack=slack)
        check_overflow(j1)
        o_ok = _sharded(mesh, axis, [
            j1.local(i)[1] & j1.local(i)[0]["c_ok"]
            & (j1.local(i)[0]["o_orderdate"] < d) for i in range(n_shards)])
        build = {"o_orderkey": j1.cols["o_orderkey"],
                 "o_orderdate": j1.cols["o_orderdate"], "o_ok": o_ok}
        build_valid = j1.valid
    joined = hash_join(
        mesh, axis, build=build, build_key="o_orderkey",
        probe={"l_orderkey": li["l_orderkey"],
               "l_shipdate": li["l_shipdate"],
               "l_extendedprice": li["l_extendedprice"],
               "l_discount": li["l_discount"]},
        probe_key="l_orderkey", key_space=gks,
        build_mask_fn=_mask_o_ok, slack=slack, build_valid=build_valid)
    check_overflow(joined)
    return q03_finish(joined, gks, d, k)


def q03_finish(joined: ShardedRows, gks: int, d: int, k: int):
    """Phases 3–4 of the row-output Q03 over a joined ``ShardedRows``:
    the local per-order aggregate (no collective — the repartition
    bought co-location), the distributed top-k, the host decode. Shared
    by :func:`shuffle_q03` and :func:`q03_row_sink_for`."""
    from netsdb_tpu_torch.relational.table import int_to_date

    mesh, axis = joined.mesh, joined.axis
    n_shards = mesh.shape[axis]
    local_ks = compressed_key_space(gks, n_shards)
    rev, ok = [], []
    for i in range(n_shards):
        c, valid = joined.local(i)
        rev.append(c["l_extendedprice"] * (1.0 - c["l_discount"]))
        ok.append(valid & (c["l_shipdate"] > d))
    agg_in = ShardedRows(
        {"l_orderkey": joined.cols["l_orderkey"],
         "o_orderdate": joined.cols["o_orderdate"],
         "rev": _sharded(mesh, axis, rev)},
        _sharded(mesh, axis, ok), mesh, axis, joined.overflow)
    rev_sh, od_sh = segment_sum_by_key(agg_in, "l_orderkey", "rev", gks,
                                       extra_min_col="o_orderdate")
    pos_mask = _sharded(mesh, axis, [rev_sh.shards[p] > 0
                                     for p in _group(mesh, axis)])
    vals, gkeys, _ = distributed_top_k(mesh, axis, rev_sh, k,
                                       mask=pos_mask)
    vals = vals.cpu().numpy()
    gkeys = gkeys.cpu().numpy()
    od = od_sh.to_dense().cpu().numpy()  # shard * local_ks + ck
    rows = []
    for j in range(k):
        if not np.isfinite(vals[j]) or vals[j] <= 0:
            continue
        okey = int(gkeys[j])
        pos = (okey % n_shards) * local_ks + okey // n_shards
        rows.append({"okey": okey, "odate": int_to_date(int(od[pos])),
                     "revenue": float(vals[j])})
    rows.sort(key=lambda r: (-r["revenue"], r["odate"]))
    return rows


def q03_row_sink_for(client, db: str, segment: str = "BUILDING",
                     date: str = "1995-03-15", k: int = 10,
                     slack: float = 2.0, n_parts: Optional[int] = None):
    """The row-output shuffle Q03 as a Partition-node DAG over placed
    sets — no hand mesh: the mesh comes from the stored sets'
    placement, statistics from ``client.analyze_set``, and the plan is
    SCAN→JOIN(filter)→PARTITION ×2 →JOIN(local)→OUTPUT, the reference's
    partition-stage → join-stage pipeline."""
    from netsdb_tpu_torch.plan.computations import (Apply, Join, Partition,
                                                    ScanSet, WriteSet)
    from netsdb_tpu_torch.relational.dag import _fold_mask
    from netsdb_tpu_torch.relational.table import ColumnTable, date_to_int
    from netsdb_tpu_torch.storage.store import SetIdentifier

    info = {n: client.analyze_set(db, n)
            for n in ("customer", "orders", "lineitem")}
    gks = max(info["orders"]["stats"]["o_orderkey"].key_space,
              info["lineitem"]["stats"]["l_orderkey"].key_space)
    cust_ks = max(info["customer"]["stats"]["c_custkey"].key_space,
                  info["orders"]["stats"]["o_custkey"].key_space)
    seg_dict = info["customer"]["dicts"]["c_mktsegment"]
    # -1 for an unknown segment → empty result, not a build-time crash
    seg_code = seg_dict.index(segment) if segment in seg_dict else -1
    d = date_to_int(date)
    if n_parts is None:
        store = getattr(client, "store", None)
        pl = (store.placement_of(SetIdentifier(db, "lineitem"))
              if store is not None else None)
        if pl is None:
            raise ValueError(
                "q03_row_sink_for needs a placed lineitem set (the "
                "Partition nodes shuffle on its mesh) — or pass n_parts "
                "explicitly when building from a RemoteClient")
        n_parts = pl.axis_size(visible_devices(store.device.type))
    jp_cust = JoinPlan("lut", cust_ks)

    def filter_orders(orders: ColumnTable, cust: ColumnTable) -> ColumnTable:
        orders, cust = _fold_mask(orders), _fold_mask(cust)
        cust_ok = cust["c_mktsegment"] == seg_code
        _, chit = K.pk_fk_join(cust["c_custkey"], orders["o_custkey"],
                               cust_ok, plan=jp_cust)
        return ColumnTable({"o_orderkey": orders["o_orderkey"],
                            "o_orderdate": orders["o_orderdate"],
                            "o_ok": chit & (orders["o_orderdate"] < d)})

    def project_li(t: ColumnTable) -> ColumnTable:
        return t.select(["l_orderkey", "l_shipdate", "l_extendedprice",
                         "l_discount"])

    # both are row-decomposable in their first input: each position
    # filters (projects) its own rows, the result stays placed
    build = Join(ScanSet(db, "orders"), ScanSet(db, "customer"),
                 fn=filter_orders, label=f"q03rows-filter:{seg_code}:{d}",
                 rowwise=True)
    probe = Apply(ScanSet(db, "lineitem"), project_li,
                  label="q03rows-project", traceable=False, rowwise=True)
    pb = Partition(build, "o_orderkey", n_parts, label="part-orders")
    pp = Partition(probe, "l_orderkey", n_parts, label="part-lineitem")

    def join_and_finish(p: ShardedRows, b: ShardedRows):
        j = local_join(b, p, "o_orderkey", "l_orderkey", gks,
                       build_rows=info["orders"]["num_rows"],
                       probe_rows=info["lineitem"]["num_rows"],
                       build_mask_fn=_mask_o_ok)
        check_overflow(j)
        return q03_finish(j, gks, d, k)

    out = Join(pp, pb, fn=join_and_finish,
               label=f"q03rows-join:{gks}:{d}:{k}")
    return WriteSet(out, db, "q03_rows_out")
