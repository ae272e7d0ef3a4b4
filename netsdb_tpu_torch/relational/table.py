"""ColumnTable: a relation as a struct of torch columns on one device —
counterpart of ``netsdb_tpu/relational/table.py``.

- **Numeric columns** are ``int32`` / ``float32`` tensors (bool columns
  stay bool).
- **String columns** are dictionary-encoded at ingest: an ``int32`` code
  column plus a host-side ``list[str]`` dictionary, so a string
  predicate becomes an integer compare on the device.
- **Dates** are ``int32`` yyyymmdd, order-isomorphic to ISO strings.
- **Filters never shrink a table.** A filtered table keeps every row and
  carries a bool ``valid`` mask, which the aggregations apply;
  :meth:`ColumnTable.compact` is the one verb that drops rows.

The columns of one table live on one device. Construction from rows or
numpy builds the columns on the host, collects the planner's statistics
there (:mod:`~netsdb_tpu_torch.relational.stats`) and uploads each column
once; the statistics ride along in the table's per-instance cache, so
planning never reads a device column back. A table pickles through numpy.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device

_DATE_RE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})$")

# per-instance caches a table may carry (statistics, its compacted form);
# `to` carries the statistics, which describe the data, not the device
_STATS_ATTR = "_column_stats"


def date_to_int(s: str) -> int:
    """ISO date string → yyyymmdd int."""
    m = _DATE_RE.match(s)
    if not m:
        raise ValueError(f"not an ISO date: {s!r}")
    y, mo, d = m.groups()
    return int(y) * 10000 + int(mo) * 100 + int(d)


def int_to_date(v: int) -> str:
    v = int(v)
    return f"{v // 10000:04d}-{(v // 100) % 100:02d}-{v % 100:02d}"


def _encode_strings(values: List[str], is_date: bool):
    """ISO dates → yyyymmdd int32 (no dictionary); anything else →
    codes into the sorted set of its values. Returns ``(numpy codes,
    dictionary or None)``."""
    if is_date:
        return np.fromiter((date_to_int(v) for v in values), np.int32,
                           len(values)), None
    uniq = sorted(set(values))
    code = {s: i for i, s in enumerate(uniq)}
    return np.fromiter((code[v] for v in values), np.int32,
                       len(values)), uniq


def _host_column(a: np.ndarray) -> np.ndarray:
    """A numeric numpy column in the table's dtypes: signed ints →
    int32, floats → float32, anything else kept."""
    if a.dtype.kind == "i":
        return np.ascontiguousarray(a, dtype=np.int32)
    if a.dtype.kind == "f":
        return np.ascontiguousarray(a, dtype=np.float32)
    return np.ascontiguousarray(a)


def _from_host(cols: Dict[str, np.ndarray], dicts: Dict[str, List[str]],
               device) -> "ColumnTable":
    """Upload host columns once, with their statistics collected on the
    host first."""
    from netsdb_tpu_torch.relational.stats import analyze_columns

    dev = resolve_device(device)
    stats = analyze_columns(cols)
    # torch wants writable memory (a JAX array's numpy view is not)
    table = ColumnTable({n: torch.from_numpy(
        c if c.flags.writeable else c.copy()).to(dev)
        for n, c in cols.items()}, dicts)
    table.__dict__[_STATS_ATTR] = stats
    return table


@dataclasses.dataclass
class ColumnTable:
    """A relation: named columns on one device, an optional validity
    mask. ``dicts[name]`` present ⇒ ``cols[name]`` holds int32 codes
    into it. ``valid`` of None means every row is valid."""

    cols: Dict[str, torch.Tensor]
    dicts: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    valid: Optional[torch.Tensor] = None

    # --- construction -------------------------------------------------
    @staticmethod
    def from_rows(rows: Sequence[Dict[str, Any]],
                  date_cols: Sequence[str] = (),
                  device=None) -> "ColumnTable":
        """Build from row dicts on ``device`` (CUDA unless asked).
        Column kinds come from the first row: str → dictionary codes
        (yyyymmdd int32 when named in ``date_cols`` or shaped like an
        ISO date), bool → bool, int → int32, float → float32."""
        if not rows:
            raise ValueError("from_rows needs at least one row")
        cols: Dict[str, np.ndarray] = {}
        dicts: Dict[str, List[str]] = {}
        for name in rows[0]:
            v0 = rows[0][name]
            values = [r[name] for r in rows]
            if isinstance(v0, str):
                is_date = name in date_cols or bool(_DATE_RE.match(v0))
                cols[name], uniq = _encode_strings(values, is_date)
                if uniq is not None:
                    dicts[name] = uniq
            elif isinstance(v0, bool):
                cols[name] = np.asarray(values, np.bool_)
            elif isinstance(v0, int):
                cols[name] = np.asarray(values, np.int32)
            else:
                cols[name] = np.asarray(values, np.float32)
        return _from_host(cols, dicts, device)

    @staticmethod
    def from_columns(cols: Dict[str, Any],
                     dicts: Optional[Dict[str, List[str]]] = None,
                     date_cols: Sequence[str] = (),
                     valid=None, device=None) -> "ColumnTable":
        """Build from numpy columns on ``device`` (CUDA unless asked):
        numeric arrays as they are (ints → int32, floats → float32),
        arrays of strings dictionary-encoded (or dates). This is also
        how a JAX ``ColumnTable`` crosses over: ``{n: np.asarray(c)}``
        of its columns, its ``dicts`` and ``np.asarray(valid)``."""
        out: Dict[str, np.ndarray] = {}
        dd: Dict[str, List[str]] = {k: list(v) for k, v in (dicts or {}).items()}
        for name, arr in cols.items():
            a = np.asarray(arr)
            if a.dtype.kind in "OUS":
                vals = [str(x) for x in a.tolist()]
                is_date = name in date_cols or bool(
                    len(vals) and _DATE_RE.match(vals[0]))
                out[name], uniq = _encode_strings(vals, is_date)
                if uniq is not None:
                    dd[name] = uniq
            else:
                out[name] = _host_column(a)
        table = _from_host(out, dd, device)
        if valid is not None:
            table.valid = torch.from_numpy(np.array(valid, np.bool_)).to(
                next(iter(table.cols.values())).device)
        return table

    # --- shape / access ----------------------------------------------
    @property
    def num_rows(self) -> int:
        return int(next(iter(self.cols.values())).shape[0])

    @property
    def device(self) -> torch.device:
        return next(iter(self.cols.values())).device

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.cols[name]

    def mask(self) -> torch.Tensor:
        """Validity as a bool tensor (all true if unset)."""
        if self.valid is not None:
            return self.valid
        return torch.ones((self.num_rows,), dtype=torch.bool,
                          device=self.device)

    def code(self, name: str, value: str) -> int:
        """Dictionary code of ``value`` in column ``name``; -1 if absent
        (compares false against every row)."""
        try:
            return self.dicts[name].index(value)
        except ValueError:
            return -1

    def codes_where(self, name: str, pred) -> List[int]:
        """Every code whose string satisfies ``pred`` (LIKE-style
        predicates run once over the dictionary, not per row)."""
        return [i for i, s in enumerate(self.dicts[name]) if pred(s)]

    def decode(self, name: str, code: int) -> str:
        return self.dicts[name][int(code)]

    def to(self, device) -> "ColumnTable":
        """The same relation on ``device``, with its statistics."""
        dev, here = torch.device(device), self.device
        if dev.type == here.type and dev.index in (None, here.index):
            return self
        out = ColumnTable({n: c.to(dev) for n, c in self.cols.items()},
                          self.dicts,
                          None if self.valid is None else self.valid.to(dev))
        stats = self.__dict__.get(_STATS_ATTR)
        if stats is not None:
            out.__dict__[_STATS_ATTR] = dict(stats)
        return out

    def compact(self) -> "ColumnTable":
        """Drop invalid rows and return a mask-free table (the bridge
        from a filtered stored table to the direct query path, which
        assumes every row is real). The row selection runs on the
        table's device; the result is memoised on the table."""
        if self.valid is None:
            return self
        cached = self.__dict__.get("_compacted")
        if cached is not None:
            return cached
        if bool(self.valid.all()):
            out = ColumnTable(self.cols, self.dicts, None)
        else:
            idx = torch.nonzero(self.valid).flatten()
            out = ColumnTable({n: c.index_select(0, idx)
                               for n, c in self.cols.items()},
                              self.dicts, None)
        self.__dict__["_compacted"] = out
        return out

    # --- relational verbs (mask algebra) ------------------------------
    def filter(self, mask: torch.Tensor) -> "ColumnTable":
        """AND a predicate mask into validity. Shapes unchanged."""
        new = mask if self.valid is None else (self.valid & mask)
        return ColumnTable(self.cols, self.dicts, new)

    def select(self, names: Sequence[str]) -> "ColumnTable":
        return ColumnTable({n: self.cols[n] for n in names},
                           {n: d for n, d in self.dicts.items() if n in names},
                           self.valid)

    def with_column(self, name: str, arr: torch.Tensor,
                    dictionary: Optional[List[str]] = None) -> "ColumnTable":
        cols = dict(self.cols)
        cols[name] = arr
        dicts = dict(self.dicts)
        if dictionary is not None:
            dicts[name] = dictionary
        return ColumnTable(cols, dicts, self.valid)

    # --- persistence --------------------------------------------------
    def __getstate__(self):
        """Pickle through host numpy; unpickling puts the columns on the
        CPU (the store moves them to its device)."""
        return {"cols": {n: c.detach().cpu().numpy()
                         for n, c in self.cols.items()},
                "dicts": self.dicts,
                "valid": (None if self.valid is None
                          else self.valid.detach().cpu().numpy())}

    def __setstate__(self, state):
        self.cols = {n: torch.from_numpy(np.array(c))
                     for n, c in state["cols"].items()}
        self.dicts = state["dicts"]
        v = state["valid"]
        self.valid = None if v is None else torch.from_numpy(np.array(v))

    # --- host materialisation ------------------------------------------
    def to_rows(self, date_cols: Sequence[str] = ()) -> List[Dict[str, Any]]:
        """Decode to row dicts, invalid rows dropped. Host-side: for
        tests and result iteration, not the hot path."""
        host = {n: c.detach().cpu().numpy() for n, c in self.cols.items()}
        ok = self.mask().detach().cpu().numpy()
        out = []
        for i in range(len(ok)):
            if not ok[i]:
                continue
            row = {}
            for n, c in host.items():
                v = c[i]
                if n in self.dicts:
                    row[n] = self.dicts[n][int(v)]
                elif n in date_cols:
                    row[n] = int_to_date(int(v))
                elif c.dtype.kind == "f":
                    row[n] = float(v)
                elif c.dtype.kind == "b":
                    row[n] = bool(v)
                else:
                    row[n] = int(v)
            out.append(row)
        return out


def merge_dicts(base: Sequence[str], other: Sequence[str]):
    """Merge two column dictionaries: ``other``'s new entries extend
    ``base``'s, and the returned int32 LUT carries each ``other`` code
    into the merged space. Returns ``(merged, remap)``."""
    merged = {s: i for i, s in enumerate(base)}
    remap = np.empty(len(other), np.int32)
    for code, s in enumerate(other):
        if s not in merged:
            merged[s] = len(merged)
        remap[code] = merged[s]
    return list(merged), remap


def concat_tables(a: ColumnTable, b: ColumnTable) -> ColumnTable:
    """Append ``b``'s rows to ``a``'s on ``a``'s device: ``b``'s
    dictionary codes remap into the merged dictionaries (host work over
    the dictionaries, one gather on the device), columns and validity
    masks concatenate. The result's statistics are collected where its
    columns live when a plan first asks (a min/max reduction per
    column)."""
    from netsdb_tpu_torch.relational.kernels import take

    if set(a.cols) != set(b.cols):
        raise ValueError(f"schema mismatch: {sorted(a.cols)} vs "
                         f"{sorted(b.cols)}")
    dev = a.device
    b = b.to(dev)
    cols: Dict[str, torch.Tensor] = {}
    dicts: Dict[str, List[str]] = {}
    for name in a.cols:
        ca, cb = a[name], b[name]
        da, db = a.dicts.get(name), b.dicts.get(name)
        if (da is None) != (db is None):
            raise ValueError(f"column {name!r}: dictionary-encoded on "
                             f"one side only")
        if da is not None:
            merged, remap = merge_dicts(da, db)
            if len(remap):
                cb = take(torch.from_numpy(remap).to(dev), cb)
            dicts[name] = merged
        cols[name] = torch.cat([ca, cb])
    valid = None
    if a.valid is not None or b.valid is not None:
        valid = torch.cat([a.mask(), b.mask()])
    return ColumnTable(cols, dicts, valid)
