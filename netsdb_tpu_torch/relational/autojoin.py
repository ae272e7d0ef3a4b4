"""Device equi-joins for string-keyed host records — counterpart of
``netsdb_tpu/relational/autojoin.py``.

- :func:`table_from_objects` columnarises records (dicts, dataclasses,
  namedtuples, plain attribute objects) through ``ColumnTable.from_rows``:
  string columns are dictionary-encoded on the host, as TPC-H's are.
- :func:`equijoin` joins two tables on a key column, string or int: the
  two dictionaries are unified on the host (:func:`unify_key_codes`,
  the right table's codes remapped into the left's code space in
  O(|dictionary|)), and the join itself is one
  :func:`~netsdb_tpu_torch.relational.kernels.pk_fk_join` on the
  tables' device.

Strings never reach the device: only int32 codes do, and a remap table
goes up through pinned memory, so the upload does not wait for the
card. A probe row whose key the build side lacks is dropped through the
join's hit mask; every gather reads a clamped index.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational.queries import _upload
from netsdb_tpu_torch.relational.table import (ColumnTable, concat_tables,
                                               merge_dicts)

__all__ = ["table_from_objects", "merge_dicts", "unify_key_codes",
           "concat_tables", "equijoin"]


def _record_to_row(obj: Any) -> Dict[str, Any]:
    if isinstance(obj, dict):
        return obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if hasattr(obj, "_asdict"):  # namedtuple
        return obj._asdict()
    return {k: v for k, v in vars(obj).items() if not k.startswith("_")}


def table_from_objects(objs: Sequence[Any], date_cols: Sequence[str] = (),
                       device=None) -> ColumnTable:
    """Host records → a ColumnTable on ``device`` (CUDA unless asked),
    strings dictionary-encoded on the host."""
    return ColumnTable.from_rows([_record_to_row(o) for o in objs],
                                 date_cols, device=device)


def unify_key_codes(left: ColumnTable, left_key: str,
                    right: ColumnTable, right_key: str
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Both key columns in one integer code space: ``(left codes, right
    codes, key space)``. Int keys pass through (the key space is their
    maximum + 1, from the ingest statistics where the tables carry
    them); dictionary keys are unified on the host, the merged
    dictionary extending the left's, and the right's codes remap by one
    gather on the device."""
    from netsdb_tpu_torch.relational.stats import key_space

    l_dict = left.dicts.get(left_key)
    r_dict = right.dicts.get(right_key)
    if (l_dict is None) != (r_dict is None):
        raise ValueError(
            f"join key type mismatch: {left_key!r} "
            f"{'string' if l_dict else 'int'} vs {right_key!r} "
            f"{'string' if r_dict else 'int'}")
    lc, rc = left[left_key], right[right_key]
    if l_dict is None:
        space = max(key_space(left, left_key) if left.num_rows else 1,
                    key_space(right, right_key) if right.num_rows else 1)
        return lc, rc, space
    merged, remap = merge_dicts(l_dict, r_dict)
    if len(remap):
        rc = K.take(_upload(remap, rc.device), rc)
    return lc, rc, len(merged)


def equijoin(left: ColumnTable, left_key: str,
             right: ColumnTable, right_key: str,
             take: Optional[Sequence[str]] = None,
             prefix: str = "r_") -> ColumnTable:
    """Inner PK-FK equi-join on the device: ``right`` is the build side
    (unique keys), ``left`` the probe. Returns the left table with the
    ``take`` columns of the right gathered onto it (named ``prefix +
    col`` where the name is taken), its validity ANDed with the hit
    mask."""
    lc, rc, space = unify_key_codes(left, left_key, right, right_key)
    ridx, hit = K.pk_fk_join(rc, lc, pk_mask=right.valid,
                             fk_mask=left.valid, key_space=space)
    out = left.filter(hit)
    for col in (take if take is not None else right.cols):
        if col == right_key:
            continue
        name = col if col not in out.cols else prefix + col
        out = out.with_column(name, K.take(right[col], ridx),
                              right.dicts.get(col))
    return out
