"""Vectorised relational kernels over torch columns — counterpart of
``netsdb_tpu/relational/kernels.py``.

Each kernel is one of the reference's executor families
(``src/queryExecution``):

- group-by + aggregate → masked segment reductions, three ways: a
  broadcast compare reduced over row chunks (``"dense"``), an indexed
  add / scatter-reduce (``"scatter"``), and for counts an exact one-hot
  product over a (hi, lo) key grid (``"grid"``);
- equi-join → a dense lookup table (scatter build, gather probe) or a
  stable argsort + ``searchsorted``;
- semi-join → membership through the join's hit mask;
- top-k → a stable descending sort, so ties go to the lower index as
  ``lax.top_k`` gives them.

The reference computes these with ``jnp``/``lax`` and leaves them to
XLA; no Pallas kernel lies under them, so the port's are torch ops.

Rules that hold everywhere:

- **Masked rows** contribute identity elements (0 for sum and count,
  ±inf or the int extremes for min and max) or a key sentinel that
  matches nothing; no kernel changes a shape.
- **Orphan keys** (a segment id or join key outside the key space) are
  dropped, never credited to the last segment.
- **Every gather and scatter index is in range by construction** (a
  clamp under a mask): on a card a bad index is a device assert that
  ends the process. Where the reference gathers with ``jnp.take`` at an
  index that may be out of range, :func:`take` gives its value.
- **Constants enter as Python scalars**, never as tensors copied from
  the host, so no kernel call waits for the card.
- **Integers are exact**: counts, keys, minima, histograms and join hits
  never go through float accumulation that could round. Float sums on a
  card use atomics and vary in their last bits from run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_I32_SENTINEL = -2147483648
# elements of one (rows, groups) block of the dense reduce: the rows go
# in chunks so memory stays O(rows) at any group count
_DENSE_CHUNK_ELEMS = 1 << 26
# elements of one one-hot operand of the grid count; a chunk also never
# exceeds 2**24 rows, so its f32 product counts are exact integers
_GRID_CHUNK_ELEMS = 1 << 26
_GRID_MAX_ROWS = 1 << 24


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an out-of-range index."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(a, idx)`` along axis 0: a negative index counts from
    the end, and an index still outside ``[0, n)`` gives the fill (NaN,
    the int minimum, or True). The gather itself reads a clamped index."""
    n = a.shape[0]
    if n == 0:
        return torch.full(tuple(idx.shape) + tuple(a.shape[1:]),
                          _fill_value(a.dtype), dtype=a.dtype,
                          device=a.device)
    w = torch.where(idx < 0, idx + n, idx)
    ok = (w >= 0) & (w < n)
    got = a.index_select(0, w.clamp(0, n - 1).flatten()).reshape(
        tuple(idx.shape) + tuple(a.shape[1:]))
    if a.dim() > 1:
        ok = ok.reshape(tuple(ok.shape) + (1,) * (a.dim() - 1))
    return torch.where(ok, got, _fill_value(a.dtype))


def _masked(values: torch.Tensor, mask: Optional[torch.Tensor],
            identity) -> torch.Tensor:
    if mask is None:
        return values
    return torch.where(mask, values, identity)


def _kind(t: torch.Tensor) -> str:
    from netsdb_tpu_torch.relational import tuning

    return tuning.device_kind(t.device)


# --- group-by aggregates ---------------------------------------------

def _in_range(segment_ids: torch.Tensor, num_segments: int,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows whose segment id lies outside [0, num_segments) are dropped
    (an orphan key must not be credited to the last segment)."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return ok if mask is None else (ok & mask)


def _use_dense(num_segments: int, method: Optional[str],
               like: torch.Tensor) -> bool:
    """Dense or scatter: ``method`` forces one; otherwise the planner's
    threshold for the device kind of ``like``."""
    if method is not None:
        return method == "dense"
    from netsdb_tpu_torch.relational import planner

    return planner.segment_method(num_segments, _kind(like)) == "dense"


def _dense_segment_reduce(v: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int, identity, op: str
                          ) -> torch.Tensor:
    """(N,) → (G,) by a broadcast compare and a column reduce, over row
    chunks of at most ``_DENSE_CHUNK_ELEMS // G`` rows. ``v`` already
    holds ``identity`` in dropped rows; ``op`` is sum, amin or amax."""
    dev = v.device
    out = torch.full((num_segments,), identity, dtype=v.dtype, device=dev)
    n = v.shape[0]
    if n == 0 or num_segments == 0:
        return out
    groups = torch.arange(num_segments, dtype=segment_ids.dtype, device=dev)
    rows = max(1, _DENSE_CHUNK_ELEMS // num_segments)
    for s in range(0, n, rows):
        eq = segment_ids[s:s + rows, None] == groups
        blk = torch.where(eq, v[s:s + rows, None], identity)
        if op == "sum":
            out += blk.sum(0, dtype=v.dtype)
        elif op == "amin":
            out = torch.minimum(out, blk.amin(0))
        else:
            out = torch.maximum(out, blk.amax(0))
    return out


def _scatter_reduce(v: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, identity, op: str,
                    ok: torch.Tensor) -> torch.Tensor:
    """(N,) → (G,) by an indexed add or scatter-reduce. ``v`` already
    holds ``identity`` in the rows ``ok`` drops; those rows go to slots
    spread by row number, never to one shared slot: millions of atomics
    onto one address serialise (a join's misses all carry index 0, and
    with that index the Q03 fold's revenue sum took 100 ms on the
    card)."""
    out = torch.full((num_segments,), identity, dtype=v.dtype,
                     device=v.device)
    n = v.shape[0]
    if num_segments == 0 or n == 0:
        return out
    spread = torch.arange(n, dtype=segment_ids.dtype,
                          device=v.device) % num_segments
    ids = torch.where(ok, segment_ids, spread)
    if op == "sum":
        return out.index_add_(0, ids, v)
    return out.scatter_reduce_(0, ids.long(), v, reduce=op,
                               include_self=True)


def _extremes(dtype: torch.dtype) -> Tuple[object, object]:
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                method: Optional[str] = None) -> torch.Tensor:
    """Per-segment sum; masked and out-of-range rows contribute 0."""
    ok = _in_range(segment_ids, num_segments, mask)
    v = _masked(values, ok, 0)
    if _use_dense(num_segments, method, values):
        return _dense_segment_reduce(v, segment_ids, num_segments, 0, "sum")
    return _scatter_reduce(v, segment_ids, num_segments, 0, "sum", ok)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None,
                  method: Optional[str] = None) -> torch.Tensor:
    """Per-segment int32 counts: ``"dense"``, ``"grid"`` or
    ``"scatter"``, the planner's choice when ``method`` is None."""
    if method is None:
        from netsdb_tpu_torch.relational import planner

        method = planner.count_method(num_segments, _kind(segment_ids))
    if method == "grid":
        return count_grid(segment_ids, num_segments, mask)
    ones = torch.ones(segment_ids.shape, dtype=torch.int32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask, method)


def _grid_reduce(folded_ids: torch.Tensor, key_space: int,
                 block: int) -> torch.Tensor:
    """Occurrence counts of ``folded_ids`` (dropped rows hold -1) as an
    (H, block) int32 grid: per row chunk, the one-hot (H, rows) × (rows,
    block) product of the ids' high and low parts. Every product entry
    is a count of at most 2**24, exact in f32, and the chunks add in
    int32."""
    H = (key_space + block - 1) // block
    dev = folded_ids.device
    grid = torch.zeros((H, block), dtype=torch.int32, device=dev)
    n = folded_ids.shape[0]
    if n == 0 or H == 0:
        return grid
    hi = torch.div(folded_ids, block, rounding_mode="floor")
    lo = folded_ids - hi * block
    hs = torch.arange(H, dtype=folded_ids.dtype, device=dev)
    ls = torch.arange(block, dtype=folded_ids.dtype, device=dev)
    rows = max(1, min(_GRID_MAX_ROWS, _GRID_CHUNK_ELEMS // (H + block)))
    for s in range(0, n, rows):
        m2 = (hs[:, None] == hi[None, s:s + rows]).to(torch.float32)
        m1 = (lo[s:s + rows, None] == ls[None, :]).to(torch.float32)
        grid += torch.mm(m2, m1).round_().to(torch.int32)
    return grid


def count_grid(segment_ids: torch.Tensor, num_segments: int,
               mask: Optional[torch.Tensor] = None,
               block: int = 128) -> torch.Tensor:
    """Exact per-segment counts on the grid path: masked and
    out-of-range rows fold into the id as -1, which matches no cell."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    if mask is not None:
        ok = ok & mask
    am = torch.where(ok, segment_ids, -1)
    return _grid_reduce(am, num_segments, block).reshape(-1)[:num_segments]


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                method: Optional[str] = None) -> torch.Tensor:
    """Per-segment min; empty segments hold +inf (float) or the int
    maximum."""
    big, _ = _extremes(values.dtype)
    ok = _in_range(segment_ids, num_segments, mask)
    v = _masked(values, ok, big)
    if _use_dense(num_segments, method, values):
        return _dense_segment_reduce(v, segment_ids, num_segments, big,
                                     "amin")
    return _scatter_reduce(v, segment_ids, num_segments, big, "amin", ok)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: Optional[torch.Tensor] = None,
                method: Optional[str] = None) -> torch.Tensor:
    """Per-segment max; empty segments hold -inf or the int minimum."""
    _, small = _extremes(values.dtype)
    ok = _in_range(segment_ids, num_segments, mask)
    v = _masked(values, ok, small)
    if _use_dense(num_segments, method, values):
        return _dense_segment_reduce(v, segment_ids, num_segments, small,
                                     "amax")
    return _scatter_reduce(v, segment_ids, num_segments, small, "amax", ok)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None,
                 method: Optional[str] = None) -> torch.Tensor:
    """Per-segment mean; empty segments give 0."""
    s = segment_sum(values.to(torch.float32), segment_ids, num_segments,
                    mask, method)
    c = segment_count(segment_ids, num_segments, mask, method)
    return s / c.clamp(min=1).to(torch.float32)


def bincount_masked(values: torch.Tensor, length: int,
                    mask: Optional[torch.Tensor] = None,
                    method: Optional[str] = None) -> torch.Tensor:
    """Histogram of small non-negative ints (Q13's count of counts)."""
    return segment_count(values, length, mask, method)


# --- joins ------------------------------------------------------------

def _sentineled(keys: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return keys
    return torch.where(mask, keys, _I32_SENTINEL)


def pk_fk_join(pk_keys: torch.Tensor, fk_keys: torch.Tensor,
               pk_mask: Optional[torch.Tensor] = None,
               fk_mask: Optional[torch.Tensor] = None,
               key_space: Optional[int] = None, plan=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equi-join a unique-key build side into a foreign-key probe side.
    Returns ``(gather_idx, match_mask)``, both shaped like ``fk_keys``:
    probe row i matches build row ``gather_idx[i]`` iff
    ``match_mask[i]``; ``gather_idx`` is always a valid build row (0
    where nothing matched).

    ``plan`` (a :class:`~netsdb_tpu_torch.relational.planner.JoinPlan`)
    picks the strategy; ``key_space`` alone forces the LUT.

    LUT: a deterministic scatter-max of row numbers over the key space,
    so duplicate build keys keep the highest row (the last writer, as the
    reference's scatter leaves it on the CPU). A build row that is masked
    or outside ``[0, key_space)`` writes -1, which never wins, at a slot
    spread by its row number: no shared trash slot, so no atomics pile
    onto one address (with one, a query that masked most of a 15 M-row
    build side took 0.8 s on the card). Sort: the build keys (masked
    ones set to the int32 minimum) in a stable argsort, probed with
    ``searchsorted`` (leftmost match, so the lowest build row of a
    duplicated key)."""
    if plan is not None:
        key_space = plan.key_space if plan.strategy == "lut" else None
    dev = fk_keys.device
    p = pk_keys.shape[0]
    if p == 0:
        return (torch.zeros(fk_keys.shape, dtype=torch.int32, device=dev),
                torch.zeros(fk_keys.shape, dtype=torch.bool, device=dev))
    if key_space is not None:
        ks = max(int(key_space), 1)
        valid_pk = (pk_keys >= 0) & (pk_keys < ks)
        if pk_mask is not None:
            valid_pk = valid_pk & pk_mask
        rows = torch.arange(p, dtype=torch.int32, device=dev)
        slot = torch.where(valid_pk, pk_keys, rows % ks)
        lut = torch.full((ks,), -1, dtype=torch.int32, device=dev)
        lut.scatter_reduce_(0, slot.long(), torch.where(valid_pk, rows, -1),
                            reduce="amax", include_self=True)
        fk_in = (fk_keys >= 0) & (fk_keys < ks)
        pos = lut.index_select(0, fk_keys.clamp(0, ks - 1).flatten()
                               ).reshape(fk_keys.shape)
        hit = fk_in & (pos >= 0)
        if fk_mask is not None:
            hit = hit & fk_mask
        return pos.clamp(min=0), hit
    pk = _sentineled(pk_keys, pk_mask)
    pk_sorted, order = torch.sort(pk, stable=True)
    pos = torch.searchsorted(pk_sorted, fk_keys.contiguous(),
                             out_int32=True)
    pos_c = pos.clamp(0, p - 1)
    hit = pk_sorted.index_select(0, pos_c.flatten()).reshape(
        fk_keys.shape) == fk_keys
    if fk_mask is not None:
        hit = hit & fk_mask
    # masked build rows carry the sentinel: a probe key equal to it would
    # false-match
    hit = hit & (fk_keys != _I32_SENTINEL)
    idx = order.index_select(0, pos_c.flatten()).reshape(fk_keys.shape)
    return idx.to(torch.int32), hit


def member(build_keys: torch.Tensor, probe_keys: torch.Tensor,
           build_mask: Optional[torch.Tensor] = None,
           probe_mask: Optional[torch.Tensor] = None,
           key_space: Optional[int] = None, plan=None) -> torch.Tensor:
    """Semi-join: does any valid build row share the probe row's key?
    (Q04 EXISTS, Q22 NOT EXISTS.) Build keys need not be unique."""
    _, hit = pk_fk_join(build_keys, probe_keys, build_mask, probe_mask,
                        key_space, plan)
    return hit


def any_by_key(keys: torch.Tensor, flag: torch.Tensor, key_space: int,
               method: Optional[str] = None) -> torch.Tensor:
    """Per row, int32: does any row sharing its key have ``flag`` set?
    (The self-semi-join of the reddit label propagation.) The flagged
    rows are counted per key (exactly, by ``segment_count``'s
    ``method``) and each row reads its key's count; out-of-range keys
    give 0 and count for nothing."""
    counts = segment_count(keys, key_space, flag != 0, method)
    kin = (keys >= 0) & (keys < key_space)
    if key_space <= 0:
        return kin.to(torch.int32)
    got = (counts > 0).index_select(0, keys.clamp(0, key_space - 1))
    return (got & kin).to(torch.int32)


def top_k_masked(scores: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the k largest valid scores, ties to the lower index
    (as ``lax.top_k``), by a stable descending sort. Returns ``(idx,
    valid)``; ``valid[j]`` is False when fewer than j+1 rows were
    valid."""
    s = scores.to(torch.float32)
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    vals, order = torch.sort(s, descending=True, stable=True)
    return order[:k].to(torch.int32), vals[:k] > float("-inf")
