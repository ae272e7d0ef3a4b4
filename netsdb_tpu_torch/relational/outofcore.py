"""Out-of-core relational execution: relations paged in the page arena —
counterpart of ``netsdb_tpu/relational/outofcore.py``.

The reference system streams every set through its pipelines page by
page (``src/storage/headers/PageScanner.h``, ``PageCircularBuffer.h``).
A relation set created with ``storage="paged"`` does the same here: its
columns live as row-chunk pages of the native page arena (whose pool cap
spills cold pages to disk), and a query folds one chunk step over the
stream (:class:`~netsdb_tpu_torch.plan.fold.FoldSpec`, run by
``plan/executor.py``).

:class:`PagedColumns` packs the int and float columns into two page
matrices with one row blocking, so a stream round yields every column of
the same rows. :meth:`PagedColumns.stream_tables` stages each round on
the relation's device through :mod:`~netsdb_tpu_torch.plan.staging`
(pinned buffers and the copy stream on a card): both matrices are
uploaded whole, padded on the device to the row bucket and transposed
there, so each column of a chunk is one contiguous row of it. Chunks of
store-owned relations go through the device block cache; cached chunks
are never written.

:func:`partition_by_key` is the grace hash's partition pass, a pure host
pass in numpy (the key mix multiplies in uint64). The thin runners
(:func:`run_fold`, :func:`ooc_q01`, :func:`ooc_q06`,
:func:`build_q03_side`, :func:`ooc_q03`, :func:`bench_out_of_core`,
:func:`bench_paged_set_api`) run the same folds without a DAG.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.relational.stats import (ColumnStats, analyze_array,
                                               inject_stats)
from netsdb_tpu_torch.relational.table import ColumnTable, date_to_int
from netsdb_tpu_torch.storage.paged import PagedTensorStore
from netsdb_tpu_torch.utils.locks import RWLock

_INT_KINDS = "ib"
_SUFFIXES = (".int", ".float")


def _host_cols(table: ColumnTable, names) -> Dict[str, np.ndarray]:
    return {n: table[n].detach().cpu().numpy() for n in names}


class PagedColumns:
    """A relation's columns paged as row chunks in a
    :class:`~netsdb_tpu_torch.storage.paged.PagedTensorStore`.

    Integer (and bool) columns pack into one int32 page matrix, float
    columns into one float32 matrix, with a shared row blocking.
    Dictionaries, statistics and the row count stay on the host; chunks
    are staged to ``device``. Streams hold ``rw``'s read side, appends,
    updates and drops its write side. The store binds ``devcache``,
    ``cache_scope`` and ``cache_version_fn`` for store-owned relations
    only: grace partitions and temporaries stay uncached."""

    def __init__(self, store: PagedTensorStore, name: str,
                 int_names: List[str], float_names: List[str],
                 num_rows: int, row_block: int,
                 dicts: Optional[Dict[str, List[str]]] = None,
                 stats: Optional[Dict[str, ColumnStats]] = None,
                 device=None):
        self.store = store
        self.name = name
        self.int_names = int_names
        self.float_names = float_names
        self.num_rows = num_rows
        self.row_block = row_block
        self.dicts = dicts or {}
        self.stats = stats or {}
        self.device = resolve_device(device)
        self.rw = RWLock()
        self.dropped = False
        # chunks read out of the arena over the relation's lifetime (the
        # grace hash's one-pass check reads it)
        self.pages_streamed = 0
        self.devcache = None
        self.cache_scope = None
        self.cache_version_fn = None
        self.program_scope = None  # the store's name of the set for programs
        # the store's placement of the set (None: unplaced), read when a
        # stream starts: a placed relation's chunks are sharded over its
        # mesh
        self.placement_fn = None
        # this handle's own write count, part of every whole-run key
        self._mutations = 0

    # ------------------------------------------------------------ ingest
    @staticmethod
    def _pack(cols: Dict[str, np.ndarray], int_names: List[str],
              float_names: List[str]):
        """Columns → (int32 matrix, float32 matrix, row count): the one
        packing of ingest and append."""
        lengths = {n: len(np.asarray(c)) for n, c in cols.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns cannot page together: "
                             f"{lengths}")
        n = next(iter(lengths.values()))
        imat = (np.stack([np.asarray(cols[c]).astype(np.int32)
                          for c in int_names], axis=1)
                if int_names else None)
        fmat = (np.stack([np.asarray(cols[c]).astype(np.float32)
                          for c in float_names], axis=1)
                if float_names else None)
        return imat, fmat, n

    @staticmethod
    def ingest(store: PagedTensorStore, name: str,
               cols: Dict[str, np.ndarray], row_block: Optional[int] = None,
               dicts: Optional[Dict[str, List[str]]] = None,
               device=None) -> "PagedColumns":
        """Page a dict of host columns. ``row_block`` defaults so that one
        round of both matrices is about the configured page size; the
        int columns' statistics are collected in the same pass."""
        int_names = sorted(n for n, c in cols.items()
                           if np.asarray(c).dtype.kind in _INT_KINDS)
        float_names = sorted(n for n in cols if n not in int_names)
        imat, fmat, num_rows = PagedColumns._pack(cols, int_names,
                                                  float_names)
        if row_block is None:
            width = max(len(int_names) + len(float_names), 1)
            row_block = max(store.config.page_size_bytes // (4 * width),
                            1024)
        row_block = max(min(row_block, num_rows), 1)
        stats = {}
        if imat is not None:
            stats = {n: analyze_array(imat[:, j])
                     for j, n in enumerate(int_names)}
            store.put(f"{name}.int", imat, row_block=row_block)
        if fmat is not None:
            store.put(f"{name}.float", fmat, row_block=row_block)
        return PagedColumns(store, name, int_names, float_names, num_rows,
                            row_block, dicts, stats, device)

    @staticmethod
    def from_table(store: PagedTensorStore, name: str, table: ColumnTable,
                   columns: List[str], row_block: Optional[int] = None,
                   device=None) -> "PagedColumns":
        """Page ``columns`` of a table; the relation stages to the
        table's device unless ``device`` is given."""
        return PagedColumns.ingest(
            store, name, _host_cols(table, columns), row_block,
            dicts={n: d for n, d in table.dicts.items() if n in columns},
            device=table.device if device is None else device)

    # ------------------------------------------------------------ writes
    def _invalidate(self, start: int, end: Optional[int],
                    columns=None) -> None:
        if (self.devcache is not None and self.cache_scope is not None
                and self.devcache.partial):
            self.devcache.invalidate_range(self.cache_scope, start, end,
                                           columns=columns)

    def append(self, cols: Dict[str, np.ndarray]) -> None:
        """Append a batch as more pages (no page is rewritten). Atomic
        over both matrices: a failed write rolls both back to their page
        counts before the batch, and the statistics and row count change
        only after both writes succeed. Cached blocks of the old rows
        survive; only the appended range is dirty."""
        if set(cols) != set(self.int_names) | set(self.float_names):
            raise ValueError(
                f"append schema mismatch: have "
                f"{sorted(set(self.int_names) | set(self.float_names))}, "
                f"got {sorted(cols)}")
        for n in self.int_names:
            # packing casts by the stored classification: a float batch
            # would truncate silently
            if np.asarray(cols[n]).dtype.kind not in _INT_KINDS:
                raise TypeError(
                    f"append column {n!r} is float-valued but the stored "
                    f"column is int-classified; casting would truncate — "
                    f"convert explicitly first")
        imat, fmat, n_new = self._pack(cols, self.int_names,
                                       self.float_names)
        if n_new == 0:
            return
        with self.rw.write():
            if self.dropped:
                raise KeyError(f"paged relation {self.name!r} was dropped; "
                               f"cannot append")
            undo = []
            for suffix, mat in zip(_SUFFIXES, (imat, fmat)):
                if mat is None:
                    continue
                full = self.name + suffix
                undo.append((full, self.store.num_blocks(full)))
                try:
                    self.store.put(full, mat, append=True)
                except Exception:
                    for uname, npages in undo:
                        self.store.truncate_to(uname, npages, self.num_rows)
                    raise
            for j, name in enumerate(self.int_names):
                new, old = analyze_array(imat[:, j]), self.stats.get(name)
                self.stats[name] = new if old is None else ColumnStats(
                    old.n_rows + new.n_rows, min(old.min_val, new.min_val),
                    max(old.max_val, new.max_val), -1)
            n_before = self.num_rows
            self.num_rows += n_new
            self._mutations += 1
        self._invalidate(n_before, self.num_rows)

    def update_column(self, name: str, values) -> None:
        """Overwrite one column in place (same row count): each page is
        rewritten where it sits, and the device cache drops only the
        blocks of streams that held this column."""
        values = np.asarray(values)
        if name in self.dicts:
            raise ValueError(f"update_column: {name!r} is dict-encoded — "
                             f"update through re-ingest (codes would be "
                             f"meaningless)")
        if name in self.int_names:
            if values.dtype.kind not in _INT_KINDS:
                raise TypeError(f"update_column {name!r}: the stored column "
                                f"is int-classified; casting floats would "
                                f"truncate")
            suffix, names = ".int", self.int_names
        elif name in self.float_names:
            suffix, names = ".float", self.float_names
        else:
            raise KeyError(f"no column {name!r} in {self.name!r}")
        if len(values) != self.num_rows:
            raise ValueError(f"update_column {name!r}: {len(values)} values "
                             f"for {self.num_rows} rows (an update in place "
                             f"replaces the whole column)")
        full, j = self.name + suffix, names.index(name)
        with self.rw.write():
            if self.dropped:
                raise KeyError(f"paged relation {self.name!r} was dropped; "
                               f"cannot update")
            for idx, (s0, e0) in enumerate(self.store.block_ranges(full)):
                _, blk = self.store.read_block(full, idx)
                arr = np.array(blk)  # page views are read-only
                arr[:, j] = values[s0:e0]
                self.store.rewrite_block(full, idx, arr)
            if name in self.int_names:
                self.stats[name] = analyze_array(values.astype(np.int32))
            self._mutations += 1
        self._invalidate(0, self.num_rows, columns=(name,))

    def drop(self) -> None:
        """Free both matrices' pages once the streams reading them are
        done; the relation is dead afterwards."""
        with self.rw.write():
            self.dropped = True
            self._mutations += 1
            for suffix in _SUFFIXES:
                self.store.drop(self.name + suffix)
        if self.devcache is not None and self.cache_scope is not None:
            self.devcache.invalidate(self.cache_scope)

    # ------------------------------------------------------------ layout
    def _layout_name(self) -> str:
        return self.name + (".int" if self.int_names else ".float")

    def num_pages(self) -> int:
        """Row-chunk pages (both matrices share one blocking)."""
        return self.store.num_blocks(self._layout_name())

    def block_ranges(self) -> List[Tuple[int, int]]:
        """[(start_row, end_row)] per page, from metadata only."""
        return self.store.block_ranges(self._layout_name())

    def pad_rows(self) -> int:
        """Rows every chunk pads to: ``row_block``'s bucket when the
        configuration buckets, else ``row_block``; padded rows are
        invalid."""
        from netsdb_tpu_torch.plan.staging import pad_rows_target

        cfg = self.store.config
        return pad_rows_target(self.row_block, cfg.shape_bucketing,
                               density=cfg.bucket_density)

    # ------------------------------------------------------------ streams
    def _raw_stream(self, prefetch: Optional[int] = None,
                    blocks: Optional[List[int]] = None,
                    columns: Optional[List[str]] = None
                    ) -> Iterator[Tuple[int, int, list]]:
        """Locked host generator of ``(start_row, rows, [(names, page
        block)])``, one entry per matrix read. ``blocks`` restricts it to
        those page indices; ``columns`` projects, and a matrix holding
        none of them is never read. The read lock is taken on the thread
        that iterates (the staging thread for device streams)."""
        with self.rw.read():
            yield from self._raw_unlocked(prefetch, blocks, columns)

    def _raw_unlocked(self, prefetch=None, blocks=None, columns=None):
        if self.dropped:
            raise KeyError(f"paged relation {self.name!r} was dropped; "
                           f"cannot stream")
        if columns is not None:
            missing = set(columns) - (set(self.int_names)
                                      | set(self.float_names))
            if missing:
                raise KeyError(f"no columns {sorted(missing)} in "
                               f"{self.name!r}")
        streams = []
        for suffix, names in zip(_SUFFIXES, (self.int_names,
                                             self.float_names)):
            if names and (columns is None
                          or any(n in columns for n in names)):
                streams.append((names, self.store.stream_blocks(
                    self.name + suffix, prefetch, blocks=blocks)))
        with contextlib.ExitStack() as stack:
            for _, it in streams:
                stack.callback(it.close)
            while True:
                parts, start, n, ended = [], None, None, []
                for names, it in streams:
                    try:
                        s0, block = next(it)
                    except StopIteration:
                        ended.append(names)
                        continue
                    if start is None:
                        start, n = s0, block.shape[0]
                    elif s0 != start or block.shape[0] != n:
                        raise RuntimeError(
                            f"int/float page streams desynchronized "
                            f"({s0},{block.shape[0]}) vs ({start},{n})")
                    parts.append((names, block))
                if ended:
                    # both must end on the same round, or one would
                    # silently truncate the other's rows
                    if parts:
                        raise RuntimeError(
                            f"int/float page streams desynchronized: "
                            f"{ended} ended while others had blocks")
                    return
                self.pages_streamed += 1
                yield start, n, parts

    def _host_stream(self, prefetch: Optional[int] = None
                     ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray,
                                         int]]:
        """Host chunks ``(cols, valid, start_row)``: numpy columns padded
        to :meth:`pad_rows`, ``valid`` over the real rows."""
        pad_to = self.pad_rows()
        with contextlib.closing(self._raw_stream(prefetch)) as raw:
            for start, n, parts in raw:
                chunk = {name: block[:, j] for names, block in parts
                         for j, name in enumerate(names)}
                pad = pad_to - n
                if pad > 0:
                    chunk = {k: np.pad(v, (0, pad)) for k, v in
                             chunk.items()}
                yield chunk, np.arange(n + max(pad, 0)) < n, start

    def _placer(self, uploader, columns=None):
        """``(start, rows, parts)`` → ``(cols, valid, start)`` on the
        device: each matrix uploaded whole through ``uploader``, padded
        to :meth:`pad_rows` there and transposed there, so a column is a
        contiguous row."""
        pad_to = self.pad_rows()

        def place(item):
            start, n, parts = item
            rows = max(pad_to, n)
            cols = {}
            for names, block in parts:
                mat = uploader.upload(block, rows=rows).t()
                keep = [j for j, nm in enumerate(names)
                        if columns is None or nm in columns]
                mat = (mat.contiguous() if len(keep) == len(names) else
                       torch.stack([mat[j] for j in keep]))
                for row, j in enumerate(keep):
                    cols[names[j]] = mat[row]
            valid = torch.arange(rows, device=uploader.device) < n
            return cols, valid, start
        return place

    def _uploader(self):
        from netsdb_tpu_torch.plan.staging import BlockUploader

        # two uploads a chunk, stage_depth chunks ahead plus the one in use
        return BlockUploader(self.device,
                             2 * self.store.config.stage_depth + 1)

    def stream(self, prefetch: Optional[int] = None, device: bool = True):
        """Chunks ``(cols, valid, start_row)`` padded to :meth:`pad_rows`.
        ``device=False`` keeps them as numpy columns (a plain generator);
        ``device=True`` gives a :class:`~netsdb_tpu_torch.plan.staging.
        StagedStream` of the same on the relation's device, uploaded
        ``stage_depth`` chunks ahead. The read lock is held for the
        stream's lifetime; close abandoned streams."""
        if not device:
            return self._host_stream(prefetch)
        from netsdb_tpu_torch.plan.staging import stage_stream

        uploader = self._uploader()
        return stage_stream(self._raw_stream(prefetch),
                            self._placer(uploader),
                            depth=self.store.config.stage_depth,
                            name=f"cols:{self.name}", uploader=uploader)

    def _cache_ref(self, kind: str, columns=None):
        """(cache, whole-run key) for a store-owned relation with the
        device cache on, else (None, None). The key carries the set's
        write version, this handle's write count, the stream kind, the
        row bucket and any projection."""
        cache = self.devcache
        if (cache is None or not cache.enabled or self.cache_scope is None
                or self.dropped):
            return None, None
        ver = self.cache_version_fn() if self.cache_version_fn else 0
        key = (self.cache_scope, ver, self._mutations, kind,
               self.pad_rows())
        if columns is not None:
            key = key + (("cols",) + tuple(sorted(columns)),)
        return cache, key

    def placement(self):
        """The set's placement as the store has it now (None: unplaced)."""
        return self.placement_fn() if self.placement_fn is not None else None

    def partial_base_key(self, kind: str, columns=None,
                         placement=None) -> tuple:
        """The block entries' base key of one stream shape: ``(scope,
        kind, bucket)`` without write version (block freshness is the
        dirty ranges' job), the mesh label of a placed stream (chunks
        sharded over one mesh never serve another), plus a ``frozenset``
        of the projected columns for a projected stream — the marker
        per-column invalidation reads."""
        base = (self.cache_scope, kind, self.pad_rows())
        if placement is not None:
            base = base + (placement.mesh_label(self.device.type),)
        if columns is not None:
            base = base + (frozenset(columns),)
        return base

    def _partial_plan(self, kind: str, prefetch, columns=None,
                      placement=None):
        """The block-granular cache plan of one stream, or None (cache
        off, whole-run mode, or an unbound relation)."""
        from netsdb_tpu_torch.plan.staging import PartialPlan

        cache = self.devcache
        if (cache is None or not cache.enabled or not cache.partial
                or self.cache_scope is None or self.dropped):
            return None
        ranges = self.block_ranges()
        if not ranges:
            return None
        return PartialPlan(cache,
                           self.partial_base_key(kind, columns, placement),
                           ranges,
                           lambda idxs: self._raw_stream(
                               prefetch, blocks=idxs, columns=columns))

    def stream_tables(self, prefetch: Optional[int] = None,
                      columns: Optional[List[str]] = None,
                      placement="set"):
        """The page feed of the DAG path: a stream of chunk
        :class:`~netsdb_tpu_torch.relational.table.ColumnTable` s on the
        relation's device, validity-masked, with a ``_rowid`` column of
        global row numbers (the stream's own start is exact for ragged
        appended blocks; padded rows get numbers past the end, masked
        like everything else). ``columns`` projects the stream.

        A store-owned relation consults the device block cache: in
        partial mode (the default) each cached block range is served
        from device memory and only the gaps read pages and stage; in
        whole-run mode a warm stream replays the run. Cached chunks are
        owned by the cache: fold steps never write them.

        ``placement`` (default: the set's own, None for none) shards each
        chunk over its mesh as it lands (``placement.shard_table``, the
        relation's statistics kept): a placed relation streams as placed
        chunks, cached under the placement's mesh label."""
        from netsdb_tpu_torch.parallel.placement import shard_table
        from netsdb_tpu_torch.plan.staging import stage_stream

        if placement == "set":
            placement = self.placement()
        dicts = self.dicts
        if columns is not None:
            dicts = {k: v for k, v in dicts.items() if k in columns}
        uploader = self._uploader()
        placer = self._placer(uploader, columns)

        def place(item):
            cols, valid, start = placer(item)
            cols["_rowid"] = torch.arange(
                valid.shape[0], dtype=torch.int32, device=valid.device) + start
            chunk = ColumnTable(cols, dicts, valid)
            if placement is not None:
                chunk = shard_table(inject_stats(chunk, self.stats),
                                    placement, keep_stats=True)
            return chunk

        depth = self.store.config.stage_depth
        name = f"tables:{self.name}"
        partial = self._partial_plan("tables", prefetch, columns, placement)
        if partial is not None:
            return stage_stream(None, place, depth=depth, name=name,
                                partial=partial, uploader=uploader)
        kind = ("tables" if placement is None
                else ("tables", placement.mesh_label(self.device.type)))
        cache, key = self._cache_ref(kind, columns)
        return stage_stream(
            self._raw_stream(prefetch, columns=columns), place, depth=depth,
            name=name, cache=cache, cache_key=key, uploader=uploader,
            cache_validator=None if cache is None else (
                lambda: self._cache_ref(kind, columns)[1] == key))

    def stream_host_tables(self, prefetch: Optional[int] = None
                           ) -> Iterator[ColumnTable]:
        """Each chunk as a compact host table (CPU columns, padding
        stripped, no ``_rowid``); the device never sees the data."""
        with contextlib.closing(self._raw_stream(prefetch)) as raw:
            for _start, _n, blocks in raw:
                yield ColumnTable({name: torch.from_numpy(
                    np.ascontiguousarray(block[:, j]))
                    for names, block in blocks
                    for j, name in enumerate(names)}, dict(self.dicts), None)

    # ------------------------------------------------------------ assembly
    def to_host_table(self) -> ColumnTable:
        """The whole relation as one table of CPU columns, assembled on
        the host (the flush path and ``get_table``): device memory is
        never touched."""
        with obs.span(f"ooc.host_assemble:{self.name}", "storage"):
            return self._to_host_table()

    def _to_host_table(self) -> ColumnTable:
        parts: Dict[str, List[np.ndarray]] = {}
        n_done = 0
        with self.rw.read():
            # the row count as of this snapshot: an append landing after
            # the stream drains does not make it inconsistent
            expected = self.num_rows
            for _start, n, blocks in self._raw_unlocked():
                for names, block in blocks:
                    for j, name in enumerate(names):
                        parts.setdefault(name, []).append(block[:, j])
                n_done += n
        if n_done != expected:
            raise RuntimeError(f"paged set {self.name!r}: streamed {n_done} "
                               f"rows, expected {expected}")
        out = ColumnTable({k: torch.from_numpy(np.concatenate(v))
                           for k, v in parts.items()}, dict(self.dicts), None)
        return inject_stats(out, self.stats)

    def to_table(self, uploader=None) -> ColumnTable:
        """The whole relation as one table on the relation's device: the
        host assembly uploaded column by column through ``uploader`` (a
        fresh one, whose copies the caller's stream then waits for, when
        None). It defeats paging by construction: the streamed path is
        :meth:`stream_tables`."""
        from netsdb_tpu_torch.plan import staging

        host = self.to_host_table()
        own = uploader is None
        if own:
            uploader = staging.BlockUploader(self.device, len(host.cols))
        with uploader.scope():
            cols = {k: uploader.upload(v.numpy())
                    for k, v in host.cols.items()}
        out = ColumnTable(cols, dict(self.dicts), None)
        if own:
            staging.hand_over(out, uploader)
        return inject_stats(out, self.stats)

    def assembled(self) -> ColumnTable:
        """:meth:`to_table` through the device cache when the relation is
        store-owned: a warm request replays the assembled table (no page
        read, no copy); any write unkeys it."""
        cache, key = self._cache_ref("table")
        if cache is not None:
            hit = cache.get(key)
            if hit is not None:
                from netsdb_tpu_torch.plan.staging import used_here

                return used_here(hit[0])
        table = self.to_table()
        if cache is not None:
            cache.install(key, [table], validator=lambda: (
                self._cache_ref("table")[1] == key))
        return table


# ----------------------------------------------- grace-hash partitioning
_grace_ids = itertools.count()

#: Fibonacci multiplier (the golden ratio's reciprocal in 64 bits), the
#: first stage of splitmix64
_KEY_MIX_MULT = np.uint64(0x9E3779B97F4A7C15)


def mix_partition_key(kv: np.ndarray) -> np.ndarray:
    """Avalanche a key column before the partition modulus (uint64, on
    the host: torch's uint64 arithmetic is incomplete). Bare ``key %
    nparts`` piles keys that share a factor with ``nparts`` into a few
    partitions; a Fibonacci multiply and xor-shifts spread any key
    structure. Both join sides mix the same way, so matching keys meet in
    one partition."""
    h = np.asarray(kv).astype(np.int64).view(np.uint64) * _KEY_MIX_MULT
    h ^= h >> np.uint64(29)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(32)
    return h


def partition_by_key(pc: PagedColumns, key: str, nparts: int,
                     keep_rowid: bool = False,
                     columns: Optional[Tuple[str, ...]] = None
                     ) -> List[Optional[PagedColumns]]:
    """One host pass over ``pc``, routing its valid rows by
    ``mix(key) % nparts`` into ``nparts`` relations in the same arena
    (the reference's partition stage, ``PipelineStage.cc:1652-1728``).
    Per-partition buffers flush to pages at the relation's row block, so
    host memory stays about ``nparts`` × row block rows and partitions
    spill like any paged data. ``keep_rowid`` keeps each row's global
    number as ``_rowid0``; ``columns`` keeps only those columns (and the
    key). Negative keys go to partition 0, where the kernels drop them.
    Partitions that got no row are None."""
    parts: List[Optional[PagedColumns]] = [None] * nparts
    bufs: List[Dict[str, List[np.ndarray]]] = [{} for _ in range(nparts)]
    buf_rows = [0] * nparts
    uid = next(_grace_ids)

    def flush(p: int) -> None:
        if buf_rows[p] == 0:
            return
        cols = {k: np.concatenate(v) for k, v in bufs[p].items()}
        if parts[p] is None:
            parts[p] = PagedColumns.ingest(
                pc.store, f"{pc.name}#gr{uid}p{p}", cols,
                row_block=pc.row_block, dicts=dict(pc.dicts),
                device=pc.device)
        else:
            parts[p].append(cols)
        bufs[p] = {}
        buf_rows[p] = 0

    want = None if columns is None else sorted(set(columns) | {key})
    # the page matrices unpadded, projected: whole rows move per partition
    with obs.span(f"ooc.partition:{pc.name}", "storage"), \
            contextlib.closing(pc._raw_stream(prefetch=2,
                                              columns=want)) as raw:
        for start, n, blocks in raw:
            kv = next(b[:, names.index(key)] for names, b in blocks
                      if key in names)
            pid = np.where(kv >= 0, (mix_partition_key(kv)
                                     % np.uint64(nparts)).astype(np.int64), 0)
            rowid = (np.arange(start, start + n, dtype=np.int32)
                     if keep_rowid else None)
            for p in np.unique(pid):
                sel = pid == p
                for names, block in blocks:
                    sub = block[sel]
                    for j, name in enumerate(names):
                        if want is None or name in want:
                            bufs[p].setdefault(name, []).append(sub[:, j])
                if rowid is not None:
                    bufs[p].setdefault("_rowid0", []).append(rowid[sel])
                buf_rows[p] += int(sel.sum())
                if buf_rows[p] >= pc.row_block:
                    flush(p)
    for p in range(nparts):
        flush(p)
    return parts


# --------------------------------------------------------- fold runner
def run_fold(fold, pc: PagedColumns, *resident):
    """A :class:`~netsdb_tpu_torch.plan.fold.FoldSpec` over one paged
    relation without a DAG: the executor's own loop for paged scans."""
    from netsdb_tpu_torch.plan.executor import _run_fold_once

    with torch.inference_mode():
        return _run_fold_once(fold, pc, resident)


def ooc_q01(pc: PagedColumns, delta_date: str = "1998-09-02"):
    """Q01 over a paged lineitem, the same rows as ``queries.cq01``: the
    fold of ``relational.folds.fold_q01`` (the one the DAG streams) and
    the row decoding."""
    from netsdb_tpu_torch.relational.folds import fold_q01

    n_ls = len(pc.dicts["l_linestatus"])
    n_groups = len(pc.dicts["l_returnflag"]) * n_ls
    sums, counts = (t.cpu().numpy() for t in run_fold(
        fold_q01({}, {}, {}, delta_date=delta_date), pc))
    names = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
             "sum_disc")
    out = []
    for g in range(n_groups):
        cnt = int(counts[g])
        if cnt == 0:
            continue
        key = (pc.dicts["l_returnflag"][g // n_ls],
               pc.dicts["l_linestatus"][g % n_ls])
        v = {names[i]: float(sums[i, g]) for i in range(5)}
        v["count"] = cnt
        v["avg_qty"] = v["sum_qty"] / cnt
        v["avg_price"] = v["sum_base_price"] / cnt
        v["avg_disc"] = v["sum_disc"] / cnt
        out.append((key, v))
    out.sort(key=lambda kv: kv[0])
    return out


def ooc_q06(pc: PagedColumns, d0: str = "1994-01-01",
            d1: str = "1995-01-01", disc: float = 0.06, qty: int = 24):
    """Q06 over a paged lineitem, the same result as ``queries.cq06``."""
    from netsdb_tpu_torch.relational.folds import fold_q06

    (acc,) = run_fold(fold_q06({}, {}, {}, d0=d0, d1=d1, disc=disc,
                               qty=qty), pc)
    return [("revenue", float(acc))]


# ---------------------------------------------- Q03: out-of-core join
def build_q03_side(store: PagedTensorStore, orders: Dict[str, np.ndarray],
                   customer: Dict[str, np.ndarray], segment_code: int,
                   date_int: int, key_cap: int,
                   name: str = "q03.build") -> int:
    """The build side of Q03 on the host: customers of the segment joined
    to their orders before the date, as a per-orderkey LUT [qualifies,
    o_orderdate, o_shippriority] paged into ``store`` in key ranges of
    ``key_cap``. Returns the number of partitions."""
    c_key = np.asarray(customer["c_custkey"])
    cust_lut = np.zeros(int(c_key.max()) + 1, np.bool_)
    cust_lut[c_key] = np.asarray(customer["c_mktsegment"]) == segment_code
    o_key = np.asarray(orders["o_orderkey"])
    o_date = np.asarray(orders["o_orderdate"])
    o_ok = (o_date < date_int) & cust_lut[np.asarray(orders["o_custkey"])]
    build = np.zeros((int(o_key.max()) + 1, 3), np.int32)
    build[o_key, 0] = o_ok
    build[o_key, 1] = o_date
    build[o_key, 2] = np.asarray(orders["o_shippriority"])
    store.put(name, build, row_block=key_cap)
    return store.num_blocks(name)


def ooc_q03(pc: PagedColumns, store: PagedTensorStore,
            date: str = "1995-03-15", k: int = 10,
            build_name: str = "q03.build") -> List[Dict[str, object]]:
    """Q03 with lineitem streamed and the join LUT loaded one partition
    at a time: each LUT block becomes a build table (keys of orders that
    do not qualify are -1, dropped by the orphan-key rule), the probe
    streams once per block through ``dag.q03_probe_fold``, and the
    partitions' top k merge. The same rows as ``queries.cq03``."""
    from netsdb_tpu_torch.relational.dag import q03_probe_fold, q03_rows
    from netsdb_tpu_torch.relational.planner import JoinPlan

    if "l_orderkey" not in pc.stats:
        raise KeyError("ooc_q03 needs ingest-time stats for 'l_orderkey' "
                       "(the join key-space bound); this PagedColumns has "
                       "none — re-ingest via PagedColumns.ingest/from_table")
    ks = pc.stats["l_orderkey"].key_space
    fold = q03_probe_fold(date_to_int(date), k, JoinPlan("lut", max(ks, 1)))
    (init, step), = fold.passes
    out = None
    with torch.inference_mode():
        for p in range(store.num_blocks(build_name)):
            start, bmat = store.read_block(build_name, p)
            keys = np.where(bmat[:, 0] > 0, np.arange(
                bmat.shape[0], dtype=np.int32) + start, -1).astype(np.int32)
            btab = ColumnTable({
                "o_orderkey": torch.from_numpy(keys).to(pc.device),
                "o_orderdate": torch.from_numpy(
                    np.array(bmat[:, 1])).to(pc.device)})
            state = init(None, pc, btab)
            with contextlib.closing(pc.stream_tables()) as chunks:
                for chunk in chunks:
                    state = step(state, chunk, btab)
            part = fold.finalize(state, pc, btab)
            out = part if out is None else fold.merge(out, part)
    return q03_rows(out) if out is not None else []


Q01_COLUMNS = ["l_shipdate", "l_returnflag", "l_linestatus",
               "l_quantity", "l_extendedprice", "l_discount", "l_tax"]
Q06_COLUMNS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
Q03_COLUMNS = ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"]


def _synthetic_lineitem(rng, rows: int, n_orders: Optional[int] = None):
    """The reference benches' lineitem columns, drawn in their order
    (``l_orderkey`` first when ``n_orders`` is given)."""
    cols = {}
    if n_orders is not None:
        cols["l_orderkey"] = rng.integers(0, n_orders, rows, dtype=np.int32)
    return {
        **cols,
        "l_shipdate": rng.integers(19920101, 19981231, rows,
                                   dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows,
                                   dtype=np.int32).astype(np.float32),
        "l_extendedprice": rng.uniform(1000, 100000,
                                       rows).astype(np.float32),
        "l_discount": rng.uniform(0, 0.1, rows).astype(np.float32),
        "l_tax": rng.uniform(0, 0.08, rows).astype(np.float32),
    }


_LI_DICTS = {"l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"]}


def bench_paged_set_api(rows: int = 60_000_000, pool_bytes: int = 1 << 30,
                        page_bytes: int = 1 << 20, seed: int = 0,
                        device=None) -> Dict[str, object]:
    """The set API's paged path on a synthetic lineitem of ``rows`` rows
    (60 M is about SF 10) under a pool of ``pool_bytes``: Q01 through
    ``q01_sink`` (the fold streamed over the arena) and Q03 through
    ``q03_build_sink`` into a paged build set and ``q03_probe_sink`` (the
    one-pass grace hash when the build side has several pages; its probe
    passes are reported), with the arena's counters. Host clock; the
    device is ``device`` (CUDA unless asked)."""
    import shutil
    import tempfile
    import time

    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.storage.store import SetIdentifier

    rng = np.random.default_rng(seed)
    n_orders = max(rows // 4, 1)
    n_cust = max(n_orders // 10, 1)
    li = _synthetic_lineitem(rng, rows, n_orders)
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.int32),
        "o_custkey": rng.integers(0, n_cust, n_orders, dtype=np.int32),
        "o_orderdate": rng.integers(19920101, 19981231, n_orders,
                                    dtype=np.int32),
        "o_shippriority": np.zeros(n_orders, np.int32),
    }
    cust = {"c_custkey": np.arange(n_cust, dtype=np.int32),
            "c_mktsegment": rng.integers(0, 5, n_cust, dtype=np.int32)}
    table_bytes = sum(c.nbytes for c in li.values())
    root = tempfile.mkdtemp(prefix="paged_api_bench_")
    out: Dict[str, object] = {
        "rows": rows, "table_bytes": table_bytes, "pool_bytes": pool_bytes,
        "pool_fraction": round(pool_bytes / table_bytes, 3)}
    try:
        c = Client(Configuration(root_dir=root, page_size_bytes=page_bytes,
                                 page_pool_bytes=pool_bytes), device=device)
        c.create_database("d")
        for name, cols, dicts in (
                ("lineitem", li, _LI_DICTS), ("orders", orders, None),
                ("customer", cust,
                 {"c_mktsegment": ["AUTOMOBILE", "BUILDING", "FURNITURE",
                                   "HOUSEHOLD", "MACHINERY"]})):
            c.create_set("d", name, type_name="table",
                         storage="paged" if name != "customer" else "memory")
            t0 = time.perf_counter()
            c.send_table("d", name, ColumnTable.from_columns(
                cols, dicts, device="cpu"))
            out[f"ingest_{name}_s"] = round(time.perf_counter() - t0, 2)
        del li, orders  # the arena holds the data now

        t0 = time.perf_counter()
        q01 = rdag.run_query(c, rdag.q01_sink("d"))
        out["q01_s"] = round(time.perf_counter() - t0, 2)
        out["q01_groups"] = int(q01.mask().sum())
        cinfo = c.analyze_set("d", "customer")
        seg = cinfo["dicts"]["c_mktsegment"].index("BUILDING")
        c.create_set("d", "q03_build", type_name="table", storage="paged")
        t0 = time.perf_counter()
        c.execute_computations(rdag.q03_build_sink(
            "d", n_customers=n_cust, segment_code=seg))
        out["q03_build_s"] = round(time.perf_counter() - t0, 2)
        li_pc = c.store.paged_relation(SetIdentifier("d", "lineitem"))
        before = li_pc.pages_streamed
        t0 = time.perf_counter()
        q03 = rdag.run_query(c, rdag.q03_probe_sink("d", n_orders=n_orders))
        out["q03_probe_s"] = round(time.perf_counter() - t0, 2)
        out["q03_rows"] = len(rdag.q03_rows(q03))
        out["probe_passes"] = round(
            (li_pc.pages_streamed - before) / max(li_pc.num_pages(), 1), 2)
        bpc = c.store.paged_relation(SetIdentifier("d", "q03_build"))
        out["build_pages"] = bpc.num_pages()
        out["store_stats"] = c.store.page_store().stats()
        out["native"] = c.store.page_store().native
        c.store.page_store().close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def bench_out_of_core(rows: int = 60_000_000, pool_bytes: int = 1 << 30,
                      row_block: Optional[int] = None, seed: int = 0,
                      device=None) -> Dict[str, object]:
    """A synthetic lineitem of ``rows`` rows through Q01 and Q06 under a
    pool far smaller than the table, Q06 checked against a numpy oracle
    in float64 on the same columns. Host clock."""
    import shutil
    import tempfile
    import time

    from netsdb_tpu_torch.config import Configuration

    rng = np.random.default_rng(seed)
    cols = _synthetic_lineitem(rng, rows)
    table_bytes = sum(c.nbytes for c in cols.values())
    cfg = Configuration(root_dir=tempfile.mkdtemp(prefix="ooc_bench_"))
    store = PagedTensorStore(cfg, pool_bytes=pool_bytes)
    try:
        if row_block is None:
            # one page far below the pool, or ingest cannot even allocate
            width = len(cols)
            row_block = max(min(cfg.page_size_bytes // (4 * width),
                                pool_bytes // (8 * 4 * width)), 4096)
        t0 = time.perf_counter()
        pc = PagedColumns.ingest(store, "lineitem", cols,
                                 row_block=row_block, dicts=_LI_DICTS,
                                 device=device)
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r01 = ooc_q01(pc)
        q01_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r06 = ooc_q06(pc)
        q06_s = time.perf_counter() - t0
        a, b = date_to_int("1994-01-01"), date_to_int("1995-01-01")
        m = ((cols["l_shipdate"] >= a) & (cols["l_shipdate"] < b)
             & (cols["l_discount"] >= 0.06 - 0.011)
             & (cols["l_discount"] <= 0.06 + 0.011)
             & (cols["l_quantity"] < 24))
        oracle = float((cols["l_extendedprice"][m].astype(np.float64)
                        * cols["l_discount"][m]).sum())
        out = {"rows": rows, "table_bytes": table_bytes,
               "pool_bytes": pool_bytes,
               "pool_fraction": round(pool_bytes / table_bytes, 3),
               "ingest_s": round(ingest_s, 2), "q01_s": round(q01_s, 2),
               "q06_s": round(q06_s, 2), "q01_groups": len(r01),
               "q06_rel_err": abs(r06[0][1] - oracle) / max(abs(oracle),
                                                            1e-9),
               "store_stats": store.stats(), "native": store.native}
    finally:
        store.close()
        shutil.rmtree(cfg.root_dir, ignore_errors=True)
    return out
