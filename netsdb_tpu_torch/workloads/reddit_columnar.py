"""Columnar reddit on the device engine — counterpart of
``netsdb_tpu/workloads/reddit_columnar.py``.

Records columnarise at ingest (names dictionary-encoded, body terms
hashed to count columns on the host), and each stage is a few torch ops
over the relational kernels on the tables' device:

- feature extraction (``CommentFeatures.h:31-47``): both time-feature
  sets, the numeric transforms and the hashed body for the whole table
  in one pass (:func:`batch_features`);
- the three-way join Comment⋈Author⋈Sub (``RedditThreeWayJoin.h:12-30``)
  as two planner-chosen ``pk_fk_join`` probes (:func:`three_way_join`,
  and over stored sets :func:`three_way_sink_for`);
- label propagation (``RedditCommentLabelJoin.h``) as one
  self-semi-join, :func:`~netsdb_tpu_torch.relational.kernels.
  any_by_key`;
- the per-author count and the 2 × 11 label-partition grid as segment
  counts.

The distributed three-way join (``sharded_three_way``) runs over a mesh
with the row shuffle of ``relational/shuffle.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.relational import kernels as K
from netsdb_tpu_torch.relational import planner as PLN
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.workloads.reddit import (Author, Comment,
                                               DEFAULT_HASH_FEATURES, Sub,
                                               body_hash_counts)

# ------------------------------------------------------------- ingest
def columnarize(comments: Sequence[Comment], authors: Sequence[Author],
                subs: Sequence[Sub],
                hash_dim: int = DEFAULT_HASH_FEATURES,
                device=None) -> Dict[str, ColumnTable]:
    """Records → column tables on ``device`` (CUDA unless asked). Author
    and sub references become int key columns with the names as their
    dictionaries; body text hashes into count columns ``body_h{j}`` on
    the host (text never reaches the device)."""
    author_row = {a.author: a.author_id for a in authors}
    sub_row = {s.id: i for i, s in enumerate(subs)}
    n = len(comments)
    body_counts = np.zeros((n, hash_dim - 9), np.float32)
    body_len = np.zeros((n,), np.int32)
    for i, c in enumerate(comments):
        body_len[i] = len(c.body)
        body_counts[i] = body_hash_counts(c.body, hash_dim)

    def ints(fn):
        return np.fromiter((fn(c) for c in comments), np.int32, n)

    cols = {
        "index": ints(lambda c: c.index),
        "author_id": ints(lambda c: author_row[c.author]),
        "sub_id": ints(lambda c: sub_row[c.subreddit_id]),
        "label": ints(lambda c: c.label),
        "score": ints(lambda c: c.score),
        "gilded": ints(lambda c: c.gilded),
        "controversiality": ints(lambda c: c.controversiality),
        "archived": ints(lambda c: int(c.archived)),
        "stickied": ints(lambda c: int(c.stickied)),
        "created_utc": ints(lambda c: c.created_utc),
        "author_created_utc": ints(lambda c: c.author_created_utc),
        "body_len": body_len,
        **{f"body_h{j}": np.ascontiguousarray(body_counts[:, j])
           for j in range(hash_dim - 9)},
    }
    ct = ColumnTable.from_columns(
        cols, dicts={"author_id": [a.author for a in authors],
                     "sub_id": [s.id for s in subs]}, device=device)
    at = ColumnTable.from_columns({
        "author_id": np.fromiter((a.author_id for a in authors), np.int32,
                                 len(authors)),
        "karma": np.fromiter((a.karma for a in authors), np.int32,
                             len(authors))}, device=device)
    st = ColumnTable.from_columns({
        "sub_row": np.arange(len(subs), dtype=np.int32),
        "subscribers": np.fromiter((s.subscribers for s in subs), np.int32,
                                   len(subs))}, device=device)
    return {"comments": ct, "authors": at, "subs": st}


# ------------------------------------------------- vectorised features
def _fmod_floor(a: torch.Tensor, b: float) -> torch.Tensor:
    """Python's float ``a % b`` from the exact ``fmod`` (as ``jnp.remainder``
    computes it): ``torch.remainder`` on floats goes through ``a - b *
    floor(a / b)``, which rounds."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _time_features_cols(utc: torch.Tensor) -> torch.Tensor:
    """(N,) int32 epoch seconds → (N, 9) normalised calendar features,
    the vectorised time block of ``reddit.comment_features``. Integer
    sub-expressions stay int32 (exact below 2**31); only small residues
    reach float32."""
    days_i = torch.div(utc, 86400, rounding_mode="floor")
    secs = torch.remainder(utc, 86400)
    days = days_i.float() + secs.float() / 86400.0
    return torch.stack([
        (_fmod_floor(days, 30.44) + 1.0) / 31.0,
        torch.remainder(utc, 60).float() / 60.0,
        torch.remainder(torch.div(utc, 60, rounding_mode="floor"),
                        60).float() / 59.0,
        torch.div(secs, 3600, rounding_mode="floor").float() / 23.0,
        _fmod_floor(days / 30.44, 12.0) / 11.0,
        (1970.0 + days / 365.25) / 2021.0,
        torch.remainder(days_i + 4, 7).float() / 6.0,
        _fmod_floor(days, 365.25) / 365.0,
        torch.zeros_like(days),
    ], dim=1)


def _features_core(author_created, created, score, gilded, contro,
                   archived, stickied, body_len, body_counts):
    numeric = torch.stack([
        torch.tanh(score.float() / 1000.0),
        gilded.float(),
        contro.float(),
        archived.float(),
        stickied.float(),
        torch.tanh(body_len.float() / 256.0),
    ], dim=1)
    return torch.cat([
        _time_features_cols(author_created),
        _time_features_cols(created),
        numeric,
        torch.tanh(body_counts),
    ], dim=1)


def batch_features(comments_t: ColumnTable) -> torch.Tensor:
    """(N, feature_dim) feature matrix in one device pass — N calls of
    the per-record ``comment_features``."""
    c = comments_t
    hash_cols = sorted((n for n in c.cols if n.startswith("body_h")),
                       key=lambda n: int(n[6:]))
    body_counts = torch.stack([c[n] for n in hash_cols], dim=1)
    return _features_core(c["author_created_utc"], c["created_utc"],
                          c["score"], c["gilded"],
                          c["controversiality"], c["archived"],
                          c["stickied"], c["body_len"], body_counts)


# ------------------------------------------------- three-way join
def three_way_join(tables: Dict[str, ColumnTable]
                   ) -> Tuple[ColumnTable, torch.Tensor]:
    """Comment⋈Author⋈Sub with planner-chosen joins; returns the joined
    table (comment columns + karma + subscribers, rows without both
    matches invalid) and the feature matrix of the comments."""
    ct, at, st = tables["comments"], tables["authors"], tables["subs"]
    jp_a = PLN.plan_join(at, "author_id", ct, "author_id")
    jp_s = PLN.plan_join(st, "sub_row", ct, "sub_id")
    aidx, ahit = K.pk_fk_join(at["author_id"], ct["author_id"], plan=jp_a)
    sidx, shit = K.pk_fk_join(st["sub_row"], ct["sub_id"], plan=jp_s)
    out = ct.with_column("karma", K.take(at["karma"], aidx)) \
            .with_column("subscribers", K.take(st["subscribers"], sidx)) \
            .filter(ahit & shit)
    return out, batch_features(ct)


def three_way_sink_for(client, db: str = "redditc",
                       output_set: str = "full_features"):
    """The three-way join as a Computation DAG over the stored sets
    ``comments``, ``authors`` and ``subs``: statistics from
    ``analyze_set`` summaries (their hash in the label), output the
    joined relation."""
    import hashlib

    from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet
    from netsdb_tpu_torch.relational.dag import _fold_mask
    from netsdb_tpu_torch.relational.stats import inject_stats

    names = ("comments", "authors", "subs")
    captured = {n: client.analyze_set(db, n)["stats"] for n in names}
    stats_tag = hashlib.blake2s(repr(sorted(
        (n, sorted((c, s.n_rows, s.min_val, s.max_val)
                   for c, s in cs.items()))
        for n, cs in captured.items())).encode()).hexdigest()[:12]

    def run(pair, st: ColumnTable) -> ColumnTable:
        ct, at = pair
        tabs = {"comments": inject_stats(_fold_mask(ct),
                                         captured["comments"]),
                "authors": inject_stats(_fold_mask(at),
                                        captured["authors"]),
                "subs": inject_stats(_fold_mask(st), captured["subs"])}
        out, _ = three_way_join(tabs)
        return out

    node = Join(Join(ScanSet(db, "comments"), ScanSet(db, "authors"),
                     fn=lambda a, b: (a, b), label="gather:authors"),
                ScanSet(db, "subs"), fn=run,
                label=f"reddit3way:{stats_tag}")
    return WriteSet(node, db, output_set)


def sharded_three_way(tables: Dict[str, ColumnTable], mesh, axis="data",
                      slack: float = 2.0):
    """The distributed form: comments fact-sharded; each dimension side
    placed by the planner — broadcast (a LUT probe inside each shard, the
    common case for author and sub dimension tables) or the
    hash-repartition ROW shuffle (``relational/shuffle.hash_join``) when a
    side is fact-scale. Returns a ``ShardedRows`` with the columns of the
    local join."""
    from netsdb_tpu_torch.relational import shuffle as S
    from netsdb_tpu_torch.relational.stats import key_space

    ct, at, st = tables["comments"], tables["authors"], tables["subs"]
    # the broadcast branch replicates BOTH dimension sides — cost both
    dim_bytes = 8 * (at.num_rows + st.num_rows)
    if PLN.plan_distribution(dim_bytes, mesh.shape[axis]).strategy \
            == "broadcast":
        # dimension sides replicated: one local LUT probe per shard — the
        # repartition only shards the fact
        t = S.hash_repartition(mesh, axis, {n: ct[n] for n in ct.cols},
                               "index", slack)
        jp_a = PLN.plan_join(at, "author_id", ct, "author_id")
        jp_s = PLN.plan_join(st, "sub_row", ct, "sub_id")
        karma, subscribers, valid = [], [], []
        for i in range(mesh.shape[axis]):
            cols, v = t.local(i)
            a_loc, s_loc = at.to(v.device), st.to(v.device)
            aidx, ahit = K.pk_fk_join(a_loc["author_id"], cols["author_id"],
                                      plan=jp_a)
            sidx, shit = K.pk_fk_join(s_loc["sub_row"], cols["sub_id"],
                                      plan=jp_s)
            karma.append(K.take(a_loc["karma"], aidx))
            subscribers.append(K.take(s_loc["subscribers"], sidx))
            valid.append(v & ahit & shit)
        out = dict(t.cols)
        out["karma"] = S._sharded(mesh, axis, karma)
        out["subscribers"] = S._sharded(mesh, axis, subscribers)
        return S.ShardedRows(out, S._sharded(mesh, axis, valid), mesh, axis,
                             t.overflow)
    # fact-scale sides: chained row-output hash joins
    j1 = S.hash_join(
        mesh, axis,
        build={"author_id": at["author_id"], "karma": at["karma"]},
        build_key="author_id",
        probe={n: ct[n] for n in ct.cols}, probe_key="author_id",
        key_space=max(key_space(at, "author_id"),
                      key_space(ct, "author_id")), slack=slack)
    S.check_overflow(j1)
    j2 = S.hash_join(
        mesh, axis,
        build={"sub_row": st["sub_row"],
               "subscribers": st["subscribers"]},
        build_key="sub_row",
        probe=j1.cols, probe_key="sub_id",
        key_space=max(key_space(st, "sub_row"),
                      key_space(ct, "sub_id")),
        slack=slack, probe_valid=j1.valid)
    S.check_overflow(j2)
    return j2


# --------------------------------------------- label propagation
def propagate_labels(comments_t: ColumnTable,
                     n_authors: Optional[int] = None) -> torch.Tensor:
    """(N,) int32: 1 iff the comment's author has any positive-labelled
    comment — the label-propagation join's set semantics, as one
    self-semi-join."""
    from netsdb_tpu_torch.relational.stats import key_space

    if n_authors is None:
        n_authors = key_space(comments_t, "author_id")
    return K.any_by_key(comments_t["author_id"],
                        (comments_t["label"] == 1).to(torch.int32),
                        n_authors)


def author_comment_counts(comments_t: ColumnTable,
                          n_authors: Optional[int] = None) -> torch.Tensor:
    """(n_authors,) comment counts — the workload's group-by."""
    from netsdb_tpu_torch.relational.stats import key_space

    if n_authors is None:
        n_authors = key_space(comments_t, "author_id")
    return K.segment_count(comments_t["author_id"], n_authors)


def label_partition_counts(comments_t: ColumnTable,
                           num_parts: int = 11) -> torch.Tensor:
    """(2, num_parts) row counts of the reference's 2 × 11
    ``RedditLabelSelection{i}_{j}`` grid, as one segment count over
    (label, index % parts)."""
    seg = (comments_t["label"] * num_parts
           + torch.remainder(comments_t["index"], num_parts))
    return K.segment_count(seg, 2 * num_parts).reshape(2, num_parts)


# ----------------------------------------------------------- bench
def bench_columns(rows: int = 1_000_000, n_authors: int = 50_000,
                  n_subs: int = 500, seed: int = 0,
                  hash_dim: int = DEFAULT_HASH_FEATURES
                  ) -> Dict[str, Tuple[Dict[str, np.ndarray],
                                       Dict[str, list]]]:
    """Host columns of the label-propagation bench, drawn from ``seed``
    in bulk: ``rows`` comments by ``n_authors`` authors with 1% positive
    labels (the first draws, as the reference's bench makes them), and
    every other column of :func:`columnarize`'s comments table, with
    authors and ``n_subs`` subs for the three-way join. Returns
    ``{name: (columns, dictionaries)}``."""
    rng = np.random.default_rng(seed)
    author_id = rng.integers(0, n_authors, rows).astype(np.int32)
    label = (rng.random(rows) < 0.01).astype(np.int32)

    def ints(lo, hi):
        return rng.integers(lo, hi, rows).astype(np.int32)

    cols = {"index": np.arange(rows, dtype=np.int32),
            "author_id": author_id,
            "sub_id": ints(0, n_subs),
            "label": label,
            "score": ints(-50, 5000),
            "gilded": ints(0, 3),
            "controversiality": (rng.random(rows) < 0.25).astype(np.int32),
            "archived": (rng.random(rows) < 0.1).astype(np.int32),
            "stickied": (rng.random(rows) < 0.05).astype(np.int32),
            "created_utc": 1_500_000_000 + ints(0, 200_000_000),
            "author_created_utc": 1_200_000_000 + ints(0, 300_000_000),
            "body_len": ints(3, 120)}
    for j in range(hash_dim - 9):
        cols[f"body_h{j}"] = (rng.random(rows) < 0.1).astype(np.float32)
    authors = {"author_id": np.arange(n_authors, dtype=np.int32),
               "karma": rng.integers(0, 100_000, n_authors).astype(
                   np.int32)}
    subs = {"sub_row": np.arange(n_subs, dtype=np.int32),
            "subscribers": rng.integers(100, 10_000_000, n_subs).astype(
                np.int32)}
    return {"comments": (cols, {"author_id": [f"user{i}" for i in
                                              range(n_authors)],
                                "sub_id": [f"t5_{i:05x}" for i in
                                           range(n_subs)]}),
            "authors": (authors, {}), "subs": (subs, {})}


def bench_label_propagation(rows: int = 1_000_000,
                            n_authors: int = 50_000, seed: int = 0,
                            iters: int = 10, device=None
                            ) -> Dict[str, object]:
    """``rows`` comments through label propagation, the per-author
    group-by and the 2 × 11 partition grid on ``device`` (CUDA unless
    asked), timed by ``relational.bench``'s timer (CUDA events on a
    card, the host clock on the CPU, which ``device`` names): the
    median over ``iters`` rounds."""
    from netsdb_tpu_torch.config import resolve_device
    from netsdb_tpu_torch.relational.bench import _timer

    dev = resolve_device(device)
    cols, dicts = bench_columns(rows, n_authors, seed=seed)["comments"]
    t = ColumnTable.from_columns(
        {n: cols[n] for n in ("index", "author_id", "label")}, device=dev)
    timer = _timer(dev)

    def round_():
        propagate_labels(t, n_authors)
        author_comment_counts(t, n_authors)
        label_partition_counts(t, 11)

    round_()  # warm-up
    ms = float(np.median([timer(round_) for _ in range(iters)]))
    return {"rows": rows, "n_authors": n_authors, "device": str(dev),
            "ms": ms, "rows_per_sec": rows / (ms * 1e-3)}
