"""Reddit over host records — counterpart of
``netsdb_tpu/workloads/reddit.py`` (the reference's ``src/reddit``
social-graph and feature pipeline).

Record types (``RedditComment.h``, ``RedditAuthor.h``, ``RedditSub.h``),
the three-way equi-join Comment⋈Author⋈Sub (``RedditThreeWayJoin.h:
12-30``) on the host (key-function joins) and on the device
(``Join(on=...)`` over ``type_name="objects"`` sets), comment → feature
vector extraction (``CommentFeatures.h:31-47``, body terms hashed by
crc32), the label selections and their 2 × 11 partition grid, label
propagation over the author relation (``RedditCommentLabelJoin.h``), a
per-author count and the inference join: features → one
``BlockedTensor`` → the FF model's forward on the card → argmax back
onto the records (``RedditCommentInferenceJoin.h``).
"""

from __future__ import annotations

import dataclasses
import math
import random
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.plan.computations import (
    Aggregate, Filter, Join, ScanSet, WriteSet,
)

# Feature layout: 9 time-derived features (reference
# ``CommentFeatures.h::push_time_features`` normalizes mday/sec/min/hour/
# mon/year/wday/yday/isdst) + numeric comment fields + hashed body terms.
NUM_TIME_FEATURES = 9
NUM_NUMERIC_FEATURES = 6
DEFAULT_HASH_FEATURES = 49  # total 64 (the reference's sparse
                            # NUM_FEATURES=400000 one-hot, hashed)


@dataclasses.dataclass
class Comment:
    """Reference ``reddit::Comment`` (``RedditComment.h:21-66``),
    reduced to the fields its feature extractor and joins consume."""

    index: int
    id: str
    author: str
    subreddit_id: str
    body: str = ""
    label: int = 0
    score: int = 0
    gilded: int = 0
    controversiality: int = 0
    archived: bool = False
    stickied: bool = False
    created_utc: int = 0
    author_created_utc: int = 0


@dataclasses.dataclass
class Author:
    """Reference ``reddit::Author`` (``RedditAuthor.h:16-35``)."""

    author_id: int
    author: str
    karma: int = 0


@dataclasses.dataclass
class Sub:
    """Reference ``reddit::Sub`` (``RedditSub.h:17-65``), reduced."""

    id: str
    display_name: str = ""
    subscribers: int = 0
    lang: str = "en"


@dataclasses.dataclass
class FullFeatures:
    """Three-way-join output — reference ``reddit::FullFeatures``
    (``RedditFullFeatures.h``): one row joining comment, author, sub."""

    index: int
    label: int
    comment_id: str
    author_id: int
    sub_id: str
    features: np.ndarray


def generate(num_comments: int = 200, num_authors: int = 20,
             num_subs: int = 8, seed: int = 0,
             ) -> Tuple[List[Comment], List[Author], List[Sub]]:
    """Seeded micro-instance (the reference loads real dump files via
    ``LoadRedditComments.cc``; tests use synthetic data)."""
    rng = random.Random(seed)
    authors = [Author(author_id=i, author=f"user{i}",
                      karma=rng.randrange(0, 100000))
               for i in range(num_authors)]
    subs = [Sub(id=f"t5_{i:05x}", display_name=f"sub{i}",
                subscribers=rng.randrange(100, 10_000_000))
            for i in range(num_subs)]
    words = ["the", "a", "cat", "dog", "tpu", "jax", "mesh", "pallas",
             "good", "bad", "fast", "slow"]
    comments = []
    for i in range(num_comments):
        comments.append(Comment(
            index=i,
            id=f"c{i:06d}",
            author=rng.choice(authors).author,
            subreddit_id=rng.choice(subs).id,
            body=" ".join(rng.choices(words, k=rng.randrange(3, 12))),
            label=rng.choice([0, 1]),
            score=rng.randrange(-50, 5000),
            gilded=rng.randrange(0, 3),
            controversiality=rng.choice([0, 0, 0, 1]),
            archived=rng.random() < 0.1,
            stickied=rng.random() < 0.05,
            created_utc=1_500_000_000 + rng.randrange(0, 200_000_000),
            author_created_utc=1_200_000_000 + rng.randrange(0, 300_000_000),
        ))
    return comments, authors, subs


# --- feature extraction (CommentsToFeatures / CommentFeatures) --------

def _time_features(utc: int) -> List[float]:
    """Normalized calendar features — reference ``push_time_features``
    (``CommentFeatures.h:36-46``). Pure arithmetic (no tm struct): day
    granularity is what the normalization keeps anyway."""
    days = utc / 86400.0
    secs = utc % 86400
    return [
        ((days % 30.44) + 1) / 31.0,          # mday
        (utc % 60) / 60.0,                    # sec
        ((utc // 60) % 60) / 59.0,            # min
        (secs // 3600) / 23.0,                # hour
        ((days / 30.44) % 12) / 11.0,         # mon
        (1970 + days / 365.25) / 2021.0,      # year
        ((int(days) + 4) % 7) / 6.0,          # wday (epoch was Thursday)
        ((days % 365.25)) / 365.0,            # yday
        0.0,                                  # isdst (UTC: never)
    ]


def body_hash_counts(body: str,
                     hash_dim: int = DEFAULT_HASH_FEATURES) -> np.ndarray:
    """Body text → term-count buckets (hash_dim - 9 wide; 9 slots are
    taken by the second time-feature set). crc32, not hash(): per-
    process salting would make features differ across runs and break
    stored-set reproducibility. Shared by the scalar path here and the
    columnar ingest (``reddit_columnar.columnarize``) so the two
    feature pipelines cannot drift."""
    counts = np.zeros(hash_dim - 9, np.float32)
    for w in body.split():
        counts[zlib.crc32(w.encode()) % (hash_dim - 9)] += 1.0
    return counts


def comment_features(c: Comment,
                     hash_dim: int = DEFAULT_HASH_FEATURES) -> np.ndarray:
    """Comment → dense feature vector. The reference emits author-time
    features + comment-time features + numeric fields + a 400k-wide
    sparse body encoding; this emits the same signal with the body hashed
    into ``hash_dim - 9`` buckets (dense; the total vector width is
    ``feature_dim(hash_dim)``)."""
    if hash_dim <= 9:
        raise ValueError(f"hash_dim must be > 9, got {hash_dim}")
    feats = _time_features(c.author_created_utc)
    feats += _time_features(c.created_utc)
    numeric = [
        math.tanh(c.score / 1000.0),
        float(c.gilded),
        float(c.controversiality),
        float(c.archived),
        float(c.stickied),
        math.tanh(len(c.body) / 256.0),
    ]
    body = body_hash_counts(c.body, hash_dim)
    vec = np.concatenate([
        np.asarray(feats, np.float32),
        np.asarray(numeric, np.float32),
        np.tanh(body),
    ])
    return vec


def feature_dim(hash_dim: int = DEFAULT_HASH_FEATURES) -> int:
    return 2 * NUM_TIME_FEATURES + NUM_NUMERIC_FEATURES + (hash_dim - 9)


# --- record → blocked matrix (CommentsToChunks → CommentBlockToMatrix)

def features_to_blocked(rows: Sequence[np.ndarray],
                        block: Tuple[int, int] = (128, 128),
                        device=None) -> BlockedTensor:
    """Stack per-row feature vectors into one ``batch × features``
    BlockedTensor — the reference's chunk/block pipeline
    (``CommentsToChunks.h``, ``CommentChunksToBlocks.h``,
    ``CommentBlockToMatrix.h:45-56``) whose ragged-last-chunk handling
    becomes block padding. Layout is (batch, features), the FF model's
    input convention; the tensor lives on ``device`` (CUDA unless
    asked)."""
    dense = np.stack(list(rows), axis=0).astype(np.float32)
    return BlockedTensor.from_dense(dense, block, device=device)


# --- computation DAG builders ----------------------------------------

def build_three_way_join(db: str = "reddit") -> WriteSet:
    """Comment⋈Author⋈Sub → FullFeatures rows — reference
    ``ThreeWayJoin : JoinComp<FullFeatures, Comment, Author, Sub>``
    (``RedditThreeWayJoin.h:12-30``; driver
    ``src/tests/source/TestRedditThreeWayJoin.cc``). Two chained hash
    equi-joins on the host-relational path."""
    comments = ScanSet(db, "comments")
    authors = ScanSet(db, "authors")
    subs = ScanSet(db, "subs")
    ca = Join(comments, authors,
              left_key=lambda c: c.author,
              right_key=lambda a: a.author,
              label="comment_author")
    cas = Join(ca, subs,
               left_key=lambda p: p[0].subreddit_id,
               right_key=lambda s: s.id,
               project=lambda p, s: FullFeatures(
                   index=p[0].index, label=p[0].label,
                   comment_id=p[0].id, author_id=p[1].author_id,
                   sub_id=s.id,
                   features=comment_features(p[0])),
               label="three_way")
    return WriteSet(cas, db, "full_features")


def build_three_way_join_device(db: str = "reddit") -> WriteSet:
    """The SAME three-way Comment⋈Author⋈Sub as a device-engine DAG:
    sets created with ``type_name="objects"`` columnarize at ingest
    (string keys dictionary-encode), and ``Join(on=...)`` lowers each
    string-key equi-join to one device LUT gather
    (``relational.autojoin.equijoin``). Output: one ColumnTable extending
    comments with the gathered author/sub columns (reference
    ``RedditThreeWayJoin.h:12-30``; per-tuple String hash probes
    ``JoinPairArray.h:122`` re-priced as code gathers)."""
    comments = ScanSet(db, "comments")
    ca = Join(comments, ScanSet(db, "authors"),
              on=("author", "author"), take=("author_id", "karma"),
              label="comment_author_dev")
    cas = Join(ca, ScanSet(db, "subs"),
               on=("subreddit_id", "id"), take=("subscribers",),
               label="three_way_dev")
    return WriteSet(cas, db, "full_features_table")


def label_selection(db: str, positive: bool) -> WriteSet:
    """Reference ``RedditPositiveLabelSelection`` /
    ``RedditNegativeLabelSelection`` — filter comments by label."""
    want = 1 if positive else 0
    scan = ScanSet(db, "comments")
    f = Filter(scan, lambda c, w=want: c.label == w,
               label="positive" if positive else "negative")
    return WriteSet(f, db, "labeled_pos" if positive else "labeled_neg")


def label_partition_selections(db: str, num_parts: int = 11,
                               ) -> List[WriteSet]:
    """The reference's 2×11 grid of tiny ``RedditLabelSelection{i}_{j}``
    variants partitions labeled comments by (label, index % parts) so
    each slice lands in its own set (Lachesis placement fodder). One
    parameterized builder replaces the 60 generated classes."""
    outs = []
    for label in (0, 1):
        for part in range(num_parts):
            scan = ScanSet(db, "comments")
            f = Filter(scan,
                       lambda c, l=label, p=part, n=num_parts:
                       c.label == l and c.index % n == p,
                       label=f"label{label}_{part}")
            outs.append(WriteSet(f, db, f"labeled_{label}_{part}"))
    return outs


def build_label_propagation(db: str = "reddit") -> WriteSet:
    """Reference ``RedditCommentLabelJoin`` — join unlabeled comments
    with a labeled set by author and adopt the neighbour's label
    (label propagation over the author relation)."""
    unlabeled = ScanSet(db, "comments")
    labeled = ScanSet(db, "labeled_pos")

    def adopt(c: Comment, l: Comment) -> Comment:
        out = dataclasses.replace(c)
        out.label = l.label
        return out

    j = Join(unlabeled, labeled,
             left_key=lambda c: c.author,
             right_key=lambda l: l.author,
             project=adopt, label="label_join")
    return WriteSet(j, db, "propagated")


def build_author_comment_counts(db: str = "reddit") -> WriteSet:
    """Group-by used in the workload's stats queries: author → number of
    comments (the aggregation side of the Lachesis experiments)."""
    scan = ScanSet(db, "comments")
    agg = Aggregate(scan, key=lambda c: c.author, value=lambda c: 1,
                    combine=lambda a, b: a + b, label="per_author_count")
    return WriteSet(agg, db, "author_counts")


# --- inference join ---------------------------------------------------

def infer_labels(client, comments: Sequence[Comment], model, params,
                 db: str = "reddit",
                 block: Tuple[int, int] = (128, 128)) -> List[Comment]:
    """Feature-extract → blocked matrix → FF forward on device → argmax
    → join predictions back onto comment records by row index — the
    reference's ``RedditCommentInferenceJoin`` over the model output set
    (driver ``TestRedditInference.cc`` pattern)."""
    feats = [comment_features(c) for c in comments]
    x = features_to_blocked(feats, block, device=params.w1.data.device)
    probs = model.forward(params, x)          # labels × batch
    pred = probs.to_dense().argmax(dim=0)[:len(comments)].cpu().numpy()
    out = []
    for c, p in zip(comments, pred):
        c2 = dataclasses.replace(c)
        c2.label = int(p)
        out.append(c2)
    if client is not None:
        if not client.set_exists(db, "inferred"):
            client.create_set(db, "inferred")
        client.clear_set(db, "inferred")
        client.send_data(db, "inferred", out)
    return out
