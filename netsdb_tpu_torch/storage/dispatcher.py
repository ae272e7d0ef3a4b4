"""Ingestion partition policies — counterpart of
``netsdb_tpu/storage/dispatcher.py`` (the reference's dispatcher layer,
``src/dispatcher/headers/PartitionPolicy.h:29-60``), host-only code the
port keeps its own copy of.

Each policy splits a batch of host records into per-shard lists:
``RoundRobinPolicy`` (the default), ``RandomPolicy`` (seeded),
``FairPolicy`` (capacity-weighted) and ``HashPolicy``, the
partition-lambda mode. ``HashPolicy`` routes a key to shard
``crc32(_stable_key_bytes(key)) % n``, byte for byte as the reference
does, so a set dispatched by either package with the same key function
is co-partitioned with the other (and with a ``Partition`` node's
output). :func:`dispatch_to_sets` writes the shards into sets
``{base}_shard{i}`` of a client.
"""

from __future__ import annotations

import random
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence


class PartitionPolicy:
    """Base: ``partition(items, n_shards)`` → list of n_shards lists
    (reference ``PartitionPolicy::partition``, which maps NodeID →
    sub-vector)."""

    name = "default"

    def partition(self, items: Sequence[Any],
                  n_shards: int) -> List[List[Any]]:
        raise NotImplementedError


class RoundRobinPolicy(PartitionPolicy):
    """Cycle through shards item by item — the reference's default
    (``RoundRobinPolicy.h``). Deterministic and maximally even."""

    name = "roundrobin"

    def __init__(self, start: int = 0):
        self._next = start

    def partition(self, items, n_shards):
        out: List[List[Any]] = [[] for _ in range(n_shards)]
        for item in items:
            out[self._next % n_shards].append(item)
            self._next += 1
        return out


class RandomPolicy(PartitionPolicy):
    """Uniform random shard per item (``RandomPolicy.h``). Seeded, so
    a given dispatcher instance is replayable."""

    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def partition(self, items, n_shards):
        out: List[List[Any]] = [[] for _ in range(n_shards)]
        for item in items:
            out[self.rng.randrange(n_shards)].append(item)
        return out


class FairPolicy(PartitionPolicy):
    """Capacity-weighted split (``FairPolicy.h``): shard i receives a
    share of each batch proportional to ``weights[i]`` (the reference
    weights by node cores/memory from the ResourceManager)."""

    name = "fair"

    def __init__(self, weights: Sequence[float]):
        if not weights or any(w < 0 for w in weights) or sum(weights) == 0:
            raise ValueError("weights must be non-negative, sum > 0")
        self.weights = list(weights)

    def partition(self, items, n_shards):
        if n_shards != len(self.weights):
            raise ValueError(
                f"{n_shards} shards != {len(self.weights)} weights")
        total = sum(self.weights)
        out: List[List[Any]] = [[] for _ in range(n_shards)]
        # largest-remainder apportionment of the batch
        n = len(items)
        quotas = [w / total * n for w in self.weights]
        counts = [int(q) for q in quotas]
        remainder = n - sum(counts)
        by_frac = sorted(range(n_shards), key=lambda i: quotas[i] - counts[i],
                         reverse=True)
        for i in by_frac[:remainder]:
            counts[i] += 1
        it = iter(items)
        for shard, c in enumerate(counts):
            for _ in range(c):
                out[shard].append(next(it))
        return out


def _stable_key_bytes(key: Any) -> bytes:
    """Canonical encoding for hash routing: only value types whose
    textual form is stable across processes (default object repr embeds
    a memory address, which would silently break co-partitioning)."""
    if isinstance(key, (bool, int, float)):
        # numerically equal keys must route identically regardless of
        # Python type (1 == 1.0 == True, 0.0 == -0.0): the host equi-join
        # treats them as one key, so co-partitioning must too
        if isinstance(key, float) and not key.is_integer():
            return repr(key).encode()
        return repr(int(key)).encode()
    if key is None or isinstance(key, (str, bytes)):
        return repr(key).encode()
    if isinstance(key, (tuple, list)):
        return b"(" + b",".join(_stable_key_bytes(k) for k in key) + b")"
    raise TypeError(
        f"hash partition key must be a primitive or tuple of primitives, "
        f"got {type(key).__name__}; return one from key_fn")


class HashPolicy(PartitionPolicy):
    """Partition-lambda routing (the reference's IR/LambdaPolicy +
    ``createSet(..., partition_lambda)`` plumbing): shard =
    hash(key_fn(item)) % n. Items with equal keys always co-locate, so
    two sets dispatched with the same key_fn are co-partitioned for
    joins. ``key_fn`` must return a primitive (or tuple of primitives)
    so the hash is stable across processes."""

    name = "hash"

    def __init__(self, key_fn: Callable[[Any], Any]):
        self.key_fn = key_fn

    def partition(self, items, n_shards):
        out: List[List[Any]] = [[] for _ in range(n_shards)]
        for item in items:
            h = zlib.crc32(_stable_key_bytes(self.key_fn(item)))
            out[h % n_shards].append(item)
        return out


POLICIES: Dict[str, Callable[..., PartitionPolicy]] = {
    "roundrobin": RoundRobinPolicy,
    "random": RandomPolicy,
    "fair": FairPolicy,
    "hash": HashPolicy,
}


def make_policy(name: str, **kwargs) -> PartitionPolicy:
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; "
                         f"available: {', '.join(POLICIES)}")
    return POLICIES[name](**kwargs)


def dispatch_to_sets(client, db: str, base_name: str,
                     items: Sequence[Any], n_shards: int,
                     policy: Optional[PartitionPolicy] = None) -> List[str]:
    """Write one batch into per-shard sets ``{base}_shard{i}`` — the
    DispatcherServer → per-node StorageAddData fan-out
    (``src/serverFunctionalities/source/DispatcherServer.cc``), with
    sets standing in for nodes in the single-controller runtime.
    Returns the shard set names."""
    policy = policy or RoundRobinPolicy()
    parts = policy.partition(items, n_shards)
    names = []
    for i, part in enumerate(parts):
        name = f"{base_name}_shard{i}"
        if not client.set_exists(db, name):
            client.create_set(db, name, type_name="object")
        if part:
            client.send_data(db, name, part)
        names.append(name)
    return names
