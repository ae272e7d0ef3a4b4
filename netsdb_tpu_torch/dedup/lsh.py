"""LSH index over weight-block signatures — counterpart of
``netsdb_tpu/dedup/lsh.py`` (reference ``model-inference/deduplication/
indexing``): near-duplicate blocks across a model zoo found without
comparing every pair.

A block's signature is random-hyperplane bits (SimHash), ``sign(block @
R)`` with R drawn from numpy's generator (the reference's draws): all
blocks of a tensor in one f32 product on the tensor's device, TF32 off.
Bands of ``rows`` bits bucket the blocks on the host; two blocks collide
when any band matches, and candidate pairs are verified by the Hamming
distance of their signatures. A dot product within rounding of 0 may
take the other sign on another device; that only moves a candidate,
since pooling byte-compares before sharing.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision

BlockRef = Tuple[str, tuple]  # (model name, block index)


def _projection(n_features: int, n_bits: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_features, n_bits)).astype(np.float32)


_proj_cache: Dict[Tuple[int, int, int, torch.device], torch.Tensor] = {}


def _device_projection(n_features: int, n_bits: int, seed: int,
                       device: torch.device) -> torch.Tensor:
    """The projection on ``device``, made once per shape, seed and device
    (tens of MB at weight-block sizes)."""
    key = (n_features, n_bits, seed, torch.device(device))
    if key not in _proj_cache:
        _proj_cache[key] = torch.from_numpy(
            _projection(n_features, n_bits, seed)).to(device)
    return _proj_cache[key]


def block_signatures(tensor: BlockedTensor, n_bits: int = 128,
                     seed: int = 0) -> Tuple[List[tuple], np.ndarray]:
    """All block signatures of one tensor in one product: (block indices
    in row-major order, (n_blocks, n_bits) uint8 bits)."""
    idxs = list(np.ndindex(*tensor.meta.grid))
    if tensor.meta.rank == 2:
        (gh, gw), (bh, bw) = tensor.meta.grid, tensor.meta.block_shape
        flat = (tensor.data.reshape(gh, bh, gw, bw).permute(0, 2, 1, 3)
                .reshape(gh * gw, bh * bw))
    else:
        flat = torch.stack([b.reshape(-1) for _, b in tensor.blocks()])
    flat = flat.to(torch.float32)
    proj = _device_projection(flat.shape[1], n_bits, seed, flat.device)
    full_f32_precision()
    bits = (flat @ proj) >= 0
    return idxs, bits.cpu().numpy().astype(np.uint8)


class LSHIndex:
    """Banded SimHash index over block signatures. ``n_bits`` must equal
    ``bands * rows``; the defaults (128 bits, 16 bands of 8) put the
    S-curve's knee near cosine 0.95."""

    def __init__(self, n_bits: int = 128, bands: int = 16, seed: int = 0):
        if n_bits % bands:
            raise ValueError(f"bands {bands} must divide n_bits {n_bits}")
        self.n_bits = n_bits
        self.bands = bands
        self.rows = n_bits // bands
        self.seed = seed
        self._buckets: Dict[Tuple[int, bytes], List[BlockRef]] = \
            collections.defaultdict(list)
        self._sigs: Dict[BlockRef, np.ndarray] = {}
        self.verified_pairs = 0

    def _band_keys(self, sig: np.ndarray) -> Iterable[Tuple[int, bytes]]:
        for b in range(self.bands):
            yield b, sig[b * self.rows:(b + 1) * self.rows].tobytes()

    def add_model(self, name: str, tensor: BlockedTensor) -> int:
        """Index every block; returns the number of blocks added."""
        idxs, sigs = block_signatures(tensor, self.n_bits, self.seed)
        for idx, sig in zip(idxs, sigs):
            ref = (name, idx)
            self._sigs[ref] = sig
            for key in self._band_keys(sig):
                self._buckets[key].append(ref)
        return len(idxs)

    def candidates(self, ref: BlockRef) -> List[BlockRef]:
        """Blocks sharing at least one band with ``ref`` (not itself)."""
        out = []
        seen = {ref}
        for key in self._band_keys(self._sigs[ref]):
            for other in self._buckets.get(key, ()):
                if other not in seen:
                    seen.add(other)
                    out.append(other)
        return out

    def hamming(self, a: BlockRef, b: BlockRef) -> int:
        return int(np.count_nonzero(self._sigs[a] != self._sigs[b]))

    # buckets up to this size are verified all pairs; above it, each
    # member against the bucket's first only (a true pair anchored by an
    # unrelated collision is found only through another band)
    _EXACT_BUCKET_MAX = 8

    def near_duplicate_groups(self, max_hamming: Optional[int] = None
                              ) -> List[List[BlockRef]]:
        """Union-find over the verified candidate pairs: the groups of
        near-duplicate blocks across every indexed model (each pair
        verified once, however many buckets it shares)."""
        if max_hamming is None:
            max_hamming = self.rows
        parent: Dict[BlockRef, BlockRef] = {r: r for r in self._sigs}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        self.verified_pairs = 0
        checked = set()
        for refs in self._buckets.values():
            if len(refs) < 2:
                continue
            if len(refs) <= self._EXACT_BUCKET_MAX:
                pairs = ((refs[i], refs[j]) for i in range(len(refs))
                         for j in range(i + 1, len(refs)))
            else:
                pairs = ((refs[0], other) for other in refs[1:])
            for a, b in pairs:
                key = (a, b) if a <= b else (b, a)
                if key in checked:
                    continue
                checked.add(key)
                self.verified_pairs += 1
                if self.hamming(a, b) <= max_hamming:
                    ra, rb = find(a), find(b)
                    if ra != rb:
                        parent[rb] = ra
        groups = collections.defaultdict(list)
        for r in self._sigs:
            groups[find(r)].append(r)
        return [sorted(g) for g in groups.values() if len(g) > 1]

    def stats(self) -> Dict[str, int]:
        sizes = [len(v) for v in self._buckets.values()]
        return {"blocks": len(self._sigs), "buckets": len(self._buckets),
                "max_bucket": max(sizes, default=0)}


def dedup_model_zoo(models: Dict[str, BlockedTensor], n_bits: int = 128,
                    bands: int = 16, max_hamming: Optional[int] = None,
                    seed: int = 0) -> Dict[str, object]:
    """Index a zoo; its near-duplicate groups and the share of all pairs
    that was verified."""
    index = LSHIndex(n_bits, bands, seed)
    for name, t in models.items():
        index.add_model(name, t)
    groups = index.near_duplicate_groups(max_hamming)
    n = len(index._sigs)
    total_pairs = n * (n - 1) // 2
    return {"groups": groups, "index_stats": index.stats(),
            "verified_pairs": index.verified_pairs,
            "all_pairs": total_pairs,
            "pair_work_fraction": (index.verified_pairs / total_pairs
                                   if total_pairs else 0.0)}


def bench_lsh_zoo(n_models: int = 100, blocks_per_model: int = 8,
                  block: int = 256, n_families: int = 10,
                  noise: float = 1e-4, seed: int = 0,
                  device=None) -> Dict[str, object]:
    """``n_models`` synthetic variants of ``n_families`` base models
    (numpy draws, the reference's), indexed and grouped on ``device``
    (CUDA unless the caller asks for another), with the build and probe
    times on the host clock."""
    from netsdb_tpu_torch.config import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    bases = [rng.standard_normal((blocks_per_model * block, block)
                                 ).astype(np.float32)
             for _ in range(n_families)]
    models = {}
    truth = {}
    for i in range(n_models):
        fam = i % n_families
        dense = bases[fam] + noise * rng.standard_normal(
            bases[fam].shape).astype(np.float32)
        models[f"model{i}"] = BlockedTensor.from_dense(dense, (block, block),
                                                       device=device)
        truth[f"model{i}"] = fam

    t0 = time.perf_counter()
    index = LSHIndex()
    for name, t in models.items():
        index.add_model(name, t)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    groups = index.near_duplicate_groups()
    probe_s = time.perf_counter() - t0

    pure = all(len({truth[name] for name, _ in g}) == 1 for g in groups)
    n = len(index._sigs)
    return {"models": n_models, "blocks": n,
            "build_s": round(build_s, 3), "probe_s": round(probe_s, 3),
            "groups": len(groups), "groups_family_pure": pure,
            "verified_pairs": index.verified_pairs,
            "all_pairs": n * (n - 1) // 2,
            "index_stats": index.stats()}
