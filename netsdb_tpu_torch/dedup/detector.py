"""Model-weight deduplication — counterpart of
``netsdb_tpu/dedup/detector.py`` (reference ``TensorBlockIndex.h:36``,
``SharedTensorBlockSet.h:25`` and the offline page-packing tools).

A block's fingerprint is the sha256 of its C-order float32 bytes, the
padded margin included (optionally of its values rounded to a quantum,
so near-identical fine-tuned weights match too): the same hex digest as
the reference's for the same block. Fingerprints are taken on the host,
from one copy of the tensor. Whole sets alias through the store's
``add_shared_mapping``.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from netsdb_tpu_torch.core.blocked import BlockedTensor


def _fingerprint(block: np.ndarray, quantize: Optional[float]) -> str:
    if quantize:
        block = np.round(block / quantize).astype(np.int64)
    return hashlib.sha256(np.ascontiguousarray(block).tobytes()).hexdigest()


def _host_blocks(tensor: BlockedTensor):
    """``(index, block)`` pairs of ``tensor`` as numpy views of one host
    copy, in row-major block order."""
    data = tensor.data.detach().cpu().numpy()
    for index in np.ndindex(*tensor.meta.grid):
        yield index, data[tensor.meta.block_slice(index)]


def block_fingerprints(tensor: BlockedTensor,
                       quantize: Optional[float] = None) -> Dict[tuple, str]:
    """{block index: content hash} — the TensorBlockIndex of one tensor."""
    return {idx: _fingerprint(blk, quantize)
            for idx, blk in _host_blocks(tensor)}


def find_shared_blocks(client, sets: Sequence[Tuple[str, str]],
                       quantize: Optional[float] = None
                       ) -> Dict[str, List[Tuple[str, tuple]]]:
    """Across the given (db, set) weight sets, the block locations of
    every fingerprint that appears at least twice: {hash: [(set key,
    block index), ...]}."""
    table: Dict[str, List[Tuple[str, tuple]]] = {}
    for db, set_name in sets:
        t = client.get_tensor(db, set_name)
        for idx, h in block_fingerprints(t, quantize).items():
            table.setdefault(h, []).append((f"{db}:{set_name}", idx))
    return {h: locs for h, locs in table.items() if len(locs) > 1}


def dedup_weight_sets(client, private_db: str, private_set: str,
                      shared_db: str, shared_set: str,
                      quantize: Optional[float] = None) -> Dict:
    """If two weight sets match block for block, alias the private set
    onto the shared one (reference ``PDBClient.h:113-138``). Returns the
    report: blocks, matching blocks and whether it aliased."""
    a = client.get_tensor(private_db, private_set)
    b = client.get_tensor(shared_db, shared_set)
    fa = block_fingerprints(a, quantize)
    fb = block_fingerprints(b, quantize)
    matches = {idx: idx for idx in fa if idx in fb and fa[idx] == fb[idx]}
    report = {"total_blocks": len(fa), "matching_blocks": len(matches),
              "aliased": False}
    if len(matches) == len(fa) and a.meta == b.meta:
        client.add_shared_mapping(private_db, private_set,
                                  shared_db, shared_set,
                                  mapping={str(k): str(v)
                                           for k, v in matches.items()})
        report["aliased"] = True
    return report


def pack_blocks_into_pages(block_sizes: Dict[str, int], page_size: int,
                           groups: Optional[List[List[str]]] = None
                           ) -> List[List[str]]:
    """Greedy page packing of distinct blocks (reference ``page-packing``):
    the blocks of each model group first, then first-fit-decreasing into
    ``page_size`` bins. Returns pages as lists of block keys."""
    pages: List[List[str]] = []
    page_used: List[int] = []

    def fit(keys: List[str]):
        for k in sorted(keys, key=lambda k: -block_sizes[k]):
            size = block_sizes[k]
            if size > page_size:
                raise ValueError(f"block {k} ({size}) exceeds page size")
            for i, used in enumerate(page_used):
                if used + size <= page_size:
                    pages[i].append(k)
                    page_used[i] += size
                    break
            else:
                pages.append([k])
                page_used.append(size)

    seen = set()
    for group in (groups or []):
        fit([k for k in group if k in block_sizes and k not in seen])
        seen.update(group)
    fit([k for k in block_sizes if k not in seen])
    return pages


def bin_pack_tensors(tensors: Dict[str, List[str]], blocks_per_page: int
                     ) -> Tuple[List[List[str]], Dict[str, List[int]]]:
    """Tensor-aware bin packing — the reference's "Greedy-2" page packer
    (``PagePacking.py::bin_pack_greedy`` + ``findMinBinsMaxCover``): few
    pages per tensor, not just few pages. ``tensors``: name → block ids
    (shared blocks appear in several); ``blocks_per_page``: page
    capacity. Returns ``(pages, mapping)``, ``mapping[tensor]`` the
    sorted pages covering its blocks. The largest tensor goes first, its
    blocks by global frequency; each next one reuses the pages that hold
    its blocks and packs only the rest anew."""
    if blocks_per_page <= 0:
        raise ValueError("blocks_per_page must be positive")
    freq: Dict[str, int] = {}
    for blocks in tensors.values():
        for b in set(blocks):
            freq[b] = freq.get(b, 0) + 1

    pages: List[List[str]] = []
    where: Dict[str, int] = {}  # block id → page index
    mapping: Dict[str, List[int]] = {}

    def pack_new(blocks: List[str]) -> List[int]:
        used = []
        for b in sorted(blocks, key=lambda b: -freq[b]):
            if pages and len(pages[-1]) < blocks_per_page:
                pages[-1].append(b)
            else:
                pages.append([b])
            where[b] = len(pages) - 1
            used.append(where[b])
        return used

    for name in sorted(tensors, key=lambda n: -len(tensors[n])):
        blocks = list(dict.fromkeys(tensors[name]))  # dedup, keep order
        page_ids = {where[b] for b in blocks if b in where}
        page_ids.update(pack_new([b for b in blocks if b not in where]))
        mapping[name] = sorted(page_ids)
    return pages, mapping
