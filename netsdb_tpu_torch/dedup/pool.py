"""Device-resident shared block pool — counterpart of
``netsdb_tpu/dedup/pool.py`` (reference ``SharedTensorBlockSet.h:25``,
``PDBClient.h:113-138``): fine-tuned variants that share most blocks
keep one copy of each distinct block on the card.

Every block is keyed by a hash of its bytes, and exactly equal blocks
share one slot of a stacked pool ``(P, bh, bw)``. The LSH index
(:mod:`netsdb_tpu_torch.dedup.lsh`) groups the near-duplicate blocks
for the report when it is asked for (``lsh_groups``,
``verified_pairs``), but decides nothing: the reference byte-compares
only blocks its LSH grouped, and above 8 blocks a bucket its anchor
heuristic pairs each block with the bucket's first only, so past a few
thousand blocks it leaves most byte-equal blocks unpooled. Each model keeps an int32 slot grid. A
:class:`PooledTensor` stored in a set is assembled back into its
``BlockedTensor`` when read (one ``index_select`` and a permute); the
assembly is cached on the pooled tensor, so consecutive reads gather once
(``assembly_count``), and ``drop_cache`` (the store's
``drop_pool_caches`` under memory pressure) releases it. Only
bit-identical blocks share a slot, so every pooled model reads back
exactly as it was.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor


class BlockPool:
    """The distinct blocks of one (block shape, dtype) class, stacked on
    the device — the SharedTensorBlockSet."""

    def __init__(self, blocks: torch.Tensor, num_refs: int,
                 total_blocks: int):
        self.blocks = blocks  # (P, bh, bw)
        self.num_refs = num_refs
        self.total_blocks = total_blocks

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()


class PooledTensor:
    """A model tensor held as slots into a shared :class:`BlockPool`,
    stored in a set in place of its ``BlockedTensor``; the store hands
    out its assembly (``SetStore.get_items``)."""

    def __init__(self, pool: BlockPool, slots: np.ndarray, meta: BlockMeta):
        self.pool = pool
        self.slots = np.asarray(slots, np.int32)  # (gh, gw)
        self.meta = meta
        self._slot_index = torch.from_numpy(
            self.slots.reshape(-1).astype(np.int64)).to(pool.blocks.device)
        self._cache: Optional[BlockedTensor] = None
        self.assembly_count = 0  # gathers performed

    def assemble(self) -> BlockedTensor:
        if self._cache is not None:
            return self._cache
        self.assembly_count += 1
        gh, gw = self.slots.shape
        bh, bw = self.meta.block_shape
        picked = self.pool.blocks.index_select(0, self._slot_index)
        dense = (picked.reshape(gh, gw, bh, bw).permute(0, 2, 1, 3)
                 .reshape(gh * bh, gw * bw))
        self._cache = BlockedTensor(dense, self.meta)
        return self._cache

    @property
    def cached(self) -> Optional[BlockedTensor]:
        """The cached assembly, or None."""
        return self._cache

    @property
    def cache_nbytes(self) -> int:
        if self._cache is None:
            return 0
        return self._cache.data.numel() * self._cache.data.element_size()

    def drop_cache(self) -> int:
        """Release the cached assembly; returns the bytes released."""
        released = self.cache_nbytes
        self._cache = None
        return released

    @property
    def nbytes_resident(self) -> int:
        """Bytes this tensor alone holds (its slot grid); the shared pool
        counts once at the store (``SetStore.live_pool_bytes``)."""
        return int(self.slots.nbytes)

    def __reduce__(self):
        # pickled as the whole tensor: the pool is a residency saving,
        # not a disk format
        t = self.assemble()
        return (_rebuild_blocked, (t.data.detach().cpu(), t.meta.shape,
                                   t.meta.block_shape, str(t.device)))


def _rebuild_blocked(data, shape, block_shape, device):
    return BlockedTensor(data.to(device), BlockMeta(tuple(shape),
                                                    tuple(block_shape)))


def pool_models(tensors: Dict[str, BlockedTensor], bands: int = 16,
                n_bits: int = 128, seed: int = 0, report_lsh: bool = True
                ) -> Tuple[Dict[str, PooledTensor], Dict]:
    """One shared pool over the given 2-D model tensors, which must share
    block shape and dtype (one pool class). Byte-equal blocks share a
    slot; with ``report_lsh`` LSH's near-duplicate groups are reported
    (``lsh_groups``, ``verified_pairs``), without it no LSH work is done.
    Returns ({name: PooledTensor}, report)."""
    from netsdb_tpu_torch.dedup.lsh import LSHIndex

    metas = {n: t.meta for n, t in tensors.items()}
    classes = {(m.block_shape, str(tensors[n].dtype))
               for n, m in metas.items()}
    if len(classes) > 1:
        raise ValueError(f"pool_models needs one block class; got {classes}")
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError(f"pool_models needs one device; got {devices}")

    slot_of: Dict[bytes, int] = {}  # hash of a block's bytes → slot
    stacked: List[np.ndarray] = []
    slots: Dict[str, np.ndarray] = {}
    shared_hits = 0
    total = 0
    for name, t in tensors.items():
        gh, gw = t.meta.grid
        bh, bw = t.meta.block_shape
        host = t.data.detach().cpu().numpy().reshape(
            gh, bh, gw, bw).transpose(0, 2, 1, 3)
        grid = np.zeros((gh, gw), np.int32)
        for i in range(gh):
            for j in range(gw):
                total += 1
                blk = host[i, j]
                key = hashlib.blake2b(blk.tobytes(), digest_size=16).digest()
                slot = slot_of.get(key)
                if slot is None:
                    slot = len(stacked)
                    stacked.append(blk)
                    slot_of[key] = slot
                else:
                    shared_hits += 1
                grid[i, j] = slot
        slots[name] = grid

    device = devices.pop()
    pool = BlockPool(torch.from_numpy(np.stack(stacked)).to(device),
                     num_refs=total, total_blocks=total)
    pooled = {name: PooledTensor(pool, slots[name], metas[name])
              for name in tensors}
    bytes_before = sum(int(np.prod(m.padded_shape))
                       * tensors[n].data.element_size()
                       for n, m in metas.items())
    report = {
        "models": len(tensors),
        "total_blocks": total,
        "unique_blocks": len(stacked),
        "shared_block_refs": shared_hits,
    }
    if report_lsh:
        index = LSHIndex(n_bits=n_bits, bands=bands, seed=seed)
        for name, t in tensors.items():
            index.add_model(name, t)
        report["lsh_groups"] = len(index.near_duplicate_groups())
        report["verified_pairs"] = index.verified_pairs
    report.update(hbm_bytes_before=bytes_before,
                  hbm_bytes_pooled=pool.nbytes,
                  hbm_savings_pct=round(100 * (1 - pool.nbytes
                                               / max(bytes_before, 1)), 1))
    return pooled, report
