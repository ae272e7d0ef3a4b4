"""Model-weight deduplication — counterpart of ``netsdb_tpu/dedup/``:
block fingerprints and set aliasing (``detector``), the LSH index over
block signatures (``lsh``) and the shared device block pool (``pool``)."""

from netsdb_tpu_torch.dedup.detector import (
    block_fingerprints,
    dedup_weight_sets,
    find_shared_blocks,
    pack_blocks_into_pages,
)

__all__ = ["block_fingerprints", "find_shared_blocks", "dedup_weight_sets",
           "pack_blocks_into_pages"]
