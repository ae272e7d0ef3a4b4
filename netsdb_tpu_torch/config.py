"""Configuration — the subset of ``netsdb_tpu.config.Configuration``
that the ported path reads — and the rule that picks the device."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import torch

# knobs of the reference that belong to later items of ROADMAP.md A:
# setting one away from its default raises, naming the item
_LATER = {"distributed_matmul": (False, "A4"),
          "summa_grid": (None, "A4"),
          "device_cache_pin_auto": (False, "A7")}


@dataclasses.dataclass
class Configuration:
    """``default_block_shape`` is the block a matrix set gets when
    ``send_matrix`` is given none (as in the reference package).
    ``root_dir`` is where durable sets and the page arena's spill files
    live (``data_dir``); nothing is written there until a paged or
    persistent set asks for it.

    The paged path's knobs keep the reference's defaults
    (``netsdb_tpu/config.py``): pages of ``page_size_bytes`` in an arena
    capped at ``page_pool_bytes`` (None: ``shared_mem_bytes``), read
    ``stream_prefetch_pages`` ahead and uploaded ``stage_depth`` ahead
    of the consumer; ragged row blocks pad to the ``bucket_rows`` ladder
    (``shape_bucketing``, ``bucket_density`` buckets per octave); the
    device block cache holds ``device_cache_bytes`` of staged blocks,
    block by block when ``device_cache_partial``, with the first
    ``device_cache_pin_bytes`` of a set's head pinned against eviction;
    a paged relation's writes are logged as dirty row ranges, at most
    ``device_cache_dirty_log`` entries before the log folds into one
    whole-set entry.

    Fusion (``plan/fusion.py``) keeps the reference's knobs and
    defaults: ``plan_fusion`` on (paged plans run spine regions as one
    program each and graft chains onto streamed folds; off, node by
    node), ``fusion_min_region`` nodes at least per spine region (at
    least 2), ``fusion_cost_source`` ``"ledger"`` (the operator ledger's
    means) or ``"static"``, ``fusion_mapper`` ``"optimal"`` (the exact
    segmentation) or ``"greedy"``, and ``fusion_stage_budget_bytes`` (0:
    no budget) splitting a region whose staged-bytes estimate exceeds it.

    Knobs of later ROADMAP.md items (the distributed matmul, the
    automatic pin budget) raise ``NotImplementedError`` when set away
    from their defaults."""

    default_block_shape: Tuple[int, int] = (512, 512)
    root_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "netsdb_tpu_torch"))
    # --- host page store (native runtime) ---
    page_size_bytes: int = 64 * 1024 * 1024
    shared_mem_bytes: int = 4 * 1024 * 1024 * 1024
    page_pool_bytes: Optional[int] = None
    # --- staged streaming (plan/staging.py) ---
    stream_prefetch_pages: int = 2
    stage_depth: int = 2
    shape_bucketing: bool = True
    bucket_density: int = 2
    # --- device block cache (storage/devcache.py) ---
    device_cache_bytes: int = 256 * 1024 * 1024
    device_cache_partial: bool = True
    device_cache_pin_bytes: int = 0
    device_cache_dirty_log: int = 64
    # --- fusion-aware plan compilation (plan/fusion.py) ---
    plan_fusion: bool = True
    fusion_min_region: int = 2
    fusion_cost_source: str = "ledger"
    fusion_mapper: str = "optimal"
    fusion_stage_budget_bytes: int = 0
    # --- later items (see _LATER) ---
    distributed_matmul: bool = False
    summa_grid: Optional[str] = None
    device_cache_pin_auto: bool = False

    def __post_init__(self) -> None:
        for name, (default, item) in _LATER.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"Configuration({name}=...) is not ported yet: "
                    f"ROADMAP.md {item}")
        if self.device_cache_dirty_log < 1:
            raise ValueError(f"device_cache_dirty_log must be at least 1, "
                             f"got {self.device_cache_dirty_log!r}")
        if self.bucket_density not in (2, 4):
            raise ValueError(f"bucket_density must be 2 or 4, got "
                             f"{self.bucket_density!r}")
        if self.fusion_cost_source not in ("ledger", "static"):
            raise ValueError(f"fusion_cost_source must be 'ledger' or "
                             f"'static', got {self.fusion_cost_source!r}")
        if self.fusion_mapper not in ("optimal", "greedy"):
            raise ValueError(f"fusion_mapper must be 'optimal' or "
                             f"'greedy', got {self.fusion_mapper!r}")
        if self.fusion_stage_budget_bytes < 0:
            raise ValueError(f"fusion_stage_budget_bytes must be >= 0, "
                             f"got {self.fusion_stage_budget_bytes!r}")

    @property
    def data_dir(self) -> str:
        return os.path.join(self.root_dir, "data")

    def ensure_dirs(self) -> None:
        os.makedirs(self.data_dir, exist_ok=True)


def resolve_device(device=None) -> torch.device:
    """The device a client runs on: ``device`` if given, else CUDA.
    A CUDA device on a machine without a usable card is an error —
    the port never drops to the CPU on its own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "netsdb_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev
