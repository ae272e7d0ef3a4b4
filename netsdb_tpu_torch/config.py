"""Configuration — the port's ``netsdb_tpu.config.Configuration``, every
field with the reference's default — and the rule that picks the
device."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

import torch

# knobs of the reference that belong to later items of ROADMAP.md A:
# setting one away from its default raises, naming the item
_LATER = {
    # A7 part 2: the daemon pool — pin auto-sizing from the attribution
    # ledger, rebalancing
    "device_cache_pin_auto": (False, "A7 part 2"),
    "rebalance": (False, "A7 part 2"),
    "rebalance_skew_ratio": (2.0, "A7 part 2"),
    "rebalance_windows": (3, "A7 part 2"),
    "rebalance_max_bytes_per_round": (64 * 1024 * 1024, "A7 part 2"),
    # A8: the lock-order witness
    "lock_witness": (False, "A8"),
}


def _compile_cache_default() -> Optional[str]:
    return os.environ.get("NETSDB_TPU_COMPILE_CACHE", "auto")


@dataclasses.dataclass
class Configuration:
    """Every field of ``netsdb_tpu.config.Configuration``, each with the
    reference's default (``root_dir`` excepted: the port's lies under
    the temporary directory).

    Knobs the port reads:

    ``default_block_shape`` is the block a matrix set gets when
    ``send_matrix`` is given none (as in the reference package).
    ``root_dir`` is where durable sets and the page arena's spill files
    live (``data_dir``); nothing is written there until a paged or
    persistent set asks for it. ``shared_mem_bytes`` is the store's
    eviction budget (``SetStore.max_host_bytes``).

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
    ``obs_explain`` records an EXPLAIN tree for every traced query.

    The distributed matmul keeps the reference's knobs and defaults:
    ``distributed_matmul`` (off) routes a streamed matmul over a paged
    operand through SUMMA over ``summa_participants`` positions (None:
    every visible one), on the ``summa_grid`` processor grid (``"PRxPC"``
    or a pair; None: the 1-d mesh) when it fits
    (``parallel/summa.py``; a malformed grid raises where it is read).

    Knobs that no in-process path of the reference reads either, taken
    as given: ``mesh_shape`` and ``mesh_axis_names`` (meshes come from
    placements and ``make_mesh``), ``compute_dtype``, ``accum_dtype`` and
    ``storage_dtype``
    (dtypes are chosen per call, f32 by default), ``log_level`` and
    ``num_threads`` (the served daemon's job slots). ``enable_compression``
    is taken as given too: the port's spill files are its own format,
    written uncompressed whatever it says.

    ``donate_fold_buffers`` has no counterpart: a fold step's state is
    updated in place by its program or replaced by the next step's
    output, and nothing is donated. None and False are accepted; True
    raises ``ValueError``. ``compilation_cache_dir`` accepts ``"auto"``
    and None (or ""): the port's programs are CUDA graphs of the process
    and nothing is persisted; a directory raises ``NotImplementedError``
    (the shippable compiled plan, ROADMAP.md A8).

    The one-daemon serving knobs keep the reference's defaults and
    checks: the query scheduler's ``sched_lanes`` (lane weights),
    ``sched_lane_quota``, ``sched_aging_every``, ``sched_coalesce*`` and
    ``sched_affinity*``; the sessions' ``session_ttl_s`` (> 0) and
    ``session_state_bytes`` (>= 0); the decode runtime's
    ``decode_batch_max`` (>= 1) and ``model_dedup``. Replication and
    failover keep theirs: ``ha_election_timeout_s`` is the window every
    earlier succession peer must stay dead before a follower promotes
    (``ServeController.arm_ha``), and ``ha_mutlog`` turns on the durable
    mutation log (``storage/mutlog.py``): mirrored frames are logged for
    log-replay resync, and the placement map and the handoff buffer
    persist across a leader restart. The log flushes to the operating
    system on every append without ``fsync`` (the reference's default):
    it survives a process crash, and a power loss that drops its last
    records costs a re-execution under their idempotency tokens, never
    a divergence.

    Observability keeps the reference's knobs and defaults: the served
    daemon traces queries unless ``obs_enabled`` is off, keeps the last
    ``obs_trace_ring`` profiles, mints a query id for 1 in
    ``obs_trace_sample`` (>= 1) client requests, logs a profile of
    ``obs_slow_query_s`` or more to ``<root_dir>/slowlog/`` (at most
    ``obs_slowlog_entries`` files), profiles traced queries with
    ``torch.profiler`` into ``obs_device_profile_dir`` when set, and
    snapshots the registry every ``obs_history_interval_s`` (0: no
    thread) into a ring of ``obs_history_len`` readings.
    ``obs_hist_samples`` is taken as given: the registry's histograms
    keep 512 samples, and the reference reads the knob nowhere either.
    ``sched_feedback`` reseeds the scheduler's lane weights and quotas
    from the attribution and operator ledgers every
    ``sched_feedback_every`` admissions; ``sched_slo_shed`` halves the
    heaviest lane's quota while an objective breaches on every window.

    Every knob of a later ROADMAP.md item (``_LATER``: the daemon pool,
    the lock witness) raises ``NotImplementedError`` naming its item when set
    away from its default."""

    # --- tensor blocking ---
    default_block_shape: Tuple[int, int] = (512, 512)
    # --- dtypes (read by no in-process path, as in the reference) ---
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    storage_dtype: str = "float32"
    # --- host page store (native runtime) ---
    page_size_bytes: int = 64 * 1024 * 1024
    shared_mem_bytes: int = 4 * 1024 * 1024 * 1024
    page_pool_bytes: Optional[int] = None
    root_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "netsdb_tpu_torch"))
    # --- mesh defaults (read by no in-process path) ---
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    # --- staged streaming (plan/staging.py) ---
    stream_prefetch_pages: int = 2
    stage_depth: int = 2
    shape_bucketing: bool = True
    bucket_density: int = 2
    # --- fusion-aware plan compilation (plan/fusion.py) ---
    plan_fusion: bool = True
    fusion_min_region: int = 2
    fusion_cost_source: str = "ledger"
    fusion_mapper: str = "optimal"
    fusion_stage_budget_bytes: int = 0
    # --- device block cache (storage/devcache.py) ---
    device_cache_bytes: int = 256 * 1024 * 1024
    device_cache_partial: bool = True
    device_cache_pin_bytes: int = 0
    device_cache_dirty_log: int = 64
    # --- distributed linear algebra (parallel/summa.py) ---
    distributed_matmul: bool = False
    summa_participants: Optional[int] = None
    summa_grid: Optional[str] = None
    device_cache_pin_auto: bool = False
    donate_fold_buffers: Optional[bool] = None
    # --- observability ---
    obs_enabled: bool = True
    obs_trace_ring: int = 64
    obs_hist_samples: int = 512
    obs_trace_sample: int = 1
    obs_slow_query_s: Optional[float] = 5.0
    obs_slowlog_entries: int = 64
    obs_device_profile_dir: Optional[str] = None
    obs_explain: bool = True
    obs_history_interval_s: float = 5.0
    obs_history_len: int = 120
    # --- serving (one daemon, its shard pool, followers and HA; the
    # rebalancing knobs are A7 part 2) ---
    sched_lanes: Optional[Dict[str, float]] = None
    sched_lane_quota: int = 0
    sched_aging_every: int = 8
    sched_coalesce: bool = True
    sched_coalesce_done_ttl_s: float = 0.0
    sched_coalesce_done_max: int = 32
    sched_affinity: bool = True
    sched_affinity_wait_s: float = 30.0
    shard_handoff_bytes: int = 256 * 1024 * 1024
    rebalance: bool = False
    rebalance_skew_ratio: float = 2.0
    rebalance_windows: int = 3
    rebalance_max_bytes_per_round: int = 64 * 1024 * 1024
    ha_election_timeout_s: float = 5.0
    ha_mutlog: bool = False
    sched_feedback: bool = False
    sched_feedback_every: int = 64
    sched_slo_shed: bool = False
    session_ttl_s: float = 600.0
    session_state_bytes: int = 16 * 1024 * 1024
    decode_batch_max: int = 8
    model_dedup: bool = False
    lock_witness: bool = False
    # --- execution ---
    num_threads: int = 4
    enable_compression: bool = True
    log_level: str = "WARNING"
    compilation_cache_dir: Optional[str] = dataclasses.field(
        default_factory=_compile_cache_default)

    def __post_init__(self) -> None:
        for name, (default, item) in _LATER.items():
            value = getattr(self, name)
            if isinstance(default, tuple) and isinstance(value, list):
                value = tuple(value)
            if value != default:
                raise NotImplementedError(
                    f"Configuration({name}=...) is not ported yet: "
                    f"ROADMAP.md {item}")
        if self.donate_fold_buffers:
            raise ValueError(
                "donate_fold_buffers=True has no counterpart in the port: "
                "fold states are updated in place or replaced, never "
                "donated")
        if self.compilation_cache_dir not in (
                None, "", "auto", _compile_cache_default()):
            raise NotImplementedError(
                "Configuration(compilation_cache_dir=<dir>): a persisted "
                "compiled plan is not ported yet: ROADMAP.md A8")
        if self.obs_trace_sample < 1:
            raise ValueError(f"obs_trace_sample must be >= 1, got "
                             f"{self.obs_trace_sample!r}")
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
        if self.session_ttl_s <= 0:
            raise ValueError(f"session_ttl_s must be > 0, got "
                             f"{self.session_ttl_s!r}")
        if self.session_state_bytes < 0:
            raise ValueError(f"session_state_bytes must be >= 0, got "
                             f"{self.session_state_bytes!r}")
        if self.decode_batch_max < 1:
            raise ValueError(f"decode_batch_max must be >= 1, got "
                             f"{self.decode_batch_max!r}")
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
