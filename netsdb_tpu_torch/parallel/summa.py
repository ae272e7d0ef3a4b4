"""SUMMA-streamed distributed blocked matmul — counterpart of
``netsdb_tpu/parallel/summa.py``.

Per *Large Scale Distributed Linear Algebra With TPUs* (arxiv
2112.09017), a matmul whose operands exceed one device scales by keeping
each participant's PANEL local and moving one broadcast panel per step.
The left operand lives as arena pages (``storage/paged.py``) and each
participant stages ONLY its own panel through the bounded
``plan/staging.stage_stream`` pipeline.

1-d (:func:`summa_matmul_streamed`, N participants, C = A·B):

* A's row blocks are dealt round-robin (block *i* → participant
  ``i % N``): each stages 1/N of A;
* B is split into N contraction panels; participant *d* stages panel *d*;
* a round takes one block per participant and runs N steps: step *s*
  broadcasts participant *s*'s panel (a device copy, or none for
  positions that share a card) and every participant accumulates
  ``A_local[:, panel s] @ B_panel_s`` into its C tile, in step order;
* the C tiles land in the output rows of their blocks.

2-d (:func:`summa_grid_matmul_streamed`, a ``pr x pc`` grid): A's row
blocks deal over the grid rows and split column-wise over the grid
columns, B tiles over the whole grid, and each round runs ``pr*pc``
dual-broadcast steps (an A slice along the grid column, a B slice along
the grid row). Each device stages ~1/(pr·pc) of each operand.

One process drives every participant (:mod:`netsdb_tpu_torch.parallel.
mesh`); the local products are ``torch.matmul`` in full f32 (TF32 off),
the reference's ``Precision.HIGHEST``. The accumulation order is the
reference's: ``((0 + p_0) + p_1) + ...`` per tile, so integer-valued
operands give the single-position stream's bytes.

Staged A blocks ride the block-granular device cache under ``(scope,
"summa", bucket, label)``: :func:`mesh_label` (axis and participant
devices) or :func:`grid_label` (grid shape and devices), so a 4-position
layout never aliases a 1-position one and a warm rerun under the same
layout reads no page. ``parallel/reshard.reshard_summa_layout`` moves the
cached blocks between the two layouts.

The ``summa.*`` counters of the reference's metrics catalog
(:data:`COUNTERS`) tick in the port's registry.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel.mesh import move, visible_devices

#: stream kind for device-cache keys (a SUMMA block is placed on its
#: owner only — never interchangeable with a "trows" block)
CACHE_KIND = "summa"

#: the reference's ``summa.*`` metrics (``netsdb_tpu/obs/export.py``)
COUNTERS = (
    ("summa.rounds", "SUMMA rounds dispatched over the mesh (one per "
                     "N-block batch)"),
    ("summa.panel_bcasts", "B panels broadcast over the mesh axis by "
                           "SUMMA steps"),
    ("summa.panel_bytes", "bytes moved by SUMMA panel broadcasts"),
    ("summa.staged_bytes", "operand bytes staged host->device by SUMMA "
                           "runs (sum over participants)"),
    ("summa.grid_rounds", "2-d grid SUMMA rounds (one per pr-block "
                          "batch)"),
    ("summa.grid_steps", "dual-broadcast steps of 2-d grid rounds (pr*pc "
                         "per round)"),
    ("summa.grid_panel_bcasts", "A and B slices broadcast over the grid "
                                "axes (2 per grid step)"),
    ("summa.grid_staged_bytes", "operand bytes staged host->device by "
                                "2-d grid SUMMA runs"),
)
for _name, _help in COUNTERS:
    obs.REGISTRY.counter(_name)

#: mesh axis names of the 2-d grid (rows × columns of the processor
#: grid, not of the matrix)
GRID_AXES = ("gr", "gc")


def _ids(devices) -> str:
    return ",".join(str(d) for d in devices)


def mesh_label(axis: str, devices) -> str:
    """The sharding component of SUMMA cache keys: the axis name and the
    participants' devices, one entry per position."""
    return f"summa[{axis}={_ids(devices)}]"


def grid_label(devices, pr: int, pc: int) -> str:
    """Cache-key component of a grid layout: the grid shape and the
    participants, so a 2x2 never aliases a 1x4 or a 1-d layout."""
    return f"summa[{pr}x{pc}={_ids(devices)}]"


def grid_shape(config, num_devices: int) -> Optional[Tuple[int, int]]:
    """``config.summa_grid`` ("PRxPC" or a (pr, pc) pair) as a grid shape,
    or None when the knob is unset or the grid does not fit
    ``num_devices``. A malformed value raises."""
    raw = getattr(config, "summa_grid", None)
    if not raw:
        return None
    if isinstance(raw, str):
        try:
            pr, pc = (int(p) for p in raw.lower().split("x"))
        except ValueError:
            raise ValueError(f"summa_grid must be 'PRxPC', got {raw!r}")
    else:
        pr, pc = (int(p) for p in raw)
    if pr < 1 or pc < 1 or pr * pc < 2:
        raise ValueError(f"summa_grid needs >= 2 participants, got "
                         f"{pr}x{pc}")
    if pr * pc > num_devices:
        return None  # the grid does not fit this process's positions
    return pr, pc


def participants(config, device_type: str = "cuda") -> List[torch.device]:
    """The SUMMA participants: the visible positions of ``device_type``,
    capped at ``config.summa_participants``."""
    devices = list(visible_devices(device_type))
    cap = getattr(config, "summa_participants", None)
    return devices[:int(cap)] if cap else devices


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _uploaders(devices, depth: int):
    from netsdb_tpu_torch.plan import staging

    ups: Dict[torch.device, Any] = {}
    for d in devices:
        if d not in ups:
            ups[d] = staging.BlockUploader(d, depth)
    return ups


def _stream(store, name, place, depth, label, partial, ups):
    """The staged stream of ``name``'s blocks (one uploader per device:
    with a single device the stream fences it, otherwise each block is
    handed over as it is consumed)."""
    from netsdb_tpu_torch.plan import staging

    single = next(iter(ups.values())) if len(ups) == 1 else None
    return staging.stage_stream(
        store.stream_blocks(name) if partial is None else None, place,
        depth=depth, name=label, partial=partial, uploader=single)


def _as_rhs(rhs) -> Tuple[torch.Tensor, bool]:
    rhs = torch.as_tensor(rhs)
    squeeze = rhs.dim() == 1
    if squeeze:
        rhs = rhs[:, None]
    return rhs.to(torch.float32), squeeze


def _pad_block(block: np.ndarray, k_pad: int) -> np.ndarray:
    pad_c = k_pad - block.shape[1]
    return np.pad(block, ((0, 0), (0, pad_c))) if pad_c else block


def _partial_plan(store, name, cache, cache_scope, bucket, label):
    from netsdb_tpu_torch.plan import staging

    ranges = store.block_ranges(name)
    if cache is None or cache_scope is None or not cache.enabled \
            or not cache.partial or not ranges:
        return None
    return staging.PartialPlan(
        cache, (str(cache_scope), CACHE_KIND, bucket, label), ranges,
        lambda idxs: store.stream_blocks(name, blocks=idxs))


def summa_matmul_streamed(store, name: str, rhs,
                          devices: Optional[Sequence[torch.device]] = None,
                          axis: str = "data",
                          stage_depth: Optional[int] = None,
                          cache=None, cache_scope: Optional[str] = None,
                          stats_out: Optional[Dict[str, Any]] = None
                          ) -> torch.Tensor:
    """``out = M @ rhs`` with M streamed from the page arena and the
    compute SUMMA-distributed over ``devices`` (default: the visible
    positions). ``store`` is a :class:`~netsdb_tpu_torch.storage.paged.
    PagedTensorStore` holding matrix ``name``. ``cache``/``cache_scope``
    put the staged A blocks in the block-granular device cache under the
    mesh label; ``stats_out`` receives the per-participant staged bytes
    and the round and broadcast counts. Returns the product (f32) on the
    first participant's device."""
    from netsdb_tpu_torch.plan import staging

    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if n < 2:
        raise ValueError("SUMMA needs >= 2 mesh participants; "
                         "use matmul_streamed on one device")
    rhs, squeeze = _as_rhs(rhs)
    (rows, k), (rb, _), _dtype = store.meta(name)
    if rhs.shape[0] != k:
        raise ValueError(f"matmul contraction mismatch: {name} is "
                         f"{rows}x{k}, rhs {tuple(rhs.shape)}")
    cfg = store.config
    depth = cfg.stage_depth if stage_depth is None else stage_depth
    bucket = staging.pad_rows_target(rb, cfg.shape_bucketing,
                                     density=cfg.bucket_density)
    full_f32_precision()
    staged: Dict[int, int] = {}
    kp = -(-k // n)
    k_pad = kp * n
    if k_pad > k:
        rhs = torch.cat([rhs, rhs.new_zeros((k_pad - k, rhs.shape[1]))])
    panels = []
    for d in range(n):
        panel = rhs[d * kp:(d + 1) * kp].contiguous()
        panels.append(move(panel, devices[d]))
        staged[d] = staged.get(d, 0) + panel.numel() * 4
    ranges = store.block_ranges(name)
    start_to_idx = {s: i for i, (s, _e) in enumerate(ranges)}
    ups = _uploaders(devices, depth)

    def place(item):
        """One host block padded to (bucket, k_pad) and uploaded to its
        owner only — the per-participant upload leg."""
        s0, block = item
        i = start_to_idx[s0]
        d = i % n
        block = _pad_block(block, k_pad)
        placed = ups[devices[d]].upload(block, rows=bucket)
        staged[d] = staged.get(d, 0) + bucket * k_pad * block.itemsize
        return i, int(item[1].shape[0]), placed

    partial = _partial_plan(store, name, cache, cache_scope, bucket,
                            mesh_label(axis, devices))
    dev0 = devices[0]
    cols = rhs.shape[1]
    out = torch.zeros((rows, cols), dtype=torch.float32, device=dev0)
    panel_bytes = int(panels[0].numel() * 4)
    counts = {"rounds": 0, "bcasts": 0, "compute_s": 0.0}

    def run_round(batch):
        t0 = time.perf_counter()
        for i, nv, a in batch:
            dev = devices[i % n]
            if len(ups) > 1:
                staging.hand_over(a, ups[dev])
            acc = torch.zeros((a.shape[0], cols), dtype=torch.float32,
                              device=dev)
            for s in range(n):  # the broadcast of panel s, then its step
                acc += _dot(a[:, s * kp:(s + 1) * kp], move(panels[s], dev))
            s0 = ranges[i][0]
            out[s0:s0 + nv] = move(acc[:nv], dev0)
        counts["compute_s"] += time.perf_counter() - t0
        counts["rounds"] += 1
        counts["bcasts"] += n
        obs.REGISTRY.counter("summa.rounds").inc()
        obs.REGISTRY.counter("summa.panel_bcasts").inc(n)
        obs.REGISTRY.counter("summa.panel_bytes").inc(n * panel_bytes)
        obs.operators.op_add("summa.rounds")
        obs.operators.op_add("summa.panel_bcasts", n)
        obs.operators.op_add("summa.compute_s",
                             time.perf_counter() - t0)

    with contextlib.closing(_stream(store, name, place, depth,
                                    f"summa:{name}", partial, ups)) as st:
        batch: List[Tuple[int, int, Any]] = []
        for item in st:
            batch.append(item)
            if len(batch) == n:
                run_round(batch)
                batch = []
        if batch:
            run_round(batch)
    total = sum(staged.values())
    obs.REGISTRY.counter("summa.staged_bytes").inc(total)
    if stats_out is not None:
        stats_out.update({
            "participants": n, "rounds": counts["rounds"],
            "panel_bcasts": counts["bcasts"],
            "compute_s": counts["compute_s"],
            "staged_bytes_per_participant": dict(staged),
            "staged_bytes_total": total,
            "operand_bytes": int(rows * k * 4 + k * cols * 4)})
    return out[:, 0] if squeeze else out


def summa_grid_matmul_streamed(store, name: str, rhs,
                               devices: Optional[Sequence] = None,
                               grid: Tuple[int, int] = (2, 2),
                               stage_depth: Optional[int] = None,
                               cache=None,
                               cache_scope: Optional[str] = None,
                               stats_out: Optional[Dict[str, Any]] = None
                               ) -> torch.Tensor:
    """``out = M @ rhs`` over a 2-d ``pr x pc`` processor grid: A's row
    block *i* goes to grid row ``i % pr``, split into ``pc`` column tiles
    (tile *c* on device ``(i % pr, c)``); B tiles over the whole grid
    (device ``(r, c)`` holds contraction rows ``[r·pc·kp, (r+1)·pc·kp)``
    of column slice *c*). Each round runs ``pr*pc`` steps: step *s*
    broadcasts A's kp-slice *s* along the grid row and B's kp-slice *s*
    along the grid column, and every device accumulates its C tile."""
    from netsdb_tpu_torch.plan import staging

    pr, pc = int(grid[0]), int(grid[1])
    devices = list(devices if devices is not None else visible_devices())
    if len(devices) < pr * pc:
        raise ValueError(f"summa grid {pr}x{pc} needs {pr * pc} "
                         f"devices, have {len(devices)}")
    devices = devices[:pr * pc]
    rhs, squeeze = _as_rhs(rhs)
    (rows, k), (rb, _), _dtype = store.meta(name)
    if rhs.shape[0] != k:
        raise ValueError(f"matmul contraction mismatch: {name} is "
                         f"{rows}x{k}, rhs {tuple(rhs.shape)}")
    cfg = store.config
    depth = cfg.stage_depth if stage_depth is None else stage_depth
    bucket = staging.pad_rows_target(rb, cfg.shape_bucketing,
                                     density=cfg.bucket_density)
    full_f32_precision()
    steps = pr * pc
    kp = -(-k // steps)
    k_pad = steps * kp
    apc = pr * kp  # A columns per grid column
    cols = rhs.shape[1]
    cpc = -(-cols // pc)
    cols_pad = cpc * pc
    rhs = torch.nn.functional.pad(rhs, (0, cols_pad - cols, 0, k_pad - k))
    staged: Dict[int, int] = {}
    rows_per = pc * kp
    btiles = {}
    for r in range(pr):
        for c in range(pc):
            tile = rhs[r * rows_per:(r + 1) * rows_per,
                       c * cpc:(c + 1) * cpc].contiguous()
            d = r * pc + c
            btiles[(r, c)] = move(tile, devices[d])
            staged[d] = staged.get(d, 0) + tile.numel() * 4
    ranges = store.block_ranges(name)
    start_to_idx = {s: i for i, (s, _e) in enumerate(ranges)}
    ups = _uploaders(devices, depth)

    def place(item):
        """One host block padded to (bucket, k_pad), split into pc column
        tiles, tile c uploaded to grid device (i % pr, c)."""
        s0, block = item
        i = start_to_idx[s0]
        r = i % pr
        block = _pad_block(block, k_pad)
        tiles = []
        for c in range(pc):
            tile = np.ascontiguousarray(block[:, c * apc:(c + 1) * apc])
            d = r * pc + c
            tiles.append(ups[devices[d]].upload(tile, rows=bucket))
            staged[d] = staged.get(d, 0) + bucket * apc * tile.itemsize
        return i, int(item[1].shape[0]), tuple(tiles)

    partial = _partial_plan(store, name, cache, cache_scope, bucket,
                            grid_label(devices, pr, pc))
    dev0 = devices[0]
    out = torch.zeros((rows, cols), dtype=torch.float32, device=dev0)
    counts = {"rounds": 0, "steps": 0, "compute_s": 0.0}

    def run_round(batch):
        t0 = time.perf_counter()
        for i, nv, tiles in batch:
            r = i % pr
            if len(ups) > 1:
                for c, t in enumerate(tiles):
                    staging.hand_over(t, ups[devices[r * pc + c]])
            row = []
            for c in range(pc):
                dev = devices[r * pc + c]
                acc = torch.zeros((bucket, cpc), dtype=torch.float32,
                                  device=dev)
                for s in range(steps):
                    # A slice s lives on grid column s // pr at offset
                    # (s % pr)*kp; B slice s on grid row s // pc at
                    # offset (s % pc)*kp
                    a_t = tiles[s // pr]
                    a_sl = a_t[:, (s % pr) * kp:(s % pr + 1) * kp]
                    b_sl = btiles[(s // pc, c)][(s % pc) * kp:
                                                (s % pc + 1) * kp]
                    acc += _dot(move(a_sl, dev), move(b_sl, dev))
                row.append(move(acc, dev0))
            s0 = ranges[i][0]
            out[s0:s0 + nv] = torch.cat(row, dim=1)[:nv, :cols]
        counts["compute_s"] += time.perf_counter() - t0
        counts["rounds"] += 1
        counts["steps"] += steps
        obs.REGISTRY.counter("summa.grid_rounds").inc()
        obs.REGISTRY.counter("summa.grid_steps").inc(steps)
        obs.REGISTRY.counter("summa.grid_panel_bcasts").inc(2 * steps)
        obs.operators.op_add("summa.grid_rounds")
        obs.operators.op_add("summa.grid_panel_bcasts", 2 * steps)
        obs.operators.op_add("summa.compute_s",
                             time.perf_counter() - t0)

    with contextlib.closing(_stream(store, name, place, depth,
                                    f"summa2d:{name}", partial, ups)) as st:
        batch: List[Tuple[int, int, Any]] = []
        for item in st:
            batch.append(item)
            if len(batch) == pr:
                run_round(batch)
                batch = []
        if batch:
            run_round(batch)
    total = sum(staged.values())
    obs.REGISTRY.counter("summa.grid_staged_bytes").inc(total)
    if stats_out is not None:
        stats_out.update({
            "participants": pr * pc, "grid": (pr, pc),
            "rounds": counts["rounds"], "steps": counts["steps"],
            "panel_bcasts": 2 * counts["steps"],
            "compute_s": counts["compute_s"],
            "staged_bytes_per_participant": dict(staged),
            "staged_bytes_total": total,
            "operand_bytes": int(rows * k * 4 + k * cols * 4)})
    return out[:, 0] if squeeze else out


def summa_matmul_resident(a: torch.Tensor, b: torch.Tensor,
                          devices: Optional[Sequence] = None,
                          axis: str = "data") -> torch.Tensor:
    """C = A·B for RESIDENT tensors through one SUMMA round — the
    ``ops/matmul.py`` leg of the distributed knob: A's rows split over
    the participants, B into contraction panels, one round of panel
    broadcasts accumulating each participant's C tile. Returns C (f32)
    on the first participant's device, its tiles gathered in position
    order."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    m, k = a.shape
    k2, cols = b.shape
    if k != k2:
        raise ValueError(f"matmul contraction mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    full_f32_precision()
    kp = -(-k // n)
    mp = -(-m // n)
    a = torch.nn.functional.pad(a.float(), (0, kp * n - k, 0, mp * n - m))
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, kp * n - k2))
    panels = [move(b[d * kp:(d + 1) * kp].contiguous(), devices[d])
              for d in range(n)]
    tiles = []
    for d in range(n):
        dev = devices[d]
        a_d = move(a[d * mp:(d + 1) * mp].contiguous(), dev)
        acc = torch.zeros((mp, cols), dtype=torch.float32, device=dev)
        for s in range(n):
            acc += _dot(a_d[:, s * kp:(s + 1) * kp], move(panels[s], dev))
        tiles.append(move(acc, devices[0]))
    obs.REGISTRY.counter("summa.rounds").inc()
    obs.REGISTRY.counter("summa.panel_bcasts").inc(n)
    obs.operators.op_add("summa.rounds")
    obs.operators.op_add("summa.panel_bcasts", n)
    return torch.cat(tiles)[:m, :cols]
