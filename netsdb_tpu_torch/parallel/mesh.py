"""Device mesh and sharded values — counterpart of
``netsdb_tpu/parallel/mesh.py``.

A :class:`Mesh` names the axes of an array of device positions. One
process drives every position, as JAX's ``shard_map`` does: a
:class:`ShardedTensor` (the counterpart of a ``jax.Array`` under a
``NamedSharding``) holds one tensor per position, and code that runs
"per device" loops over the positions, each launching on its own
position's device. The collectives over an axis are explicit functions
of the positions' tensors (:func:`position_sum`, :func:`position_gather`,
:func:`position_scatter`, :func:`position_all_to_all`): a reduction sums
the partials in position order, a gather concatenates them, an
all-to-all is a split and a concatenation. Positions on one device
exchange tensors without a copy; positions on different cards copy with
``Tensor.to``. Processes joined over NCCL are not ported yet
(``parallel/distributed.py`` ports the single-process half; ROADMAP.md
A4 part 3).

An op over placed operands follows one rule (``parallel/placed_ops.py``):
per position where the layouts allow it, else a gather onto the first
position. Every such gather goes through :func:`gather_placed`, which
logs it with the op and its reason (:func:`gather_log`) and counts it in
``mesh.fallbacks``; :meth:`ShardedTensor.to_dense` is the caller's own,
explicit gather (reading a result) and is not logged.

Device positions default to the visible cards ``cuda:0..n-1`` (or the
one CPU for CPU tensors). :func:`virtual_devices` makes ``n`` positions
that share one physical device (the first card unless the caller names
another) — the port's counterpart of the reference tests' 8 virtual CPU
devices (``--xla_force_host_platform_device_count=8``). It is turned on
only by an explicit ``with virtual_devices(n, device):`` and is never
the default.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor

Index = Tuple[int, ...]

_virtual: Optional[Tuple[torch.device, ...]] = None
_default_mesh: Optional["Mesh"] = None


class Mesh:
    """Axis names over an array of ``torch.device`` positions. The same
    device may sit at several positions (virtual positions)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices of shape {self.devices.shape} "
                             f"do not match axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[Index]:
        """Every position index, in row-major mesh order."""
        return np.ndindex(self.devices.shape)

    def axis_groups(self, axis: str) -> List[List[Index]]:
        """The positions grouped along ``axis``: one list per index of
        the other axes, ordered by the position on ``axis`` (a ring)."""
        ax = self.axis_names.index(axis)
        rest = self.devices.shape[:ax] + self.devices.shape[ax + 1:]
        return [[other[:ax] + (i,) + other[ax:]
                 for i in range(self.devices.shape[ax])]
                for other in np.ndindex(rest)]

    def __repr__(self) -> str:
        devs = ",".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, devices=[{devs}])"


def visible_devices(device_type: Optional[str] = None
                    ) -> Tuple[torch.device, ...]:
    """The device positions a mesh is built over: the virtual positions
    while :func:`virtual_devices` is active (for ``device_type``, or for
    any type when none is given), else every visible card for
    ``"cuda"`` (the default; raises without a card) or the one CPU for
    ``"cpu"``."""
    if _virtual is not None and device_type in (None, _virtual[0].type):
        return _virtual
    device_type = device_type or "cuda"
    if device_type == "cpu":
        return (torch.device("cpu"),)
    if device_type != "cuda":
        raise ValueError(f"no device positions for {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; ask for the 'cpu' "
                           "positions explicitly")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


@contextlib.contextmanager
def virtual_devices(n: int, device="cuda"
                    ) -> Iterator[Tuple[torch.device, ...]]:
    """Within the block, ``n`` mesh positions share the one physical
    ``device`` (the first card unless the caller asks for another, or
    for the CPU): placements, meshes and the default mesh resolve over
    them, so a sharded path runs all its positions on one card. The
    previous positions and default mesh come back on exit. A CUDA device
    without a visible card raises, as :func:`visible_devices` does."""
    global _virtual, _default_mesh
    if n < 1:
        raise ValueError(f"need at least one position, got {n}")
    dev = torch.device(device)
    if dev.type == "cuda":
        visible_devices("cuda")  # raises without a card
        if dev.index is None:
            dev = torch.device("cuda", 0)
    saved = (_virtual, _default_mesh)
    _virtual, _default_mesh = (dev,) * n, None
    try:
        yield _virtual
    finally:
        _virtual, _default_mesh = saved


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data", "model"),
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh over ``devices`` (default: the visible positions). Default
    shape: every position on the first axis, 1 on the others."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def default_mesh() -> Mesh:
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


# --- counted gathers of placed tensors -----------------------------------

_gather_mu = threading.Lock()
_gathers: "collections.OrderedDict[Tuple[str, str], Dict[str, Any]]" = \
    collections.OrderedDict()
_GATHER_LOG_CAP = 256


def gather_placed(x: "ShardedTensor", op: str, reason: str) -> torch.Tensor:
    """``x`` gathered onto its first position's device because ``op``
    cannot run per position (``reason`` names the layouts): logged and
    counted (``mesh.fallbacks``), never silent."""
    from netsdb_tpu_torch import obs

    key = (op, reason)
    with _gather_mu:
        ent = _gathers.get(key)
        if ent is None:
            ent = _gathers[key] = {"op": op, "reason": reason, "gathers": 0,
                                   "bytes": 0}
            while len(_gathers) > _GATHER_LOG_CAP:
                _gathers.popitem(last=False)
        ent["gathers"] += 1
        ent["bytes"] += math.prod(x.shape) * x.dtype.itemsize
    obs.REGISTRY.counter("mesh.fallbacks").inc()
    return x.to_dense()


def gather_log() -> List[Dict[str, Any]]:
    """Every op that gathered placed tensors onto one position: the op,
    the reason (the operands' layouts), the operands it gathered and
    their logical bytes."""
    with _gather_mu:
        return [dict(v) for v in _gathers.values()]


def clear_gather_log() -> None:
    with _gather_mu:
        _gathers.clear()


# --- collectives over the positions of one axis group -------------------

def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: the same tensor when it is there already, else
    a copy issued on the destination's current stream (the counterpart of
    one ICI transfer)."""
    if t.device == device:
        return t
    if device.type == "cuda":
        with torch.cuda.device(device):
            return t.to(device, non_blocking=True)
    return t.to(device)


def position_sum(parts: Sequence[torch.Tensor],
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The sum of the positions' partials on ``device`` (default: the
    first position's), added in position order — ``((p0 + p1) + p2) +
    ...`` — so two runs give the same bits whatever the devices."""
    device = device if device is not None else parts[0].device
    out = move(parts[0], device).clone()
    for p in parts[1:]:
        out += move(p, device)
    return out


def position_gather(parts: Sequence[torch.Tensor], dim: int = 0,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """The positions' blocks concatenated along ``dim`` in position order
    on ``device`` (default: the first position's)."""
    device = device if device is not None else parts[0].device
    return torch.cat([move(p, device) for p in parts], dim=dim)


def position_scatter(x: torch.Tensor, devices: Sequence[torch.device],
                     dim: int = 0) -> List[torch.Tensor]:
    """``x`` split into ``len(devices)`` equal blocks along ``dim``, block
    ``i`` on ``devices[i]`` (contiguous)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split into {n} parts")
    return [move(b.contiguous(), d)
            for b, d in zip(torch.chunk(x, n, dim=dim), devices)]


def position_all_to_all(parts: Sequence[torch.Tensor], split_dim: int,
                        concat_dim: int) -> List[torch.Tensor]:
    """The tiled all-to-all of one axis group: position ``i`` splits its
    block into ``n`` along ``split_dim`` and sends piece ``j`` to position
    ``j``, which concatenates the pieces it receives along
    ``concat_dim`` in position order."""
    n = len(parts)
    pieces = [torch.chunk(p, n, dim=split_dim) for p in parts]
    if any(p.shape[split_dim] % n for p in parts):
        raise ValueError(f"dimension {split_dim} does not split into {n} "
                         f"parts")
    return [torch.cat([move(pieces[i][j], parts[j].device)
                       for i in range(n)], dim=concat_dim).contiguous()
            for j in range(n)]


def group_shards(x: "ShardedTensor", group: Sequence[Index]
                 ) -> List[torch.Tensor]:
    """The tensors of ``x`` at the positions of one axis group."""
    return [x.shards[p] for p in group]


# Equal axes over equal devices give the SAME Mesh object.
_mesh_cache: Dict[Tuple, Mesh] = {}
_mesh_lock = threading.Lock()


def cached_mesh(axes: Tuple[Tuple[str, int], ...],
                devices: Sequence[torch.device]) -> Mesh:
    """The mesh of resolved ``axes`` over the first positions of
    ``devices``."""
    need = math.prod(s for _, s in axes)
    if need > len(devices):
        raise ValueError(f"placement axes {axes} need {need} devices, "
                         f"have {len(devices)}")
    key = (tuple(axes), tuple(devices[:need]))
    with _mesh_lock:
        mesh = _mesh_cache.get(key)
        if mesh is None:
            mesh = make_mesh(tuple(s for _, s in axes),
                             tuple(n for n, _ in axes), devices[:need])
            _mesh_cache[key] = mesh
        return mesh


def _axes_of(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def normalize_spec(spec: Sequence[Any], ndim: int) -> Tuple[Any, ...]:
    """One entry per dimension: trailing dimensions a shorter spec does
    not name are replicated."""
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"tensor's {ndim} dimensions")
    return spec + (None,) * (ndim - len(spec))


class ShardedTensor:
    """A logical tensor split over a mesh: the counterpart of a
    ``jax.Array`` under a ``NamedSharding``.

    ``shards`` is an object array shaped like the mesh; the tensor at
    each position lies on that position's device and holds the block of
    the logical tensor that ``spec`` gives the position (a dimension
    split over axes (a1, a2, ...) takes its part index from the
    positions on those axes, a1 major). Positions on one device that
    hold the same block share one tensor, so a replicated value keeps
    one copy per distinct physical device. Shards are read-only by
    convention: nothing in the port writes into them."""

    def __init__(self, shards: np.ndarray, mesh: Mesh, spec: Sequence[Any],
                 shape: Sequence[int]):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = normalize_spec(spec, len(self.shape))
        if shards.shape != mesh.devices.shape:
            raise ValueError(f"shards {shards.shape} do not match mesh "
                             f"{mesh.devices.shape}")
        local = self.local_shape
        for idx in mesh.positions():
            t = shards[idx]
            if tuple(t.shape) != local or t.device != mesh.devices[idx]:
                raise ValueError(
                    f"shard at {idx} is {tuple(t.shape)} on {t.device}; "
                    f"expected {local} on {mesh.devices[idx]}")
        self.shards = shards

    # --- construction -------------------------------------------------
    @staticmethod
    def from_dense(x: torch.Tensor, mesh: Mesh,
                   spec: Sequence[Any]) -> "ShardedTensor":
        """Split ``x`` over ``mesh`` by ``spec``; every sharded dimension
        must divide evenly (as ``jax.device_put`` requires)."""
        spec = normalize_spec(spec, x.dim())
        for dim, entry in enumerate(spec):
            parts = math.prod(mesh.shape[a] for a in _axes_of(entry))
            if x.shape[dim] % parts:
                raise ValueError(
                    f"dimension {dim} of size {x.shape[dim]} does not "
                    f"split into {parts} parts over {entry!r}")
        out = ShardedTensor.__new__(ShardedTensor)
        out.mesh, out.spec, out.shape = mesh, spec, tuple(x.shape)
        shards = np.empty(mesh.devices.shape, dtype=object)
        made: Dict[Tuple, torch.Tensor] = {}
        for idx in mesh.positions():
            dev = mesh.devices[idx]
            region = out.region(idx)
            key = (dev, tuple((s.start, s.stop) for s in region))
            if key not in made:
                part = x[region]
                if part.device == dev:
                    part = part if part.shape == x.shape else part.contiguous()
                else:
                    part = part.to(dev, memory_format=torch.contiguous_format)
                made[key] = part
            shards[idx] = made[key]
        out.shards = shards
        return out

    # --- layout -------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.first().dtype

    @property
    def device(self) -> torch.device:
        """The first position's device (where :meth:`to_dense` gathers)."""
        return self.mesh.devices.flat[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_replicated(self) -> bool:
        return all(e is None for e in self.spec)

    def parts(self, dim: int) -> int:
        return math.prod(self.mesh.shape[a] for a in _axes_of(self.spec[dim]))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(s // self.parts(d) for d, s in enumerate(self.shape))

    def region(self, idx: Index) -> Tuple[slice, ...]:
        """The block of the logical tensor held at position ``idx``."""
        return region_of(self.mesh, self.spec, self.shape, idx)

    def first(self) -> torch.Tensor:
        return self.shards.flat[0]

    def distinct_positions(self) -> List[Index]:
        """One position per distinct block of the logical tensor, in the
        order of the blocks' starts (row-major): positions that hold a
        replica of a block already listed are left out."""
        first: Dict[Tuple[int, ...], Index] = {}
        for idx in self.mesh.positions():
            first.setdefault(tuple(s.start for s in self.region(idx)), idx)
        return [first[k] for k in sorted(first)]

    def __getitem__(self, region: Tuple[slice, ...]) -> Any:
        """A block of leading slices. Cutting replicated dimensions
        keeps the value sharded (each shard is cut, shared shards stay
        shared); cutting a sharded dimension gathers first."""
        region = tuple(region) + (slice(None),) * (self.ndim - len(region))
        spans = [range(s)[sl] for s, sl in zip(self.shape, region)]
        if any(sp.step != 1 for sp in spans) or any(
                e is not None and len(sp) != s
                for e, sp, s in zip(self.spec, spans, self.shape)):
            return gather_placed(self, "slice", f"{region} cuts a sharded "
                                 f"dimension of {self.layout()}")[region]
        cut: Dict[int, torch.Tensor] = {}
        shards = np.empty(self.shards.shape, dtype=object)
        for idx in self.mesh.positions():
            t = self.shards[idx]
            if id(t) not in cut:
                cut[id(t)] = t[tuple(
                    slice(sp.start, sp.stop) if e is None else slice(None)
                    for e, sp in zip(self.spec, spans))]
            shards[idx] = cut[id(t)]
        return ShardedTensor(shards, self.mesh, self.spec,
                             [len(sp) for sp in spans])

    def t(self) -> "ShardedTensor":
        """The transpose of a 2-d value: each shard's transposed view,
        the spec's entries swapped (no data moves)."""
        if self.ndim != 2:
            raise ValueError(f"t() of a {self.ndim}-d sharded value")
        views: Dict[int, torch.Tensor] = {}
        shards = np.empty(self.shards.shape, dtype=object)
        for idx in self.mesh.positions():
            t = self.shards[idx]
            shards[idx] = views.setdefault(id(t), t.t())
        return ShardedTensor(shards, self.mesh, self.spec[::-1],
                             self.shape[::-1])

    def layout(self) -> str:
        """The spec over the mesh's axes, e.g. ``P(data,None)@{data: 4}``
        (the reason a gather names)."""
        sp = ",".join("None" if e is None else "+".join(_axes_of(e))
                      for e in self.spec)
        return f"P({sp})@{self.mesh.shape}"

    def to_dense(self) -> torch.Tensor:
        """The logical tensor, gathered onto the first position's device:
        the caller's explicit read, not logged (an op that gathers calls
        :func:`gather_placed`). A value held whole at each position
        returns its first shard without a copy."""
        if all(self.parts(d) == 1 for d in range(self.ndim)):
            return self.first()
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for idx in self.distinct_positions():
            out[self.region(idx)].copy_(self.shards[idx])
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"mesh={self.mesh.shape}, dtype={self.dtype})")


def region_of(mesh: Mesh, spec: Sequence[Any], shape: Sequence[int],
              idx: Index) -> Tuple[slice, ...]:
    """The block of a logical tensor of ``shape`` laid out by ``spec``
    over ``mesh`` that position ``idx`` holds (a dimension split over
    axes (a1, a2, ...) takes its part index from the positions on those
    axes, a1 major)."""
    pos = dict(zip(mesh.axis_names, idx))
    out = []
    for dim, entry in enumerate(spec):
        part, parts = 0, 1
        for a in _axes_of(entry):
            part = part * mesh.shape[a] + pos[a]
            parts *= mesh.shape[a]
        size = shape[dim] // parts
        out.append(slice(part * size, (part + 1) * size))
    return tuple(out)


def as_sharded(x: Any, mesh: Mesh, spec: Sequence[Any]) -> ShardedTensor:
    """``x`` laid out over ``mesh`` by ``spec``: a sharded value already so
    laid out is returned as it is; any other is gathered and split."""
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and x.spec == normalize_spec(spec, x.ndim):
            return x
        x = x.to_dense()
    return ShardedTensor.from_dense(x, mesh, spec)


def _divisible_spec(t: BlockedTensor, mesh: Mesh,
                    spec: Sequence[Any]) -> Tuple[Any, ...]:
    """Drop sharding on dims the padded shape can't divide evenly (the
    reference dispatcher's DEFAULT-policy fallback)."""
    fixed = []
    for dim, axis in enumerate(normalize_spec(spec, t.meta.rank)):
        size = math.prod(mesh.shape[a] for a in _axes_of(axis))
        fixed.append(axis if t.meta.padded_shape[dim] % size == 0 else None)
    return tuple(fixed)


def shard_blocked(t: BlockedTensor, mesh: Optional[Mesh] = None,
                  spec: Optional[Sequence[Any]] = None) -> BlockedTensor:
    """Place a blocked tensor's padded data on the mesh. Shards are cut
    from the padded tensor, so the zero margin stays zero in each."""
    mesh = mesh or default_mesh()
    spec = spec if spec is not None else (None,) * t.meta.rank
    return t.with_data(as_sharded(t.data, mesh, _divisible_spec(t, mesh,
                                                                spec)))


def replicate(t: BlockedTensor, mesh: Optional[Mesh] = None) -> BlockedTensor:
    """A whole copy at every position (one per physical device)."""
    return shard_blocked(t, mesh, (None,) * t.meta.rank)
