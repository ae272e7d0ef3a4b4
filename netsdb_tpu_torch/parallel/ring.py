"""Sequence parallelism: ring attention and Ulysses — counterpart of
``netsdb_tpu/parallel/ring.py``.

q/k/v are sharded on the sequence axis over a mesh axis; k/v chunks
rotate around the ring of positions while each position folds every
arriving chunk into its queries' online-softmax carry. At step ``i``
position ``p`` holds the chunk that originated at ``(p - i) % n``, so
its own (diagonal) chunk comes first; causal masking uses the global
offsets ``p * s_local`` and ``src * s_local``. Ulysses
(:func:`ulysses_attention`) instead re-shards sequence → heads with one
all-to-all per operand, runs full attention per head group, and
re-shards back.

A process drives the positions it owns (see :mod:`netsdb_tpu_torch.
parallel.mesh`). The rotation is the counterpart of ``ppermute``:
positions that share a device pass the tensor on with no copy, positions
on different cards copy it with ``Tensor.to(dst, non_blocking=True)`` on
the destination's current stream, and a chunk bound for a position of
another process goes through ``parallel/_transport.py`` in one batch of
sends and receives a step (every send and receive posted together, so
the ring cannot deadlock). Each position's fold launches on its own
device's current stream; a process folds only its own positions, and
its remote entries stay None.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from netsdb_tpu_torch.ops.attention import (NEG_INF, _block_attn,
                                            attention_dispatch)
from netsdb_tpu_torch.ops.cuda_kernels import flash_attention_step
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, as_sharded,
                                            group_shards,
                                            position_all_to_all)

Chunks = List[Optional[torch.Tensor]]


def _rotate(chunks: Chunks, owners: Optional[Sequence[int]] = None,
            rank: int = 0) -> Chunks:
    """Pass every position's chunk to the next position of the ring:
    the result's entry ``j`` is the chunk that sat at ``j - 1``. Entry
    ``j`` of another process (``owners[j] != rank``; default: every
    position this process's) is None; a chunk crossing to or from
    another process goes through the transport."""
    n = len(chunks)
    owners = [rank] * n if owners is None else owners
    out: Chunks = [None] * n
    sends, recvs, into = [], [], []
    for j in range(n):
        i = (j - 1) % n
        if owners[j] == rank and owners[i] == rank:
            t, dst = chunks[i], chunks[j].device
            if t.device != dst:
                with torch.cuda.device(dst):
                    t = t.to(dst, non_blocking=True)
            out[j] = t
        elif owners[i] == rank:
            sends.append((chunks[i], owners[j]))
        elif owners[j] == rank:
            like = chunks[j]
            recvs.append((tuple(like.shape), like.dtype, like.device,
                          owners[i]))
            into.append(j)
    if sends or recvs:
        from netsdb_tpu_torch.parallel import _transport

        for j, t in zip(into, _transport.exchange(sends, recvs)):
            out[j] = t
    return out


def _ring_attention_local(qs: Chunks, ks: Chunks, vs: Chunks, causal: bool,
                          scale: float, owners: Sequence[int],
                          rank: int) -> Chunks:
    """The naive ring fold (``_block_attn`` on every arriving chunk), the
    CPU default: q pre-multiplied by the scale, natural ``exp``."""
    n = len(qs)
    mine = [p for p in range(n) if owners[p] == rank]
    s_local = qs[mine[0]].shape[2]
    qs = [None if q is None else q * scale for q in qs]
    nums = [None if q is None else torch.zeros_like(q) for q in qs]
    dens = [None if q is None else torch.zeros_like(q[..., :1]) for q in qs]
    maxs = [None if q is None else torch.full_like(q[..., :1], NEG_INF)
            for q in qs]
    for i in range(n):
        for p in mine:
            dev = qs[p].device
            src = (p - i) % n
            if causal:
                q_pos = p * s_local + torch.arange(s_local, device=dev)
                k_pos = src * s_local + torch.arange(s_local, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
            else:
                mask = torch.ones((s_local, s_local), dtype=torch.bool,
                                  device=dev)
            nums[p], dens[p], maxs[p] = _block_attn(
                qs[p], ks[p], vs[p], nums[p], dens[p], maxs[p], mask)
        if i < n - 1:
            ks, vs = _rotate(ks, owners, rank), _rotate(vs, owners, rank)
    return [None if num is None else num / den.clamp_min(1e-30)
            for num, den in zip(nums, dens)]


def _ring_attention_flash_local(qs: Chunks, ks: Chunks, vs: Chunks,
                                causal: bool, scale: float,
                                owners: Sequence[int], rank: int) -> Chunks:
    """The ring folded by ``flash_attention_step`` (B2): each position
    keeps its own f32 carry (acc, l, m), which the step updates in
    place; q, k and v chunks are only read, so positions that share a
    device may share them."""
    n = len(qs)
    mine = [p for p in range(n) if owners[p] == rank]
    b, h, s_local, d = qs[mine[0]].shape
    bh = b * h

    def flat(t):
        return None if t is None else t.reshape(bh, s_local, d).contiguous()

    qf = [flat(q) for q in qs]
    ks, vs = [flat(k) for k in ks], [flat(v) for v in vs]
    accs = [None if q is None else
            torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in qf]
    ls = [None if q is None else
          torch.zeros((bh, s_local, 1), dtype=torch.float32,
                      device=q.device) for q in qf]
    ms = [None if q is None else
          torch.full((bh, s_local, 1), NEG_INF, dtype=torch.float32,
                     device=q.device) for q in qf]
    for i in range(n):
        for p in mine:
            src = (p - i) % n
            flash_attention_step(qf[p], ks[p], vs[p], accs[p], ls[p], ms[p],
                                 q_offset=p * s_local,
                                 k_offset=src * s_local, causal=causal,
                                 scale=scale)
        if i < n - 1:
            ks, vs = _rotate(ks, owners, rank), _rotate(vs, owners, rank)
    return [None if acc is None else
            (acc / l.clamp_min(1e-30)).to(q.dtype).reshape(b, h, s_local, d)
            for acc, l, q in zip(accs, ls, qs)]


def auto_impl(device: torch.device) -> str:
    """The fold ``ring_attention`` picks when none is asked for: CUDA
    tensors always take 'flash', the B2 kernel, which raises on operands
    or a card it cannot take; CPU tensors take 'naive', as the reference
    does off its TPU."""
    return "flash" if device.type == "cuda" else "naive"


def ring_attention(q, k, v, mesh: Mesh, axis: str = "data",
                   causal: bool = True, scale: Optional[float] = None,
                   impl: Optional[str] = None) -> ShardedTensor:
    """q/k/v (B, H, S, D), sequence-sharded over ``axis`` (a dense
    tensor is sharded first); returns the exact attention output with
    the same sharding. ``impl``: None picks with :func:`auto_impl`;
    'flash' or 'naive' force a fold. Positions that differ on the other
    mesh axes hold replicas and each run their own ring; a ring whose
    positions several processes own runs in each of them (SPMD), each
    folding its own positions."""
    q, k, v = (as_sharded(t, mesh, (None, None, axis, None))
               for t in (q, k, v))
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if impl is None:
        impl = auto_impl(q.device)
    bodies = {"flash": _ring_attention_flash_local,
              "naive": _ring_attention_local}
    if impl not in bodies:
        raise ValueError(f"unknown ring attention impl {impl!r}")
    body = bodies[impl]
    out = np.empty(mesh.devices.shape, dtype=object)
    for ring in mesh.axis_groups(axis):
        owners = [int(mesh.owners[p]) for p in ring]
        if mesh.rank not in owners:
            continue
        outs = body([q.shards[p] for p in ring], [k.shards[p] for p in ring],
                    [v.shards[p] for p in ring], causal, scale, owners,
                    mesh.rank)
        for p, o in zip(ring, outs):
            out[p] = o
    return ShardedTensor(out, mesh, q.spec, q.shape)


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = "data",
                      causal: bool = True,
                      scale: Optional[float] = None) -> ShardedTensor:
    """Ulysses sequence parallelism: q/k/v (B, H, S, D) sequence-sharded
    over ``axis`` (a dense tensor is sharded first) go through one
    all-to-all each to head-sharded (B, H/n, S, D), every position runs
    full attention over the whole sequence for its heads through
    ``attention_dispatch`` (the flash kernel, B1, on a CUDA tensor; the
    plain attention on the CPU), and one all-to-all takes the output back
    to sequence-sharded. The heads must divide the axis size."""
    n = mesh.shape[axis]
    if q.shape[1] % n != 0:
        raise ValueError(f"heads {q.shape[1]} not divisible by mesh axis "
                         f"{axis}={n}")
    q, k, v = (as_sharded(t, mesh, (None, None, axis, None))
               for t in (q, k, v))
    out = np.empty(mesh.devices.shape, dtype=object)
    for group in mesh.axis_groups(axis):
        owners = [int(mesh.owners[p]) for p in group]
        if mesh.rank not in owners:
            continue
        # seq → heads: split the heads, concatenate the sequence
        qh, kh, vh = (position_all_to_all(group_shards(t, group), 1, 2,
                                          owners)
                      for t in (q, k, v))
        oh = [None if a is None else
              attention_dispatch(a, b, c, causal=causal, scale=scale)
              for a, b, c in zip(qh, kh, vh)]
        # heads → seq: split the sequence, concatenate the heads
        for p, o in zip(group, position_all_to_all(oh, 2, 1, owners)):
            out[p] = o
    return ShardedTensor(out, mesh, q.spec, q.shape)
