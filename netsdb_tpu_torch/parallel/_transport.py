"""Cross-process exchange for a mesh whose positions several processes
own (``parallel/distributed.py``): the one place tensors and fold states
leave this process.

Every exchange is point to point between the processes that take part,
so a process that owns no position of a group never waits on it:

- :func:`exchange` runs one batch of tensor sends and receives
  (``torch.distributed.batch_isend_irecv``: all posted at once, so a
  ring of sends cannot deadlock);
- :func:`send_state` / :func:`recv_state` move a pytree (a fold's state)
  and :func:`share_states` swaps one between every pair of processes.

Under gloo a card tensor is copied explicitly to pinned host memory
before it is sent, and a received one is copied back to the card: the
staging is this module's own, and :func:`stats` counts its bytes. Under
nccl card tensors go direct. A peer that died or timed out surfaces as
:class:`PeerLost` within the group's timeout, never as a hang.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_mu = threading.Lock()
_stats = {"staged_bytes": 0, "sent_bytes": 0, "messages": 0,
          "exchanges": 0, "exchange_s": 0.0}


class PeerLost(RuntimeError):
    """A cross-process exchange failed: a peer process died, closed its
    connection or missed the group's timeout."""


def stats() -> Dict[str, Any]:
    """Bytes staged through host memory (each copy card → host and host →
    card), bytes sent, messages sent, and the tensor exchanges with the
    host seconds they took (staging included), since
    :func:`reset_stats`."""
    with _mu:
        return dict(_stats)


def reset_stats() -> None:
    with _mu:
        for k in _stats:
            _stats[k] = 0


def _count(**kw: int) -> None:
    with _mu:
        for k, v in kw.items():
            _stats[k] += v


def _dist():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise PeerLost("no cluster is joined: a position is owned by "
                       "another process, but this process has no process "
                       "group (parallel.distributed.initialize_cluster)")
    return dist


def _staging() -> bool:
    """Card tensors go through host memory (gloo moves host buffers)."""
    return _dist().get_backend() == "gloo"


def _outgoing(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.is_cuda and _staging():
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        _count(staged_bytes=t.numel() * t.element_size())
        return host
    return t


def _buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and _staging():
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def _land(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    if buf.device == device:
        return buf
    _count(staged_bytes=buf.numel() * buf.element_size())
    with torch.cuda.device(device):
        return buf.to(device)


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype,
                                   torch.device, int]]
             ) -> List[torch.Tensor]:
    """Send each ``(tensor, dst_rank)`` and receive each ``(shape, dtype,
    device, src_rank)`` in one batch; returns the received tensors on
    their devices. Between two processes, tensors are matched in the order
    each side lists them."""
    dist = _dist()
    t0 = time.perf_counter()
    outgoing = [(_outgoing(t), dst) for t, dst in sends]
    bufs = [(_buffer(shape, dtype, dev), dev, src)
            for shape, dtype, dev, src in recvs]
    ops = ([dist.P2POp(dist.isend, t, dst) for t, dst in outgoing]
           + [dist.P2POp(dist.irecv, b, src) for b, _dev, src in bufs])
    if not ops:
        return []
    try:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    except RuntimeError as e:  # gloo's and nccl's errors of a lost peer
        raise PeerLost(f"cross-process exchange failed: {e}") from e
    got = [_land(b, dev) for b, dev, _src in bufs]
    _count(sent_bytes=sum(t.numel() * t.element_size()
                          for t, _ in outgoing), messages=len(outgoing),
           exchanges=1, exchange_s=time.perf_counter() - t0)
    return got


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            _count(staged_bytes=x.numel() * x.element_size())
        return x.detach().cpu()
    return _tree(x, _to_host)


def _to_device(x: Any, device: torch.device) -> Any:
    if isinstance(x, torch.Tensor):
        if device.type == "cuda":
            _count(staged_bytes=x.numel() * x.element_size())
        return x.to(device)
    return _tree(x, lambda v: _to_device(v, device))


def _tree(x: Any, fn) -> Any:
    from netsdb_tpu_torch.relational.table import ColumnTable

    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    if isinstance(x, ColumnTable):
        return ColumnTable({k: fn(v) for k, v in x.cols.items()}, x.dicts,
                           None if x.valid is None else fn(x.valid))
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(fn(v) for v in x)
    return x


def send_state(state: Any, dst: int) -> None:
    """Send a pytree of tensors (a fold's state) to process ``dst``: its
    tensors through host memory."""
    dist = _dist()
    host = _to_host(state)
    try:
        dist.send_object_list([host], dst=dst)
    except RuntimeError as e:
        raise PeerLost(f"sending a state to process {dst} failed: "
                       f"{e}") from e
    _count(messages=1)


def recv_state(src: int, device: torch.device) -> Any:
    """The pytree process ``src`` sent with :func:`send_state`, its
    tensors on ``device``."""
    dist = _dist()
    box: List[Any] = [None]
    try:
        dist.recv_object_list(box, src=src)
    except RuntimeError as e:
        raise PeerLost(f"receiving a state from process {src} failed: "
                       f"{e}") from e
    return _to_device(box[0], device)


def share_states(state: Any, peers: Sequence[int], rank: int,
                 device: torch.device) -> Dict[int, Any]:
    """Swap ``state`` with every process in ``peers`` (this one's rank
    left out); returns each peer's state on ``device``. Pairs swap in
    rank order, the lower rank sending first, so no pair waits on
    another."""
    got: Dict[int, Any] = {}
    for q in sorted(set(peers) - {rank}):
        if rank < q:
            send_state(state, q)
            got[q] = recv_state(q, device)
        else:
            got[q] = recv_state(q, device)
            send_state(state, q)
    return got


def thread_state(state: Any, owners: Sequence[int], rank: int,
                 device: torch.device, step_at) -> Any:
    """Thread ``state`` through positions ``0..n-1`` in order, position
    ``i`` owned by process ``owners[i]``: this process runs
    ``state = step_at(state, i)`` at its own positions, the state passes
    to the next owner where the owner changes, and the last owner sends
    the final state to every other owner. Every owner returns the same
    state, with the bits one process would give over the same
    positions."""
    participants = sorted(set(owners))
    if rank not in participants:
        raise PeerLost(f"process {rank} owns none of the positions "
                       f"{list(owners)} a state is threaded through")
    prev: Optional[int] = None
    for i, owner in enumerate(owners):
        if prev is not None and owner != prev:
            if rank == prev:
                send_state(state, owner)
            elif rank == owner:
                state = recv_state(prev, device)
        if owner == rank:
            state = step_at(state, i)
        prev = owner
    last = owners[-1]
    if rank == last:
        for q in participants:
            if q != rank:
                send_state(state, q)
        return state
    return recv_state(last, device)
