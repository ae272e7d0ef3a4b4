"""The cluster layer — counterpart of ``netsdb_tpu/parallel/distributed.py``.

The reference joins per-host processes into one cluster with
``jax.distributed.initialize`` (the role of netsDB's
``startMaster.sh``/``startWorkers.sh``), builds a (hosts, ici...) mesh
over every process's devices and reports the cluster's resources. Here:

- :func:`initialize_cluster` joins this process through
  ``torch.distributed`` with TCP rendezvous at the coordinator. The mesh
  then spans every process's positions (``parallel/mesh.py``: position
  ``i`` of the global list is owned by process ``i // local``), each
  process holds the blocks of its own positions, and the collectives
  over positions of other processes go through
  ``parallel/_transport.py``. Without a coordinator and a process count
  it is a no-op and returns False (one process drives every position).
- :func:`hybrid_mesh` builds the ``("hosts", *ici_axes)`` mesh: host row
  ``h`` is process ``h``'s positions.
- :func:`cluster_info` reports the process, its positions, the global
  position count, the device kind and the backend.

**The backend rule**, decided once at the join from what every process
reports through the rendezvous store, never switched after a failure:
``nccl`` when the processes on each host own distinct cards; ``gloo``
for CPU positions and for processes that share a card (NCCL refuses two
ranks on one device). Under gloo the transport copies card tensors to
pinned host memory itself, and counts the bytes. An explicit ``backend``
that cannot hold raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from netsdb_tpu_torch.parallel import mesh as _mesh
from netsdb_tpu_torch.parallel._transport import PeerLost
from netsdb_tpu_torch.parallel.mesh import (Mesh, Positions, local_devices,
                                            visible_devices)

#: seconds a collective waits on a peer before it raises
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Cluster:
    """This process's membership: its rank of ``size`` processes, the
    backend, its own positions and the coordinator it joined through."""

    rank: int
    size: int
    backend: str
    local: tuple
    coordinator: str
    timeout_s: float


_joined: Optional[Cluster] = None


def _card_id(dev: torch.device) -> str:
    """A card's identity across processes (its UUID where torch has it)."""
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"index{dev.index}"


def choose_backend(reports: Sequence[Dict], requested: Optional[str] = None
                   ) -> str:
    """The backend for processes that report ``{"host", "type", "cards"}``:
    ``nccl`` when every process is on cards and no two processes of a host
    share one, ``gloo`` otherwise. A ``requested`` backend that cannot
    hold raises ``ValueError``; gloo always holds."""
    on_cards = all(r["type"] == "cuda" for r in reports)
    seen: Dict[tuple, int] = {}
    shared = []
    for rank, r in enumerate(reports):
        for card in set(r.get("cards", ())):
            key = (r["host"], card)
            if key in seen:
                shared.append((seen[key], rank, card))
            seen[key] = rank
    nccl_ok = on_cards and not shared
    if requested is None:
        return "nccl" if nccl_ok else "gloo"
    if requested == "gloo":
        return "gloo"
    if requested == "nccl" and not nccl_ok:
        why = ("processes share a card: " + ", ".join(
            f"ranks {a} and {b} on {c}" for a, b, c in shared)
            if on_cards else "some positions are not on cards")
        raise ValueError(f"backend 'nccl' cannot hold: {why} (NCCL "
                         f"refuses two ranks on one device; use gloo)")
    if requested != "nccl":
        raise ValueError(f"unknown backend {requested!r}")
    return "nccl"


def _split(address: str) -> tuple:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not "
                         f"host:port")
    return host, int(port)


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       device="cuda", backend: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process into a cluster of ``num_processes`` as
    ``process_id``, with TCP rendezvous at ``coordinator_address``
    (``host:port``; process 0 listens there). Arguments fall back to
    ``NETSDB_TPU_COORDINATOR``, ``NETSDB_TPU_NUM_PROCESSES`` and
    ``NETSDB_TPU_PROCESS_ID``. Without a coordinator and a process count
    it is a no-op and returns False. This process's positions are the
    positions of ``device``'s type visible now (its virtual positions
    too): every process must bring as many. ``timeout_s`` bounds every
    wait on a peer (a dead peer raises :class:`PeerLost`); the backend
    follows the module's rule. Returns True once joined."""
    global _joined
    coordinator_address = coordinator_address or os.environ.get(
        "NETSDB_TPU_COORDINATOR")
    if coordinator_address is None and num_processes is None:
        return False
    if _joined is not None:
        raise RuntimeError(f"this process already joined a cluster "
                           f"({_joined})")
    if coordinator_address is None:
        raise ValueError("num_processes without a coordinator address: pass "
                         "coordinator_address or set NETSDB_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("NETSDB_TPU_NUM_PROCESSES", 0))
    if process_id is None:
        process_id = int(os.environ.get("NETSDB_TPU_PROCESS_ID", -1))
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}: need "
                         f"0 <= process_id < num_processes")
    import torch.distributed as dist

    dev = torch.device(device)
    local = tuple(local_devices(dev.type))
    host, port = _split(coordinator_address)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, num_processes,
                          is_master=process_id == 0, timeout=timeout)
    mine = {"host": socket.gethostname(), "type": dev.type,
            "positions": len(local),
            "cards": sorted({_card_id(d) for d in local})
            if dev.type == "cuda" else []}
    store.set(f"netsdb/report/{process_id}", json.dumps(mine))
    reports = [json.loads(store.get(f"netsdb/report/{r}"))
               for r in range(num_processes)]
    counts = {r["positions"] for r in reports}
    if len(counts) != 1:
        raise ValueError(f"every process must bring as many positions: "
                         f"{[r['positions'] for r in reports]}")
    chosen = choose_backend(reports, backend)
    dist.init_process_group(chosen, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    n = len(local)
    owners = [r for r in range(num_processes) for _ in range(n)]
    _joined = Cluster(process_id, num_processes, chosen, local,
                      coordinator_address, float(timeout_s))
    _mesh._cluster = Positions(local * num_processes, owners, process_id)
    _mesh.set_default_mesh(None)
    return True


def shutdown_cluster() -> None:
    """Leave the cluster (destroys the process group); a no-op when none
    was joined."""
    global _joined
    if _joined is None:
        return
    import torch.distributed as dist

    _joined = None
    _mesh._cluster = None
    _mesh.set_default_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def joined() -> Optional[Cluster]:
    """This process's cluster membership, or None."""
    return _joined


def process_index() -> int:
    return _joined.rank if _joined is not None else 0


def process_count() -> int:
    return _joined.size if _joined is not None else 1


def hybrid_mesh(ici_shape: Sequence[int],
                ici_axes: Sequence[str] = ("data", "model"),
                dcn_axis: str = "hosts") -> Mesh:
    """The (hosts × ici) mesh: the slowest axis outermost. The granule of
    the hosts axis is the process (the reference's ``process_is_granule``
    when no device carries a slice index): host row ``h`` is process
    ``h``'s positions, and the ici axes must span one process's
    positions. Without a cluster, ``hosts`` is 1 and the ici axes span
    the visible positions."""
    devices = visible_devices()
    n_hosts = process_count()
    per_host = len(devices) // n_hosts
    total = math.prod(ici_shape)
    if total != per_host:
        raise ValueError(f"ici shape {tuple(ici_shape)} != {per_host} "
                         f"devices" + (" a process" if n_hosts > 1 else ""))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    shape = (n_hosts,) + tuple(ici_shape)
    owners = getattr(devices, "owners", None)
    return Mesh(arr.reshape(shape), (dcn_axis,) + tuple(ici_axes),
                None if owners is None else np.asarray(owners).reshape(shape))


def cluster_info(device_type: Optional[str] = None) -> Dict:
    """The reference's ``getAllResources`` equivalent: this process's
    index and the process count, its own positions (of ``device_type``;
    default: the cluster's type, else the cards), the global position
    count, the card's name (``"cpu"`` for CPU positions) and the backend
    (None without a cluster)."""
    if _joined is not None and device_type in (None,
                                               _joined.local[0].type):
        local: List[torch.device] = list(_joined.local)
        total = len(local) * _joined.size
    else:
        local = list(local_devices(device_type))
        total = len(local)
    dev = local[0]
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": [str(d) for d in local],
        "global_device_count": total,
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else dev.type),
        "backend": _joined.backend if _joined is not None else None,
    }


__all__ = ["initialize_cluster", "shutdown_cluster", "hybrid_mesh",
           "cluster_info", "choose_backend", "joined", "process_index",
           "process_count", "PeerLost", "Cluster", "DEFAULT_TIMEOUT_S"]
