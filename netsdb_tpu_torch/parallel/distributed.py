"""The cluster layer, single-process half — counterpart of
``netsdb_tpu/parallel/distributed.py``.

The reference joins per-host processes into one cluster with
``jax.distributed.initialize`` (the role of netsDB's
``startMaster.sh``/``startWorkers.sh``), builds a (hosts, ici...) mesh
over every process's devices and reports the cluster's resources. One
process of the port drives every position of its mesh
(``parallel/mesh.py``); processes joined over NCCL, a mesh over several
hosts and ``ShardedTensor`` positions owned by another process are
ROADMAP.md A4 part 3 and raise. What one process does is ported:

- :func:`initialize_cluster` is a no-op (returns False) when no
  coordinator and no process count is given, as in the reference;
- :func:`hybrid_mesh` builds the ``("hosts", *ici_axes)`` mesh with one
  host over the visible positions;
- :func:`cluster_info` reports the one process.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from netsdb_tpu_torch.parallel.mesh import Mesh, visible_devices


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> bool:
    """Join this process into a cluster. With no coordinator (argument or
    ``NETSDB_TPU_COORDINATOR``) and no process count it is a no-op and
    returns False (one process drives every position); any other call
    raises: processes joined over NCCL are ROADMAP.md A4 part 3."""
    coordinator_address = coordinator_address or os.environ.get(
        "NETSDB_TPU_COORDINATOR")
    if coordinator_address is None and num_processes is None:
        return False
    raise NotImplementedError(
        f"initialize_cluster(coordinator_address={coordinator_address!r}, "
        f"num_processes={num_processes!r}, process_id={process_id!r}): "
        f"processes joined over NCCL (gloo on the CPU) are not ported "
        f"yet: ROADMAP.md A4 part 3")


def hybrid_mesh(ici_shape: Sequence[int],
                ici_axes: Sequence[str] = ("data", "model"),
                dcn_axis: str = "hosts") -> Mesh:
    """The (hosts × ici) mesh: the slowest axis outermost. One process is
    one host, so ``hosts`` is 1 and the ici axes span the visible
    positions; their product must equal the position count."""
    devices = visible_devices()
    total = math.prod(ici_shape)
    if total != len(devices):
        raise ValueError(f"ici shape {tuple(ici_shape)} != {len(devices)} "
                         f"devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape((1,) + tuple(ici_shape)),
                (dcn_axis,) + tuple(ici_axes))


def cluster_info(device_type: Optional[str] = None) -> Dict:
    """The reference's ``getAllResources`` equivalent for the one
    process: its index and count, its positions (of ``device_type``;
    default: the cards), their count and the card's name (``"cpu"`` for
    CPU positions)."""
    devices = visible_devices(device_type)
    dev = devices[0]
    return {
        "process_index": 0,
        "process_count": 1,
        "local_devices": [str(d) for d in devices],
        "global_device_count": len(devices),
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else dev.type),
    }
