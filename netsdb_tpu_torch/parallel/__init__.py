"""Meshes, placements and the in-process distributed layer — counterpart
of ``netsdb_tpu/parallel/__init__.py``.

One process drives every mesh position (``mesh.py``): the collective
matmuls (``collectives.py``), ring and Ulysses attention (``ring.py``),
the SUMMA matmul over paged operands (``summa.py``) and collective
resharding (``reshard.py``). Processes joined over NCCL
(``initialize_cluster``, ``hybrid_mesh``, ``cluster_info``) and the
pipeline schedule (``pipeline_apply``) are not ported: they raise,
naming ROADMAP.md A4 part 3."""

from netsdb_tpu_torch.parallel.collectives import (
    all_to_all_resharding,
    matmul_allgather,
    matmul_psum,
    matmul_psum_scatter,
)
from netsdb_tpu_torch.parallel.mesh import (
    default_mesh,
    make_mesh,
    replicate,
    set_default_mesh,
    shard_blocked,
)
from netsdb_tpu_torch.parallel.reshard import plan_steps, reshard_set
from netsdb_tpu_torch.parallel.ring import ring_attention, ulysses_attention
from netsdb_tpu_torch.parallel.summa import (
    summa_matmul_resident,
    summa_matmul_streamed,
)


def _part3(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md A4 part 3")


def initialize_cluster(*args, **kwargs):
    """Processes joined over NCCL (gloo on the CPU): ROADMAP.md A4 part 3."""
    _part3("initialize_cluster (processes joined over NCCL)")


def hybrid_mesh(*args, **kwargs):
    """A mesh over the hosts of a cluster: ROADMAP.md A4 part 3."""
    _part3("hybrid_mesh (a mesh over the hosts of a cluster)")


def cluster_info(*args, **kwargs):
    """The cluster's process and device counts: ROADMAP.md A4 part 3."""
    _part3("cluster_info (the processes of a cluster)")


def pipeline_apply(*args, **kwargs):
    """Pipeline parallelism over a mesh axis: ROADMAP.md A4 part 3."""
    _part3("pipeline_apply (pipeline parallelism)")


__all__ = [
    "default_mesh", "make_mesh", "set_default_mesh", "shard_blocked",
    "replicate", "matmul_psum", "matmul_psum_scatter", "matmul_allgather",
    "all_to_all_resharding", "ring_attention", "ulysses_attention",
    "summa_matmul_streamed", "summa_matmul_resident", "plan_steps",
    "reshard_set",
]
