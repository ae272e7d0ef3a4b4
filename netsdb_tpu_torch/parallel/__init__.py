"""Meshes, placements and the in-process distributed layer — counterpart
of ``netsdb_tpu/parallel/__init__.py``.

One process drives every mesh position (``mesh.py``), and ops over
placed tensors follow one rule (``placed_ops.py``): the collective
matmuls (``collectives.py``), ring and Ulysses attention (``ring.py``),
the SUMMA matmul over paged operands (``summa.py``), collective
resharding (``reshard.py``), the pipeline schedule (``pipeline.py``)
and the single-process half of the cluster layer (``distributed.py``).
Processes joined over NCCL (``initialize_cluster`` with a coordinator
or a process count) raise, naming ROADMAP.md A4 part 3."""

from netsdb_tpu_torch.parallel.collectives import (
    all_to_all_resharding,
    matmul_allgather,
    matmul_psum,
    matmul_psum_scatter,
)
from netsdb_tpu_torch.parallel.distributed import (
    cluster_info,
    hybrid_mesh,
    initialize_cluster,
)
from netsdb_tpu_torch.parallel.mesh import (
    default_mesh,
    make_mesh,
    replicate,
    set_default_mesh,
    shard_blocked,
)
from netsdb_tpu_torch.parallel.pipeline import pipeline_apply
from netsdb_tpu_torch.parallel.reshard import plan_steps, reshard_set
from netsdb_tpu_torch.parallel.ring import ring_attention, ulysses_attention
from netsdb_tpu_torch.parallel.summa import (
    summa_matmul_resident,
    summa_matmul_streamed,
)


__all__ = [
    "default_mesh", "make_mesh", "set_default_mesh", "shard_blocked",
    "replicate", "matmul_psum", "matmul_psum_scatter", "matmul_allgather",
    "all_to_all_resharding", "ring_attention", "ulysses_attention",
    "initialize_cluster", "hybrid_mesh", "cluster_info", "pipeline_apply",
    "summa_matmul_streamed", "summa_matmul_resident", "plan_steps",
    "reshard_set",
]
