"""Streamable decomposition of a node over a paged tensor set —
counterpart of ``TensorFold`` in ``netsdb_tpu/plan/fold.py``.

In the reference system FF inference scans its weight sets page by page
like any other pipeline (``SimpleFF.cc:94-290``, fed by
``PageScanner.h``). A ``Join``/``Apply`` carrying a :class:`TensorFold`
consumes a ``storage="paged"`` matrix the same way: the executor
streams the matrix's row blocks through the node instead of
materialising it (which ``SetStore.get_tensor`` refuses for paged
sets). The relational ``FoldSpec`` belongs to ROADMAP.md A6.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TensorFold:
    """Two decompositions cover the weight-matmul family.

    - ``mode="rows"``: the node's ``fn`` is row-decomposable in the
      paged input (``w @ x`` with the paged side on the left): row block
      *i* of the matrix gives row block *i* of the output. The executor
      runs ``fn`` once per block and concatenates the output rows;
      ``out_block`` gives the assembled ``BlockedTensor`` the resident
      path's block shape.
    - ``mode="reduce"``: the row blocks are contraction slices (``x @ w``
      with the paged side on the right): ``partial(carry, start, block,
      *others) -> carry`` accumulates partial products (``carry`` is
      None on the first block; later blocks update it in place) and
      ``finalize(carry, *others)`` applies any epilogue. ``others`` are
      the node's other inputs in order.

    ``summa_rhs`` (rows mode) declares ``fn(block, *others) == block @
    summa_rhs(*others)`` for the distributed matmul of the reference; it
    is accepted and ignored, since ``Configuration(distributed_matmul=
    True)`` belongs to ROADMAP.md A4 and raises there.
    """

    mode: str = "rows"
    out_block: Optional[Tuple[int, int]] = None
    partial: Optional[Callable] = None
    finalize: Optional[Callable] = None
    summa_rhs: Optional[Callable] = None

    def __post_init__(self):
        if self.mode not in ("rows", "reduce"):
            raise ValueError(f"TensorFold mode must be 'rows' or "
                             f"'reduce', got {self.mode!r}")
        if self.mode == "reduce" and self.partial is None:
            raise ValueError("TensorFold(mode='reduce') needs a partial "
                             "accumulator")

