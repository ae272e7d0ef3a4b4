"""Decomposed forms of a Computation node — counterpart of
``netsdb_tpu/plan/fold.py``.

:class:`TensorFold` streams a paged tensor set through a node.
In the reference system FF inference scans its weight sets page by page
like any other pipeline (``SimpleFF.cc:94-290``, fed by
``PageScanner.h``). A ``Join``/``Apply`` carrying a :class:`TensorFold`
consumes a ``storage="paged"`` matrix the same way: the executor
streams the matrix's row blocks through the node instead of
materialising it (which ``SetStore.get_tensor`` refuses for paged
sets).

:class:`FoldSpec` is the relational (init, step, finalize) form, the
reference's PageScanner contract (``src/storage/headers/PageScanner.h:
25-34``): a node carrying one derives its whole-relation path from it,
and the executor streams a paged relation through the same init, step
and finalize chunk by chunk, so the two paths run the same math.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple


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
    summa_rhs(*others)``: under ``Configuration(distributed_matmul=True)``
    the executor then runs the stream as one SUMMA matmul
    (``plan/executor._summa_tensor_route``).
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



@dataclasses.dataclass(frozen=True)
class FoldSpec:
    """(init, step)* + finalize decomposition of a relational node —
    counterpart of the reference's ``FoldSpec``.

    Signatures (``src`` is the scanned relation, read for its schema;
    ``resident`` are the node's other input values, gather tuples
    flattened):

    - ``init(prev_state, src, *resident) -> state`` (``prev_state`` None
      for the first pass);
    - ``step(state, chunk, *resident) -> state``;
    - ``finalize(state, src, *resident) -> output``.

    Multi-pass folds thread each pass's state into the next ``init``.
    ``merge`` combines the outputs of independent build partitions;
    ``probe_key``, ``build_key`` and ``probe_columns`` name the join's
    columns; ``state_merge`` combines the final states of two row
    partitions. The port evaluates a fold over a memory set through
    :meth:`whole` and over a paged relation chunk by chunk
    (``plan/executor._run_fold``): a step may update its state in place
    and never writes a chunk."""

    passes: Tuple[Tuple[Callable, Callable], ...]
    finalize: Callable
    merge: Optional[Callable] = None
    probe_key: Optional[str] = None
    build_key: Optional[str] = None
    probe_columns: Optional[Tuple[str, ...]] = None
    state_merge: Optional[Callable] = None

    def whole(self, table: Any, *resident: Any) -> Any:
        """The whole relation as one chunk: the same init / step /
        finalize chain the streamed path runs."""
        state = None
        for init, step in self.passes:
            state = step(init(state, table, *resident), table, *resident)
        return self.finalize(state, table, *resident)


def single_pass(init: Callable, step: Callable,
                finalize: Callable, merge: Optional[Callable] = None,
                probe_key: Optional[str] = None,
                build_key: Optional[str] = None,
                probe_columns: Optional[Tuple[str, ...]] = None,
                state_merge: Optional[Callable] = None) -> FoldSpec:
    return FoldSpec(((init, step),), finalize, merge,
                    probe_key=probe_key, build_key=build_key,
                    probe_columns=probe_columns, state_merge=state_merge)


def tree_add_states(a: Any, b: Any) -> Any:
    """Elementwise sum of two states of the same structure (tensors in
    nested tuples, lists and dicts): the ``state_merge`` of folds whose
    state is additive (sums, counts, histograms)."""
    if isinstance(a, dict):
        return {k: tree_add_states(a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(tree_add_states(x, y) for x, y in zip(a, b))
    return a + b


def flatten_resident(values: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """Gather-chain tuples (the tuple-passing binary Joins of
    ``relational/dag.py``) flattened, so fold callables see tables
    positionally."""
    out = []
    for v in values:
        if isinstance(v, tuple):
            out.extend(v)
        else:
            out.append(v)
    return tuple(out)
