"""Computation DAG — the user-facing query API; counterpart of
``netsdb_tpu/plan/computations.py``.

Each node carries a Python function over set values (``BlockedTensor``s,
tensors or host objects); the executor replays the DAG in topo order.
Node kinds keep the reference's names (``ScanSet``/``Apply``/``Join``/
``WriteSet`` ≙ ScanUserSet/SelectionComp/JoinComp/SetWriter) and the
TCAP-like ``plan_atom`` dump. A node given a ``tensor_fold``
(:class:`~netsdb_tpu_torch.plan.fold.TensorFold`) may consume a paged
tensor set: the executor streams the set's row blocks through it.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Sequence

_ids = itertools.count()


class Computation:
    """DAG node. ``inputs`` are upstream Computations."""

    op_kind = "Computation"

    def __init__(self, inputs: Sequence["Computation"]):
        self.inputs: List[Computation] = list(inputs)
        self.node_id = next(_ids)
        self.output_name = f"{self.op_kind}_{self.node_id}"

    def evaluate(self, *args: Any) -> Any:
        raise NotImplementedError

    def plan_atom(self) -> str:
        ins = ", ".join(i.output_name for i in self.inputs)
        return f"{self.output_name} <= {self.op_kind.upper()}({ins})"

    def __repr__(self):
        return f"<{self.op_kind} #{self.node_id}>"


class ScanSet(Computation):
    """Read a stored set — reference ``ScanUserSet``. Leaf node."""

    op_kind = "Scan"

    def __init__(self, db: str, set_name: str):
        super().__init__([])
        self.db = db
        self.set_name = set_name
        self.output_name = f"scan_{db}_{set_name}_{self.node_id}"

    def plan_atom(self) -> str:
        return f"{self.output_name} <= SCAN('{self.db}', '{self.set_name}')"


class Apply(Computation):
    """1-in projection — reference ``SelectionComp``. ``tensor_fold``
    says how the node streams a paged tensor input."""

    op_kind = "Apply"

    def __init__(self, input_: Computation, fn: Callable[[Any], Any],
                 label: str = "", tensor_fold=None):
        super().__init__([input_])
        self.fn = fn
        self.tensor_fold = tensor_fold
        self.label = label or getattr(fn, "__name__", "fn")

    def evaluate(self, x):
        return self.fn(x)

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= APPLY({self.inputs[0].output_name}, "
                f"'{self.label}')")


class Join(Computation):
    """2-in combine — reference ``JoinComp``. For tensor pipelines the
    join-on-block-index + projection is one fn (e.g. ``ops.matmul_t``).

    ``passthrough=True`` declares that ``fn`` only re-shapes its inputs
    (the gather-chain tuple append that collects a model's weight sets
    before the node that uses them); such a node forwards a paged
    tensor handle untouched. ``tensor_fold`` says how the node streams a
    paged tensor input."""

    op_kind = "Join"

    def __init__(self, left: Computation, right: Computation,
                 fn: Callable[[Any, Any], Any], label: str = "",
                 tensor_fold=None, passthrough: bool = False):
        super().__init__([left, right])
        self.fn = fn
        self.tensor_fold = tensor_fold
        self.passthrough = passthrough
        self.label = label or getattr(fn, "__name__", "join")

    def evaluate(self, left, right):
        return self.fn(left, right)

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= JOIN({self.inputs[0].output_name}, "
                f"{self.inputs[1].output_name}, '{self.label}')")


class WriteSet(Computation):
    """Materialise into a set — reference ``SetWriter``. Sink node."""

    op_kind = "Write"

    def __init__(self, input_: Computation, db: str, set_name: str):
        super().__init__([input_])
        self.db = db
        self.set_name = set_name

    def evaluate(self, x):
        return x

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= OUTPUT({self.inputs[0].output_name}, "
                f"'{self.db}', '{self.set_name}')")
