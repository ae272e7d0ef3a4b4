"""Computation DAG — the user-facing query API; counterpart of
``netsdb_tpu/plan/computations.py``.

Each node carries a Python function over set values (``BlockedTensor``s,
tensors, column tables or host records); the executor replays the DAG
in topo order. Node kinds keep the reference's names (``ScanSet``/
``Apply``/``Filter``/``MultiApply``/``Join``/``Aggregate``/``Partition``/
``WriteSet`` ≙ ScanUserSet/SelectionComp/its selection/
MultiSelectionComp/JoinComp/AggregateComp/PartitionComp/SetWriter) and
the TCAP-like ``plan_atom`` dump, atom for atom, so a plan string is the
same in both packages. The host nodes (``Filter``, ``MultiApply``, a
key-function ``Join``, a ``key``/``value``/``combine`` ``Aggregate``,
``Partition``) iterate records in input order and keep it: a join's
pairs come in probe order, then build-bucket order; an aggregate's dict
in first-seen key order. ``Join(on=...)`` joins by column name on the
device (:func:`~netsdb_tpu_torch.relational.autojoin.equijoin`), record
inputs columnarised on the way. A node given a ``tensor_fold``
(:class:`~netsdb_tpu_torch.plan.fold.TensorFold`) may consume a paged
tensor set: the executor streams the set's row blocks through it. A node
given a relational ``fold`` (:class:`~netsdb_tpu_torch.plan.fold.
FoldSpec`) and no ``fn`` derives ``fn`` from the fold's whole-relation
path, so the two cannot diverge.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Optional, Sequence

_ids = itertools.count()

#: labels of the audited row-decomposable chunk transforms (the
#: reference's ``ROWWISE_SAFE_LABELS``): an :class:`Apply` whose label
#: matches one (exactly, or by prefix for an entry ending in ``:``) is
#: ``rowwise`` unless it declares otherwise
ROWWISE_SAFE_LABELS = ("pre:affine", "pre:project", "pre:scale")


def rowwise_safe(label: str) -> bool:
    """True when ``label`` is in the derived rowwise set."""
    lab = str(label or "")
    return any(lab.startswith(entry) if entry.endswith(":")
               else lab == entry for entry in ROWWISE_SAFE_LABELS)


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
    says how the node streams a paged tensor input; with ``fn=None`` a
    ``fold`` gives ``fn`` (``fold.whole``). ``label`` should name every
    parameter ``fn`` closes over, as the reference's builders do (the
    port's compiled programs also key on the closure's values, so a
    reused label never serves another closure's result).

    ``traceable=False`` keeps the node out of every compiled program
    (host work that must run as it comes). ``rowwise=True`` declares
    ``fn`` row-decomposable and schema-preserving (a row slice in gives
    the matching row slice of the whole result, a ColumnTable in a
    ColumnTable out with the same dictionaries), so the fusion mapper
    may run it inside a streamed fold's per-chunk step; ``None`` derives
    it from :data:`ROWWISE_SAFE_LABELS`."""

    op_kind = "Apply"

    def __init__(self, input_: Computation,
                 fn: Optional[Callable[[Any], Any]] = None,
                 label: str = "", tensor_fold=None, fold=None,
                 traceable: bool = True, rowwise: Optional[bool] = None):
        super().__init__([input_])
        if fn is None:
            if fold is None:
                raise ValueError("Apply needs fn or fold")
            fn = fold.whole
        self.fn = fn
        self.fold = fold
        self.tensor_fold = tensor_fold
        self.traceable = traceable
        self.label = label or getattr(fn, "__name__", "fn")
        self.rowwise = (bool(rowwise) if rowwise is not None
                        else rowwise_safe(self.label))

    def evaluate(self, x):
        return self.fn(x)

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= APPLY({self.inputs[0].output_name}, "
                f"'{self.label}')")


class Filter(Computation):
    """Selection predicate over host records — reference
    ``SelectionComp::getSelection`` (the FILTER atom)."""

    op_kind = "Filter"

    def __init__(self, input_: Computation, pred: Callable[[Any], bool],
                 label: str = ""):
        super().__init__([input_])
        self.pred = pred
        self.label = label or getattr(pred, "__name__", "pred")

    def evaluate(self, items):
        return [x for x in items if self.pred(x)]

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= FILTER({self.inputs[0].output_name}, "
                f"'{self.label}')")


class MultiApply(Computation):
    """1-in → many-out flatten — reference ``MultiSelectionComp`` (the
    FLATTEN atom). ``fn`` returns a list per input record; the lists
    concatenate in input order."""

    op_kind = "Flatten"

    def __init__(self, input_: Computation, fn: Callable[[Any], List[Any]],
                 label: str = ""):
        super().__init__([input_])
        self.fn = fn
        self.label = label or getattr(fn, "__name__", "fn")

    def evaluate(self, items):
        out: List[Any] = []
        for x in items:
            out.extend(self.fn(x))
        return out

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= FLATTEN({self.inputs[0].output_name}, "
                f"'{self.label}')")


class Join(Computation):
    """2-in combine — reference ``JoinComp``. For tensor pipelines the
    join-on-block-index + projection is one fn (e.g. ``ops.matmul_t``);
    for host records an equi-join on key functions (``left_key``,
    ``right_key``, ``project``: a hash join that builds on the right and
    probes with the left, pairs in probe order, then bucket order).

    ``on=(left_col, right_col)`` names the equi-join key by column and
    runs the join on the device (:func:`~netsdb_tpu_torch.relational.
    autojoin.equijoin`, a unique-key right side): a record input is
    columnarised on the way (string keys dictionary-encoded, the two
    dictionaries unified on the host) and ``take`` limits the right
    columns gathered. A failure there raises; the host join never takes
    its place.

    ``passthrough=True`` declares that ``fn`` only re-shapes its inputs
    (the gather-chain tuple append that collects a model's weight sets
    before the node that uses them); such a node forwards a paged
    tensor handle untouched. ``tensor_fold`` says how the node streams a
    paged tensor input.

    ``fold`` + ``fold_src``: with ``fn=None`` the node evaluates the
    fold's whole path over input ``fold_src`` (0 left, 1 right, the
    probe or fact side), the other input passed as resident values
    (gather tuples flattened).

    ``rowwise=True`` declares ``fn`` row-decomposable in its left input
    (the right one read whole): over a row-sharded placed left input
    each mesh position joins its own rows and the result stays placed
    (``relational/sharded.dispatch_placed``)."""

    op_kind = "Join"

    def __init__(self, left: Computation, right: Computation,
                 fn: Optional[Callable[[Any, Any], Any]] = None,
                 left_key: Optional[Callable] = None,
                 right_key: Optional[Callable] = None,
                 project: Optional[Callable[[Any, Any], Any]] = None,
                 label: str = "", fold=None, fold_src: int = 0,
                 on: Optional[tuple] = None,
                 take: Optional[Sequence[str]] = None,
                 tensor_fold=None, passthrough: bool = False,
                 rowwise: bool = False):
        super().__init__([left, right])
        self.rowwise = rowwise
        self.on = tuple(on) if on else None
        self.take = take
        self.left_key = left_key
        self.right_key = right_key
        self.project = project
        if fn is None and left_key is None and self.on is None:
            if fold is None:
                raise ValueError("Join needs fn, fold, left_key/right_key "
                                 "or on")
            from netsdb_tpu_torch.plan.fold import flatten_resident

            if fold_src == 0:
                fn = lambda a, b: fold.whole(a, *flatten_resident((b,)))
            else:
                fn = lambda a, b: fold.whole(b, *flatten_resident((a,)))
        self.fn = fn
        self.fold = fold
        self.fold_src = fold_src
        self.tensor_fold = tensor_fold
        self.passthrough = passthrough
        self.label = label or (getattr(fn, "__name__", "join") if fn
                               else "equijoin")

    def evaluate(self, left, right, device=None):
        """``device`` is where a record input of an ``on=`` join is
        columnarised (the executor passes the client's); by default the
        device of the other input's table, else CUDA."""
        if self.fn is not None:
            return self.fn(left, right)
        if self.on is not None:
            from netsdb_tpu_torch.relational.autojoin import (
                equijoin, table_from_objects)
            from netsdb_tpu_torch.relational.table import ColumnTable

            if device is None:
                device = next((t.device for t in (left, right)
                               if isinstance(t, ColumnTable)), None)
            lt = (left if isinstance(left, ColumnTable)
                  else table_from_objects(list(left), device=device))
            rt = (right if isinstance(right, ColumnTable)
                  else table_from_objects(list(right), device=device))
            return equijoin(lt, self.on[0], rt, self.on[1], take=self.take)
        table: dict = {}
        for r in right:
            table.setdefault(self.right_key(r), []).append(r)
        out = []
        proj = self.project or (lambda a, b: (a, b))
        for item in left:
            for r in table.get(self.left_key(item), ()):
                out.append(proj(item, r))
        return out

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= JOIN({self.inputs[0].output_name}, "
                f"{self.inputs[1].output_name}, '{self.label}')")


class Aggregate(Computation):
    """Group-by / reduce — reference ``AggregateComp``. ``fn`` is a
    reduction over the whole input; otherwise ``key``/``value``/
    ``combine`` fold the input's records into a dict, keys in
    first-seen order (the reference's combiner and aggregation
    processors as one fold)."""

    op_kind = "Aggregate"

    def __init__(self, input_: Computation,
                 fn: Optional[Callable[[Any], Any]] = None,
                 key: Optional[Callable] = None,
                 value: Optional[Callable] = None,
                 combine: Optional[Callable[[Any, Any], Any]] = None,
                 label: str = ""):
        super().__init__([input_])
        self.fn = fn
        self.key = key
        self.value = value
        self.combine = combine
        self.label = label or (getattr(fn, "__name__", "agg") if fn
                               else "groupby")

    def evaluate(self, x):
        if self.fn is not None:
            return self.fn(x)
        acc: dict = {}
        for item in x:
            k = self.key(item)
            v = self.value(item)
            acc[k] = self.combine(acc[k], v) if k in acc else v
        return acc

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= AGGREGATE("
                f"{self.inputs[0].output_name}, '{self.label}')")


class Partition(Computation):
    """Repartition by key — reference ``PartitionComp`` (the
    APPLY-PARTITION atom): each record goes to one of
    ``num_partitions`` by its key, routed by the dispatcher's
    :class:`~netsdb_tpu_torch.storage.dispatcher.HashPolicy`, so a set
    made from this node is co-partitioned with any set dispatched with
    the same key function. Output: ``{partition_id: [records]}``.

    ``key_fn`` given as a COLUMN NAME over a placed ``ColumnTable`` input
    is the mesh row shuffle: the node lowers to
    ``relational.shuffle.hash_repartition`` on the mesh the set's
    placement put the columns on (the reference's partition stage
    shipping rows to their owning workers, ``PipelineStage.cc:1652-1728``)
    and gives a ``ShardedRows`` for a downstream ``local_join`` or
    aggregate stage."""

    op_kind = "Partition"

    def __init__(self, input_: Computation, key_fn,
                 num_partitions: int, label: str = "",
                 slack: float = 2.0):
        super().__init__([input_])
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got "
                             f"{num_partitions}")
        self.key_fn = key_fn
        self.num_partitions = num_partitions
        self.slack = slack
        self.traceable = False  # host routing and the shuffle run as they come
        self.label = label or (key_fn if isinstance(key_fn, str)
                               else getattr(key_fn, "__name__", "partition"))

    def evaluate(self, items):
        if isinstance(self.key_fn, str):
            from netsdb_tpu_torch.relational.shuffle import hash_repartition
            from netsdb_tpu_torch.relational.table import ColumnTable

            if not isinstance(items, ColumnTable):
                raise TypeError(
                    f"Partition on column {self.key_fn!r} needs a "
                    f"ColumnTable input; got {type(items).__name__}")
            mesh, axis = _mesh_of_table(items)
            if mesh.shape[axis] != self.num_partitions:
                raise ValueError(
                    f"Partition declared {self.num_partitions} "
                    f"partitions but the set's placement meshes "
                    f"{mesh.shape[axis]} shards on {axis!r}")
            return hash_repartition(mesh, axis, dict(items.cols),
                                    self.key_fn, self.slack,
                                    valid=items.valid)
        from netsdb_tpu_torch.storage.dispatcher import HashPolicy

        parts = HashPolicy(self.key_fn).partition(items,
                                                  self.num_partitions)
        return dict(enumerate(parts))

    def plan_atom(self) -> str:
        return (f"{self.output_name} <= PARTITION("
                f"{self.inputs[0].output_name}, '{self.label}')")


def _mesh_of_table(table):
    """(mesh, axis) a placed ColumnTable's rows are sharded over — read
    off its columns, so DAG nodes never take a hand mesh."""
    from netsdb_tpu_torch.parallel.placement import (is_placed_table,
                                                     table_layout)

    if is_placed_table(table):
        mesh, spec = table_layout(table)
        entry = spec[0]
        if entry is not None:
            return mesh, (entry if isinstance(entry, str) else entry[0])
    raise ValueError(
        "device Partition needs a placed (mesh-sharded) input set — "
        "create the set with a row-sharding Placement")


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
