"""Plan-text parser — counterpart of ``netsdb_tpu/plan/parser.py``, the
round-trip half of the textual plan dump.

The reference ships a DAG as TCAP text that workers re-parse
(``src/logicalPlan/source/Lexer.l:50-70``, ``Parser.y``) and rebind to
the shipped Computations (``ComputePlan.cc:20-56``). Here
:func:`parse_plan` turns a ``to_plan_string`` dump (the same text in
both packages) into structural atoms with producer and consumer maps,
and :meth:`ParsedPlan.to_computations` rebinds the atoms to Python
functions from a registry keyed by label.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List

from netsdb_tpu_torch.plan.computations import (
    Aggregate, Apply, Computation, Filter, Join, MultiApply, Partition,
    ScanSet, WriteSet,
)

# name <= KIND(arg, arg, ...) ; args are bare identifiers or 'quoted'
_ATOM_RE = re.compile(r"^\s*(\S+)\s*<=\s*([A-Z]+)\((.*)\)\s*$")


@dataclasses.dataclass
class ParsedAtom:
    """One line of the dump — reference ``AtomicComputation``."""

    name: str
    kind: str             # SCAN/APPLY/FILTER/FLATTEN/JOIN/AGGREGATE/OUTPUT
    inputs: List[str]     # upstream atom names
    literals: List[str]   # quoted args (labels, db/set names)

    def __str__(self) -> str:
        args = list(self.inputs) + [f"'{l}'" for l in self.literals]
        return f"{self.name} <= {self.kind}({', '.join(args)})"


def _split_args(raw: str) -> List[str]:
    """Split a TCAP-ish arg list, honouring single quotes."""
    args, buf, in_q = [], [], False
    for ch in raw:
        if ch == "'":
            in_q = not in_q
            buf.append(ch)
        elif ch == "," and not in_q:
            args.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    last = "".join(buf).strip()
    if last:
        args.append(last)
    return args


class PlanParseError(ValueError):
    pass


@dataclasses.dataclass
class ParsedPlan:
    """Structural plan — reference ``LogicalPlan`` +
    ``AtomicComputationList`` with producer/consumer maps."""

    atoms: List[ParsedAtom]

    def __post_init__(self):
        self.by_name: Dict[str, ParsedAtom] = {}
        self.consumers: Dict[str, List[ParsedAtom]] = {}
        for a in self.atoms:
            if a.name in self.by_name:
                raise PlanParseError(f"duplicate atom name {a.name!r}")
            self.by_name[a.name] = a
        for a in self.atoms:
            for src in a.inputs:
                if src not in self.by_name:
                    raise PlanParseError(
                        f"atom {a.name!r} consumes undefined {src!r}")
                self.consumers.setdefault(src, []).append(a)

    @property
    def scans(self) -> List[ParsedAtom]:
        return [a for a in self.atoms if a.kind == "SCAN"]

    @property
    def outputs(self) -> List[ParsedAtom]:
        return [a for a in self.atoms if a.kind == "OUTPUT"]

    def to_plan_string(self) -> str:
        return "\n".join(str(a) for a in self.atoms)

    # --- rebind to executable Computations ---------------------------
    def to_computations(self, registry: Dict[str, Any]) -> List[WriteSet]:
        """Rebuild an executable DAG: each APPLY/FILTER/FLATTEN/JOIN/
        AGGREGATE atom looks up its label in ``registry``. Values are
        the kwargs the node type takes (a bare callable is shorthand
        for the node's primary function). The reference analogue is
        ``ComputePlan``'s TCAP→executor binding against the shipped
        Computation objects (``ComputePlan.cc:258-283``). Atoms may
        appear in any order; they are built in dependency order."""
        built: Dict[str, Computation] = {}

        # topo-order the atoms (hand-written plan text need not be
        # ordered; __post_init__ already guarantees every input exists)
        order: List[ParsedAtom] = []
        state: Dict[str, int] = {}  # 0=visiting, 1=done

        def visit(atom: ParsedAtom) -> None:
            if state.get(atom.name) == 1:
                return
            if state.get(atom.name) == 0:
                raise PlanParseError(f"cycle through atom {atom.name!r}")
            state[atom.name] = 0
            for src in atom.inputs:
                visit(self.by_name[src])
            state[atom.name] = 1
            order.append(atom)

        for a in self.atoms:
            visit(a)

        def kwargs_for(atom: ParsedAtom) -> Dict[str, Any]:
            label = atom.literals[0] if atom.literals else ""
            if label not in registry:
                raise PlanParseError(
                    f"no registry entry for {atom.kind} label {label!r}")
            spec = registry[label]
            return dict(spec) if isinstance(spec, dict) else {"fn": spec}

        arity = {  # kind → (n_inputs, n_literals)
            "SCAN": (0, 2), "APPLY": (1, 1), "FILTER": (1, 1),
            "FLATTEN": (1, 1), "JOIN": (2, 1), "AGGREGATE": (1, 1),
            "PARTITION": (1, 1), "OUTPUT": (1, 2),
        }
        for a in order:
            if a.kind in arity:
                n_in, n_lit = arity[a.kind]
                if len(a.inputs) != n_in or len(a.literals) != n_lit:
                    raise PlanParseError(
                        f"atom {a.name!r}: {a.kind} takes {n_in} input(s) "
                        f"and {n_lit} literal(s), got {len(a.inputs)} and "
                        f"{len(a.literals)}")
            ins = [built[s] for s in a.inputs]
            if a.kind == "SCAN":
                built[a.name] = ScanSet(a.literals[0], a.literals[1])
            elif a.kind == "APPLY":
                built[a.name] = Apply(ins[0], label=a.literals[0],
                                      **kwargs_for(a))
            elif a.kind == "FILTER":
                kw = kwargs_for(a)
                pred = kw.pop("pred", None) or kw.pop("fn", None)
                built[a.name] = Filter(ins[0], pred, label=a.literals[0],
                                       **kw)
            elif a.kind == "FLATTEN":
                built[a.name] = MultiApply(ins[0], label=a.literals[0],
                                           **kwargs_for(a))
            elif a.kind == "JOIN":
                built[a.name] = Join(ins[0], ins[1], label=a.literals[0],
                                     **kwargs_for(a))
            elif a.kind == "AGGREGATE":
                built[a.name] = Aggregate(ins[0], label=a.literals[0],
                                          **kwargs_for(a))
            elif a.kind == "PARTITION":
                kw = kwargs_for(a)
                key_fn = kw.pop("key_fn", None)
                key_fn = key_fn or kw.pop("fn", None)
                kw.pop("fn", None)
                if key_fn is None or "num_partitions" not in kw:
                    raise PlanParseError(
                        f"PARTITION label {a.literals[0]!r}: registry entry "
                        f"must be a dict with 'key_fn' (or 'fn') and "
                        f"'num_partitions'")
                built[a.name] = Partition(ins[0], key_fn,
                                          label=a.literals[0], **kw)
            elif a.kind == "OUTPUT":
                built[a.name] = WriteSet(ins[0], a.literals[0],
                                         a.literals[1])
            else:
                raise PlanParseError(f"unknown atom kind {a.kind!r}")
        return [built[o.name] for o in self.outputs]


def parse_plan(text: str) -> ParsedPlan:
    """Parse a ``to_plan_string`` dump. Unknown kinds parse structurally
    (they only fail at ``to_computations``), matching the reference
    parser's separation of syntax from binding."""
    atoms = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _ATOM_RE.match(line)
        if not m:
            raise PlanParseError(f"line {lineno}: cannot parse {line!r}")
        name, kind, raw = m.groups()
        inputs, literals = [], []
        for arg in _split_args(raw):
            if arg.startswith("'") and arg.endswith("'"):
                literals.append(arg[1:-1])
            else:
                inputs.append(arg)
        atoms.append(ParsedAtom(name, kind, inputs, literals))
    return ParsedPlan(atoms)
