"""The discipline checks, one typed rule each: clock discipline,
exception taxonomy, zero-copy framing, pickle confinement, staging and
device-upload discipline, the print ban, qid minting, obs counter
discipline. Each is a :class:`~netsdb_tpu_torch.analysis.lint.Rule` with
its scope over the port's tree, and takes per-rule inline suppressions;
exemptions that are whole files or scopes live on as rule scope.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from netsdb_tpu_torch.analysis.lint import (Diagnostic, Module, Rule,
                                            register, terminal_name)
from netsdb_tpu_torch.analysis.summaries import sync_upload_what

_SERVE = "netsdb_tpu_torch/serve/"
_OBS = "netsdb_tpu_torch/obs/"
_PLAN = "netsdb_tpu_torch/plan/"
_STORAGE = "netsdb_tpu_torch/storage/"
_OOC = "netsdb_tpu_torch/relational/outofcore.py"

#: the two scopes allowed to upload on storage/plan paths: the device
#: cache's ``to_device`` (store-owned blocks) and the staging module's
#: ``BlockUploader`` (the background-thread uploads of stage_stream)
_UPLOAD_EXEMPT = (("netsdb_tpu_torch/storage/devcache.py", "to_device"),
                  ("netsdb_tpu_torch/plan/staging.py", "BlockUploader"))
#: protocol.py metadata codec — the only pickle-allowed functions
_PICKLE_OK_FUNCS = {"encode_body", "decode_body"}
#: print() is the OUTPUT of these (operator CLI / bench scripts)
_PRINT_EXEMPT = ("netsdb_tpu_torch/cli.py", "netsdb_tpu_torch/_reexec.py")
_PRINT_EXEMPT_DIRS = ("netsdb_tpu_torch/workloads/",)

_LOOP_NODES = (ast.For, ast.While, ast.AsyncFor, ast.ListComp,
               ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _upload_what(node: ast.AST) -> Optional[str]:
    """The label of a synchronous upload call — the port's own
    (``.to(<device>)``, ``.cuda()``, ``torch.as_tensor(..., device=)``)
    or a ``device_put`` — else None."""
    if not isinstance(node, ast.Call):
        return None
    if terminal_name(node.func) == "device_put":
        return "device_put"
    return sync_upload_what(node)


def _exempt_lines(mod: Module) -> List[Tuple[int, int]]:
    """Line spans of the sanctioned upload scopes in ``mod``."""
    names = {name for rel, name in _UPLOAD_EXEMPT if rel == mod.rel}
    if not names:
        return []
    return [(n.lineno, n.end_lineno) for n in mod.walk()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and n.name in names]


def _exempt(spans: List[Tuple[int, int]], node: ast.AST) -> bool:
    line = getattr(node, "lineno", 0)
    return any(a <= line <= b for a, b in spans)


@register
class WallClockRule(Rule):
    """``time.time()`` in deadline-bearing layers (serve/, obs/)."""

    id = "wall-clock"
    rationale = ("wall clocks jump (NTP); every deadline must be "
                 "time.monotonic(), display stamps via "
                 "utils.timing.wall_now")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith((_SERVE, _OBS))

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "time" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "time":
                yield self.diag(
                    mod, node,
                    "time.time() in a deadline-bearing layer — use "
                    "time.monotonic() (display: utils.timing.wall_now)")
            if isinstance(node, ast.ImportFrom) and node.module == "time" \
                    and any(a.name == "time" for a in node.names):
                yield self.diag(
                    mod, node,
                    "'from time import time' hides wall-clock reads "
                    "from review")


@register
class BroadExceptRule(Rule):
    """Broad except handlers that neither bind nor re-raise."""

    id = "broad-except"
    rationale = ("an opaque except erases the typed error taxonomy — "
                 "bind ('as e') and forward, or re-raise")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith((_SERVE, _OBS))

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException"))
            reraises = any(isinstance(sub, ast.Raise)
                           for sub in ast.walk(node))
            if broad and node.name is None and not reraises:
                yield self.diag(
                    mod, node,
                    "broad except that neither binds ('as e') nor "
                    "re-raises — type it or forward it "
                    "(serve/errors.py)")


@register
class ToBytesRule(Rule):
    """``.tobytes()`` on the serve data path (breaks zero-copy v3)."""

    id = "tobytes"
    rationale = ("tensor bytes ride out-of-band memoryview segments; "
                 "one .tobytes() reintroduces the full-payload copy")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith(_SERVE)

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "tobytes":
                yield self.diag(
                    mod, node,
                    ".tobytes() on the serve data path — ship the "
                    "buffer as an out-of-band segment (memoryview), "
                    "never a copy")


@register
class PickleProtocolRule(Rule):
    """pickle/cloudpickle outside protocol.py's metadata codec."""

    id = "pickle-protocol"
    rationale = ("tensor bytes must never ride a pickle stream; the "
                 "wire's pickle use is confined to the metadata codec")

    def select(self, mod: Module) -> bool:
        return mod.rel == _SERVE + "protocol.py"

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in _PICKLE_OK_FUNCS:
                    continue
                if self._mentions_pickle(node):
                    yield self.diag(
                        mod, node,
                        f"pickle use in {node.name}() — allowed only "
                        f"in the metadata codec "
                        f"({', '.join(sorted(_PICKLE_OK_FUNCS))})")
            elif self._mentions_pickle(node):
                yield self.diag(
                    mod, node,
                    "module-level pickle reference in the wire "
                    "protocol — allowed only inside the metadata "
                    "codec functions")

    @staticmethod
    def _mentions_pickle(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) \
                    and sub.id in ("pickle", "cloudpickle"):
                return True
            if isinstance(sub, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in sub.names]
                if isinstance(sub, ast.ImportFrom) and sub.module:
                    names.append(sub.module)
                if any(n.split(".")[0] in ("pickle", "cloudpickle")
                       for n in names):
                    return True
        return False


@register
class DevicePutLoopRule(Rule):
    """Synchronous uploads (``.to(<device>)``, ``.cuda()``,
    ``torch.as_tensor(..., device=)``) inside loop bodies on the
    streamed hot paths (plan/, outofcore)."""

    id = "device-put-loop"
    rationale = ("per-chunk uploads go through plan/staging."
                 "stage_stream so the copy overlaps compute")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith(_PLAN) or mod.rel == _OOC

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        spans = _exempt_lines(mod)
        seen: Set[int] = set()
        for loop in mod.walk():
            if not isinstance(loop, _LOOP_NODES):
                continue
            for sub in ast.walk(loop):
                what = _upload_what(sub)
                if what is None or id(sub) in seen or _exempt(spans, sub):
                    continue
                seen.add(id(sub))  # nested loops see a call once
                yield self.diag(
                    mod, sub,
                    f"synchronous upload {what} inside a loop body — "
                    f"stage uploads through plan/staging.stage_stream "
                    f"so the copy overlaps the consumer's compute")


@register
class DevicePutDirectRule(Rule):
    """Any synchronous upload on storage/plan paths outside the
    sanctioned upload scopes (cache bypass)."""

    id = "device-put-direct"
    rationale = ("store-owned block uploads go through storage/"
                 "devcache.to_device or the cross-query cache is "
                 "silently bypassed and its counters lie")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith((_STORAGE, _PLAN)) or mod.rel == _OOC

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        spans = _exempt_lines(mod)
        for node in mod.walk():
            hit = None
            what = _upload_what(node)
            if what is not None:
                hit = f"call {what}"
            elif isinstance(node, ast.ImportFrom):
                if any(a.name == "device_put" for a in node.names):
                    hit = "import"
            if hit and not _exempt(spans, node):
                yield self.diag(
                    mod, node,
                    f"direct upload ({hit}) on a store/plan path "
                    f"— upload set blocks via storage/devcache."
                    f"to_device (inside a stage_stream place "
                    f"function) so the device cache cannot be "
                    f"silently bypassed")


@register
class ModuleDictCounterRule(Rule):
    """Module-level dict literals in obs/ (counters belong to the
    registry)."""

    id = "module-dict-counter"
    rationale = ("a bare module dict is invisible to COLLECT_STATS "
                 "and un-resettable; counters go through "
                 "MetricsRegistry")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith(_OBS)

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.tree.body:
            targets, value = [], None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            if value is not None \
                    and isinstance(value, (ast.Dict, ast.DictComp)):
                names = ", ".join(getattr(t, "id", "?") for t in targets)
                yield self.diag(
                    mod, node,
                    f"module-level dict {names!r} in obs/ — counters "
                    f"go through MetricsRegistry, not bare module "
                    f"dicts")


@register
class PrintBanRule(Rule):
    """``print()`` outside cli.py / workloads / _reexec."""

    id = "print-ban"
    rationale = ("daemons and libraries report through the logger or "
                 "the metrics registry, never stdout")

    def select(self, mod: Module) -> bool:
        if not mod.rel.startswith("netsdb_tpu_torch/"):
            return False
        if mod.rel in _PRINT_EXEMPT:
            return False
        return not mod.rel.startswith(_PRINT_EXEMPT_DIRS)

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "print":
                yield self.diag(
                    mod, node,
                    "print() outside cli.py/workloads/ — use "
                    "utils.profiling.get_logger or a registry counter")


@register
class RowwiseShadowRule(Rule):
    """Manual ``rowwise=True`` declarations on Apply labels the
    derived registry already covers."""

    id = "rowwise-shadow"
    rationale = ("plan/computations.ROWWISE_SAFE_LABELS is the one "
                 "source of truth for the suite's audited "
                 "row-decomposable transforms; a per-node re-"
                 "declaration shadows it and drifts when the registry "
                 "is re-audited")

    def select(self, mod: Module) -> bool:
        return mod.rel.endswith(".py") \
            and not mod.rel.startswith("tests/fixtures/")

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        # the registry lives in a module that imports nothing heavy at
        # its top, so the lint process can read it
        from netsdb_tpu_torch.plan.computations import rowwise_safe

        for node in mod.walk():
            if not (isinstance(node, ast.Call)
                    and terminal_name(node.func) == "Apply"):
                continue
            kw = {k.arg: k.value for k in node.keywords
                  if k.arg is not None}
            rw = kw.get("rowwise")
            label = kw.get("label")
            if (isinstance(rw, ast.Constant) and rw.value is True
                    and isinstance(label, ast.Constant)
                    and isinstance(label.value, str)
                    and rowwise_safe(label.value)):
                yield self.diag(
                    mod, node,
                    f"rowwise=True on label {label.value!r} shadows "
                    f"the derived registry (plan/computations."
                    f"ROWWISE_SAFE_LABELS) — drop the argument; the "
                    f"declaration is auto-derived")


#: the two modules allowed to touch per-session device-cache state:
#: the owner (serve/sessions.py drives every install/update/spill
#: decision) and the cache that implements the primitives
_SESSION_STATE_EXEMPT = ("netsdb_tpu_torch/serve/sessions.py",
                         "netsdb_tpu_torch/storage/devcache.py")
#: the session-state mutators (devcache session API + spill wiring)
_SESSION_STATE_CALLS = ("session_put", "session_update",
                        "session_drop", "session_sweep",
                        "set_session_spill")


@register
class SessionStateMutationRule(Rule):
    """Per-session device-cache state mutated outside the session
    manager (breaks step-tag consistency and the TTL accounting)."""

    id = "session-state-mutation"
    rationale = ("session state carries step tags and TTL/LRU "
                 "accounting that only serve/sessions.py maintains "
                 "coherently; a stray session_put desyncs the "
                 "devcache copy from the arena spill and tears "
                 "revived state")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith("netsdb_tpu_torch/") \
            and mod.rel not in _SESSION_STATE_EXEMPT

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            name = None
            if isinstance(node, ast.Call):
                t = terminal_name(node.func)
                if t in _SESSION_STATE_CALLS:
                    name = t
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name in _SESSION_STATE_CALLS:
                        name = a.name
                        break
            if name:
                yield self.diag(
                    mod, node,
                    f"{name}() outside serve/sessions.py — session "
                    f"state mutations (step tags, TTL, spill wiring) "
                    f"are the session manager's alone; route through "
                    f"SessionManager so devcache and arena stay "
                    f"consistent")


@register
class QidMintRule(Rule):
    """``new_query_id`` outside obs/ (unsampled tracing on hot
    paths)."""

    id = "qid-mint"
    rationale = ("hot paths mint through obs.sample_qid so tracing "
                 "cost follows config.obs_trace_sample")

    def select(self, mod: Module) -> bool:
        return mod.rel.startswith("netsdb_tpu_torch/") \
            and not mod.rel.startswith(_OBS)

    def check_module(self, mod: Module) -> Iterable[Diagnostic]:
        for node in mod.walk():
            hit = False
            if isinstance(node, ast.Call):
                hit = terminal_name(node.func) == "new_query_id"
            elif isinstance(node, ast.ImportFrom):
                hit = any(a.name == "new_query_id" for a in node.names)
            if hit:
                yield self.diag(
                    mod, node,
                    "new_query_id outside obs/ — unsampled qid "
                    "minting pays full tracing per request; mint "
                    "through obs.sample_qid (config.obs_trace_sample)")
