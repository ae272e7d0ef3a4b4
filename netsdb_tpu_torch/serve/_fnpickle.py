"""Function pickling for the pickle codec — the port's own stand-in for
the part of ``cloudpickle`` that shipping a computation DAG needs, built
on the standard library's :class:`pickle.Pickler` and its
``reducer_override`` hook.

* A function that its module exports under its qualified name (and
  whose module is not ``__main__``) is pickled by reference, as plain
  pickle does.
* Any other function — a lambda, a nested function, a closure, a
  function of ``__main__`` — is pickled by value: its code object
  through :mod:`marshal`, its defaults and keyword defaults, its closure
  cells (a cell may hold the function itself: the function is created
  with empty cells, memoised, and its cells filled afterwards), the
  globals its code and its nested code objects name, and its
  ``__dict__``.
* A module is pickled by reference (its import name).

Everything else is plain pickle: a ``torch.Tensor`` keeps its dtype and
its device. :mod:`marshal`'s code format belongs to one interpreter
version: every function pickled by value carries :data:`PY_TAG` and
loading it under another tag raises ``pickle.UnpicklingError``. The
wire handshake checks the same tag before it allows this codec at all
(``serve/protocol.py``).

Loading runs code: the pickle codec is for trusted peers only, exactly
like the reference's."""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any, Dict, Set

#: the interpreter whose code objects :mod:`marshal` writes here
PY_TAG = f"{sys.implementation.name}-{sys.version_info[0]}." \
         f"{sys.version_info[1]}"

_EMPTY = object()  # an unbound closure cell


def _by_reference(fn: types.FunctionType) -> bool:
    mod_name = getattr(fn, "__module__", None)
    if not mod_name or mod_name == "__main__":
        return False
    mod = sys.modules.get(mod_name)
    if mod is None:
        return False
    obj: Any = mod
    for part in fn.__qualname__.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return False
    return obj is fn


def _global_names(code: types.CodeType, out: Set[str]) -> Set[str]:
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _global_names(const, out)
    return out


def _make_function(tag: str, code_bytes: bytes, name: str, qualname: str,
                   module: str, ncells: int) -> types.FunctionType:
    if tag != PY_TAG:
        raise pickle.UnpicklingError(
            f"a function pickled by value under {tag} cannot load under "
            f"{PY_TAG}: marshal's code format differs between interpreter "
            f"versions")
    code = marshal.loads(code_bytes)
    g: Dict[str, Any] = {"__builtins__": builtins, "__name__": module}
    closure = tuple(types.CellType() for _ in range(ncells)) or None
    fn = types.FunctionType(code, g, name, None, closure)
    fn.__qualname__ = qualname
    fn.__module__ = module
    return fn


def _fill_function(fn: types.FunctionType, state: Dict[str, Any]) -> None:
    fn.__globals__.update(state["globals"])
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__doc__ = state["doc"]
    fn.__dict__.update(state["dict"])
    for cell, value in zip(fn.__closure__ or (), state["cells"]):
        if value is not _EMPTY:
            cell.cell_contents = value


def _empty_cell_marker():
    return _EMPTY


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType) and not _by_reference(obj):
            return self._reduce_function(obj)
        if isinstance(obj, types.ModuleType):
            return importlib.import_module, (obj.__name__,)
        if obj is _EMPTY:
            return _empty_cell_marker, ()
        return NotImplemented

    @staticmethod
    def _reduce_function(fn: types.FunctionType):
        code = fn.__code__
        cells = []
        for cell in fn.__closure__ or ():
            try:
                cells.append(cell.cell_contents)
            except ValueError:
                cells.append(_EMPTY)
        names = _global_names(code, set())
        g = {k: fn.__globals__[k] for k in sorted(names)
             if k in fn.__globals__}
        state = {"globals": g, "defaults": fn.__defaults__,
                 "kwdefaults": fn.__kwdefaults__, "doc": fn.__doc__,
                 "dict": dict(fn.__dict__), "cells": cells}
        args = (PY_TAG, marshal.dumps(code), fn.__name__, fn.__qualname__,
                fn.__module__ or "__main__", len(cells))
        return _make_function, args, state, None, None, _fill_function


def dumps(obj: Any, protocol: int = pickle.HIGHEST_PROTOCOL) -> bytes:
    """``obj`` pickled, with functions that cannot be imported by name
    pickled by value."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


def loads(blob) -> Any:
    """The inverse of :func:`dumps` (plain :func:`pickle.loads`)."""
    return pickle.loads(blob)
