"""Ahead-of-time exported programs — the port's ``netsdb_tpu/plan/aot.py``,
the PreCompiledWorkload cache made shippable.

The reference's master keeps physical plans per job name in memory so a
repeated workload skips planning (``src/queryPlanning/headers/
PreCompiledWorkload.h``). Two persistent layers stand in for it here:

1. the **kernel-library cache** (``config.enable_compilation_cache``):
   the hand-written CUDA kernels compile once per machine with nvcc into
   the ``compilation_cache_dir`` a ``Configuration`` names, so a fresh
   process given the same directory loads them and runs no nvcc. (CUDA
   graphs are objects of their process and are not persisted.)
2. **explicit export** (this module): a program traced with
   ``torch.export`` into an ``ExportedProgram`` and saved to a
   self-contained artifact that a later process loads and runs without
   the Python that built it — the shippable compiled plan.

The exported programs are the reference's: the FF forward and the fused
ten-query TPC-H suite. Neither reaches a hand-written kernel, whose
``ctypes`` launch ``torch.export`` cannot trace. ``BlockedTensor`` and
``FFParams`` are registered pytree nodes, so a program taking or
returning them exports and loads with its structure.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Callable, Dict

import torch
from torch.utils import _pytree as pytree


def _blocked_context(meta) -> str:
    return json.dumps({"shape": list(meta.shape),
                       "block_shape": list(meta.block_shape)})


def _register_pytree_nodes() -> None:
    """Teach ``torch.export`` the port's containers: a ``BlockedTensor``
    flattens to its data with its ``BlockMeta`` as context, ``FFParams``
    through its fields. Idempotent."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor, BlockMeta
    from netsdb_tpu_torch.models.ff import FFParams

    if BlockedTensor not in pytree.SUPPORTED_NODES:
        def from_context(blob):
            d = json.loads(blob)
            return BlockMeta(tuple(d["shape"]), tuple(d["block_shape"]))

        pytree.register_pytree_node(
            BlockedTensor,
            lambda b: ([b.data], b.meta),
            lambda children, meta: BlockedTensor(children[0], meta),
            serialized_type_name="netsdb_tpu_torch.BlockedTensor",
            flatten_with_keys_fn=lambda b: (
                [(pytree.GetAttrKey("data"), b.data)], b.meta),
            to_dumpable_context=_blocked_context,
            from_dumpable_context=from_context)
    if FFParams not in pytree.SUPPORTED_NODES:
        pytree.register_dataclass(
            FFParams, serialized_type_name="netsdb_tpu_torch.FFParams")


_register_pytree_nodes()


class _Wrapped(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_jitted(fn: Callable, *example_args) -> bytes:
    """Trace ``fn`` at the example arguments' shapes with
    ``torch.export`` and serialize the ``ExportedProgram`` into a
    portable blob (the device of the example arguments is baked in).
    A tensor passed twice is traced as two inputs: ``torch.export``
    would otherwise bake the aliasing into the program."""
    seen = set()

    def unalias(t):
        if isinstance(t, torch.Tensor):
            if id(t) in seen:
                return t.clone()
            seen.add(id(t))
        return t

    args = pytree.tree_map(unalias, tuple(example_args))
    with torch.inference_mode(False), torch.no_grad():
        ep = torch.export.export(_Wrapped(fn), args, strict=False)
    ep._example_inputs = None  # the artifact is the program, not its data
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_exported(path: str, fn: Callable, *example_args) -> str:
    blob = export_jitted(fn, *example_args)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def load_exported(path_or_blob) -> Callable:
    """Load an exported program; returns a callable taking the original
    example-argument structure."""
    if isinstance(path_or_blob, (bytes, bytearray)):
        blob = bytes(path_or_blob)
    else:
        with open(path_or_blob, "rb") as f:
            blob = f.read()
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(*args):
        with torch.no_grad():
            return module(*args)
    return call


# ------------------------------------------------ suite-level wrappers

def _suite_statics_digest(templates: Dict[str, list]) -> str:
    """Stable digest of the suite's NON-tensor (trace-time) arguments
    — dictionary codes, key spaces, join plans. The exported program
    baked these in, so a load against tables whose statics differ would
    silently compute wrong answers."""
    from netsdb_tpu_torch.relational.queries import _SLOT

    canon = {name: [repr(a) for a in t if a is not _SLOT]
             for name, t in templates.items()}
    return hashlib.sha256(json.dumps(canon, sort_keys=True).encode()
                          ).hexdigest()


def _suite_program(templates: Dict[str, list]) -> Callable:
    """The ten cores as one function of the suite's tensors."""
    from netsdb_tpu_torch.relational.queries import _SLOT, _SUITE_CORES

    def cores(arrays):
        out = {}
        for name, t in templates.items():
            it = iter(arrays[name])
            rebuilt = [next(it) if x is _SLOT else x for x in t]
            out[name] = _SUITE_CORES[name][0](*rebuilt)
        return out
    return cores


def export_tpch_suite(tables, path: str) -> str:
    """Export the ENTIRE ten-query TPC-H program
    (``relational.queries.compile_suite``) and serialize it — the whole
    benchmark suite as one shippable program. A sidecar ``<path>.meta``
    records the digest of the baked-in statics; the loader REQUIRES it,
    so ship both files together."""
    from netsdb_tpu_torch.relational.queries import compile_suite

    runner = compile_suite(tables)
    with open(path + ".meta", "w") as f:
        json.dump({"statics_digest":
                   _suite_statics_digest(runner.templates)}, f)
    return save_exported(path, _suite_program(runner.templates),
                         runner.arrays)


def load_tpch_suite(path: str, tables) -> Callable[[], Dict]:
    """Load a serialized suite and re-bind the CURRENT tables' tensors.

    The artifact fixes shapes/dtypes AND the data-dependent statics
    (dictionary codes, key spaces, planner join plans) that were baked
    at export; the loader recomputes them from ``tables`` and REFUSES
    tables whose statics differ — refreshed data must be
    statics-compatible, same as the reference re-running a precompiled
    plan against reloaded sets of the same schema. Fails CLOSED when
    the ``<path>.meta`` sidecar is missing or unreadable (without it
    compatibility cannot be proven, and a silent mismatch computes
    wrong answers)."""
    from netsdb_tpu_torch.relational.queries import suite_args_split

    call = load_exported(path)
    templates, arrays = suite_args_split(tables)
    try:
        with open(path + ".meta") as f:
            want = json.load(f)["statics_digest"]
    except (OSError, ValueError, KeyError) as e:
        raise ValueError(
            f"missing or unreadable statics sidecar {path + '.meta'} "
            "(exported suites must travel with it; re-export if lost)"
        ) from e
    if _suite_statics_digest(templates) != want:
        raise ValueError(
            "exported suite was compiled against different static "
            "arguments (dictionary codes / key spaces / join plans) "
            "than these tables produce; re-export for this data")
    return lambda: call(arrays)


def export_ff_inference(model, params, example_inputs, path: str) -> str:
    """Export the flagship FF forward (the ``graft_entry.entry``
    surface) and serialize it."""
    return save_exported(path, model.forward, params, example_inputs)
