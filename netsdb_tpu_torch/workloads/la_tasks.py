"""The headline LA tasks — counterpart of
``netsdb_tpu/workloads/la_tasks.py``: the only end-to-end numbers
netsDB itself published (reference ``selfLearning/documentation.md:5-10``,
``BASELINE.md`` rows 1-3):

    Gram matrix        X: 200000 x 1000 (1000 x 1000 blocks), G = Xᵀ X
    Linear regression  the same X, ridge normal equations
    Matrix multiply    C = X · W (W: 1000 x 1000)

Each task is a PDML program evaluated over the port's op layer with its
inputs bound in the interpreter's environment as device-resident
``BlockedTensor`` s — the "data already in sets" starting point of the
reference's timings. As the reference traces the whole program into one
jitted XLA program, :func:`compile_pdml` makes it one program of the
executor's compiled-program cache (``plan/executor.run_program``): one
CUDA graph per input signature on the card, replayed after its first
request. :func:`run_task` times requests with CUDA events on the card (a
host clock on the CPU, and says which).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockMeta, BlockedTensor
from netsdb_tpu_torch.dsl.interp import LAInterpreter
from netsdb_tpu_torch.dsl.parser import parse_program
from netsdb_tpu_torch.ops.common import remask

# The reference's own end-to-end seconds on its C++ cluster
# (selfLearning/documentation.md:5-10): "plain" without self-learning,
# "best" the best self-learning run. Not numbers of any card.
REFERENCE_SECONDS = {
    "gram": {"plain": 41.27, "best": 22.78},
    "linreg": {"plain": 83.45, "best": 43.91},
    "matmul": {"plain": 42.21, "best": 11.41},
}

# LAMI = lambda * I is bound with the inputs (PDML has no scalar literals
# in expressions; the reference's test programs load pre-scaled matrices)
PROGRAMS = {
    "gram": "G = X '* X",
    "linreg": "w = (X '* X + LAMI) ^-1 %*% (X '* y)",
    "matmul": "C = X %*% W",
}

TASKS = tuple(PROGRAMS)


def compile_pdml(text: str) -> Callable[[Dict[str, BlockedTensor]],
                                        Dict[str, BlockedTensor]]:
    """Parse a PDML program once; returns ``run(env) -> {target: value}``
    for each statement, the whole program one program of the compiled
    cache (key ``pdml::<text>``), evaluated over the inputs bound in
    ``env`` on their device. The bound inputs are read in place: a
    caller that rewrites one in place must bind a new tensor instead."""
    from netsdb_tpu_torch.plan.executor import run_program

    stmts = parse_program(text)

    def run(env: Dict[str, BlockedTensor]) -> Dict[str, BlockedTensor]:
        device = next(iter(env.values())).device if env else None
        interp = LAInterpreter(device=device)
        interp.env.update(env)
        for stmt in stmts:
            interp.execute(stmt)
        return {stmt.target: interp.env[stmt.target] for stmt in stmts}

    def compiled(env: Dict[str, BlockedTensor]) -> Dict[str, BlockedTensor]:
        return run_program(f"pdml::{text}", run, env, ref_args=(0,))

    return compiled


def make_inputs(task: str, rows: int, cols: int, block: int,
                lam: float = 1.0, dtype=torch.float32, seed: int = 0,
                device=None) -> Dict[str, BlockedTensor]:
    """The task's inputs drawn on ``device`` (CUDA unless the caller asks
    for another) from a seeded ``torch.Generator``, with zero margins."""
    if task not in PROGRAMS:
        raise ValueError(f"unknown task {task!r}; have {TASKS}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, block_shape):
        meta = BlockMeta(shape, block_shape)
        data = torch.randn(meta.padded_shape, generator=gen, dtype=dtype,
                           device=device)
        return remask(BlockedTensor(data, meta))

    env = {"X": randn((rows, cols), (block, block))}
    if task == "linreg":
        env["y"] = randn((rows, 1), (block, 1))
        eye = torch.eye(cols, dtype=dtype, device=device) * lam
        env["LAMI"] = BlockedTensor.from_dense(eye, (block, block),
                                               dtype=dtype, device=device)
    elif task == "matmul":
        env["W"] = randn((cols, cols), (block, block))
    return env


def _timed_ms(fn, env, device: torch.device) -> float:
    """One request's milliseconds: CUDA events on the card, the host
    clock (around the whole call) on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(env)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn(env)
    return (time.perf_counter() - t0) * 1e3


def run_task(task: str, rows: int = 200000, cols: int = 1000,
             block: int = 1000, iters: int = 5, lam: float = 1.0,
             dtype=torch.float32, seed: int = 0, device=None) -> Dict:
    """Time ``iters`` requests of one task after a first one; returns the
    times with the device they ran on and the reference's cluster
    seconds beside them."""
    env = make_inputs(task, rows, cols, block, lam, dtype, seed, device)
    device = env["X"].device
    fn = compile_pdml(PROGRAMS[task])
    first = _timed_ms(fn, env, device)
    times = [_timed_ms(fn, env, device) for _ in range(iters)]
    return {"task": task, "rows": rows, "cols": cols, "block": block,
            "dtype": str(dtype).replace("torch.", ""),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
            "timer": "cuda events" if device.type == "cuda" else "host clock",
            "first_ms": first, "ms": times,
            "ms_p50": sorted(times)[len(times) // 2], "ms_min": min(times),
            "reference_cluster_seconds": REFERENCE_SECONDS[task]}


def run_all(rows: int = 200000, cols: int = 1000, block: int = 1000,
            iters: int = 5, device=None) -> Dict[str, Dict]:
    return {t: run_task(t, rows, cols, block, iters, device=device)
            for t in TASKS}
