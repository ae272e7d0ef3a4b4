"""Whether what the timed path produced is correct.

The window keeps a sample of its requests' outputs, drawn from the seed
(a reservoir, so every request of the window is as likely to be kept).
Once the window has closed and the program's state is freed, the kind's
plain reference runs in float64 over each input set a kept request
read, from the weights and inputs the harness made, and each kept output
is held to it. The numbers compared, each with its limit from the
cell's file (``workloads/<cell>.json``):

- ``max_abs_err``: the largest absolute difference between a kept
  output and the reference, over all kept outputs (a wrong shape or a
  value that is not finite reads infinite);
- ``failed``: requests of the window that raised (limit 0).
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Tuple

import torch


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: List[object] = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def max_abs_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref|; infinite for a wrong shape or a value that is not
    finite."""
    if tuple(got.shape) != tuple(ref.shape):
        return math.inf
    diff = (got.to(ref.dtype) - ref).abs()
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    return float(diff.max())


def readings(kept: List[Tuple[int, object]],
             dense: Callable[[object], torch.Tensor],
             reference: Callable[[int], torch.Tensor]) -> Dict[str, float]:
    """``kept`` is ``(input set, output)`` pairs; ``reference(i)`` the
    float64 reference over input set ``i`` (computed once a set). No
    kept output reads infinite."""
    if not kept:
        return {"max_abs_err": math.inf}
    refs: Dict[int, torch.Tensor] = {}
    worst = 0.0
    for i, out in kept:
        if i not in refs:
            refs[i] = reference(i)
        worst = max(worst, max_abs_err(dense(out), refs[i]))
    return {"max_abs_err": worst}


def verdict(values: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, checks): every number at or under its limit; ``checks``
    maps each number's name to its value and limit."""
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
