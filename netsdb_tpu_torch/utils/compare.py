"""Structural result comparison — the port's
``netsdb_tpu/utils/compare.py``: one definition of "two results agree"
for nested results."""

from __future__ import annotations


def structurally_close(a, b, rtol: float = 2e-4, atol: float = 2e-3) -> bool:
    """Recursive equality over dict/list/tuple structures with a float
    tolerance at the leaves (f32 device results against f64 host
    references)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(
            structurally_close(a[k], b[k], rtol, atol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            structurally_close(x, y, rtol, atol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= max(rtol * abs(float(b)), atol)
    return a == b
