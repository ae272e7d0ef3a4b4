"""The benchmark's yardstick: operation counts, device peaks and bounds.

Frozen here so that a change to the program cannot move them. The
counts are those of the port's ``workloads/transformer_bench.layer_flops``
and of the FF network's two products; the bounds are those the port's
kernel checks hold B1 to (``bounds_ms``, ``fold_bounds_ms``,
``attention_bound_ms``). Nothing here imports the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: NVIDIA H100 data-sheet peaks, dense (SXM part, at its 700 W limit):
#: FLOP/s by the type the products run in, and HBM bytes/s. "float32" is
#: the CUDA cores; "tf32" and "bfloat16" the tensor cores.
H100_SXM = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
            "bytes": 3.35e12}


def f32_accurate_peak(pk: dict) -> float:
    """The fastest rate at which a product keeps float32's accuracy:
    three-pass TF32 on the tensor cores, three tf32 products for each f32
    one. Whole-step shares of float32 configurations are taken against
    it, so that no route that keeps f32's accuracy can read above 100%."""
    return pk["tf32"] / 3.0


def ff_flops(rows: int, features: int, hidden: int, labels: int) -> float:
    """Product FLOPs of one FF inference over ``rows`` inputs:
    w1 · xᵀ (2·rows·features·hidden) and wo · y (2·rows·hidden·labels)."""
    return 2.0 * rows * features * hidden + 2.0 * rows * hidden * labels


def layer_flops(batch: int, seq: int, embed: int, heads: int,
                causal: bool = True, inner: Optional[int] = None) -> float:
    """Product FLOPs of one transformer layer forward: QKV (2·B·S·E·3E),
    attention (2·2·B·H·S·S·D, halved when causal), the out projection
    (2·B·S·E·E) and the MLP (2·2·B·S·E·I, I = ``inner``, 4E by
    default)."""
    d = embed // heads
    inner = 4 * embed if inner is None else inner
    attn = 2 * 2 * batch * heads * seq * seq * d * (0.5 if causal else 1)
    proj = 2 * batch * seq * embed * (3 * embed + embed)
    mlp = 2 * 2 * batch * seq * embed * inner
    return float(attn + proj + mlp)


def bounds_ms(flops: float, nbytes: float, dtype_name: str,
              pk: dict) -> Tuple[float, str]:
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    t_bytes = nbytes / pk["bytes"] * 1e3
    t_ops = flops / pk[dtype_name] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fold_bounds_ms(flops: float, nbytes: float, dtype_name: str,
                   pk: dict) -> Tuple[float, str, str, Optional[float]]:
    """(bound ms, what bounds it, the route it assumes, f32 CUDA-core
    bound ms or None) of the attention kernels, which run their products
    on the tensor cores: bf16 at its peak, f32 as three-pass TF32. The
    f32 figure on the CUDA cores is no bound of these kernels and is
    kept for reference."""
    if dtype_name != "float32":
        return bounds_ms(flops, nbytes, dtype_name, pk) + (
            f"{dtype_name} tensor cores", None)
    bound = bounds_ms(3 * flops, nbytes, "tf32", pk)
    return bound + ("three-pass tf32 tensor cores",
                    bounds_ms(flops, nbytes, dtype_name, pk)[0])


def attention_flops(b: int, h: int, s: int, d: int, causal: bool) -> float:
    """The score and P·V products over the (q, k) pairs the mask keeps:
    causal keeps s(s+1)/2 pairs a head."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * b * h * pairs * d


def attention_bound_ms(b: int, h: int, s: int, d: int, causal: bool,
                       dtype_name: str, pk: dict) -> tuple:
    """The least time for one attention forward: q, k, v read once and o
    written once, against the products over the pairs this mask keeps."""
    elem = 2 if dtype_name == "bfloat16" else 4
    return fold_bounds_ms(attention_flops(b, h, s, d, causal),
                          4.0 * b * h * s * d * elem, dtype_name, pk)
