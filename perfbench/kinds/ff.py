"""netsDB's FF classifier: features → hidden (ReLU) → labels (softmax).

The inference of ``ff::inference_unit`` in netsDB's
``src/FF/source/SimpleFF.cc``: y1 = relu(w1·xᵀ + b1), yo = wo·y1 + bo,
softmax over the labels. Inputs are (rows × features), weights
(out × in), the output (labels × rows).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import arithmetic
from perfbench.kinds import precision

UNIT = "rows"
WEIGHTS = ("w1", "b1", "wo", "bo")


def make_data(config: dict, shape: dict, input_sets: int, seed: int,
              device) -> Dict[str, object]:
    """Weights and ``input_sets`` input batches of ``shape["rows"]`` rows,
    drawn on ``device`` from one generator seeded with ``seed``, in a
    fixed order and in the configuration's type (float32). The weights
    are scaled as netsDB's FFTest draws them (He for the products,
    0.01 for the biases)."""
    f, h, n = config["features"], config["hidden"], config["labels"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=g, device=device,
                           dtype=torch.float32)

    weights = {"w1": randn(h, f) * (2.0 / f) ** 0.5,
               "b1": randn(h) * 0.01,
               "wo": randn(n, h) * (2.0 / h) ** 0.5,
               "bo": randn(n) * 0.01}
    inputs = [randn(shape["rows"], f) for _ in range(input_sets)]
    return {"weights": weights, "inputs": inputs}


def units_per_request(shape: dict) -> int:
    return int(shape["rows"])


def flops_per_request(config: dict, shape: dict) -> float:
    return arithmetic.ff_flops(shape["rows"], config["features"],
                               config["hidden"], config["labels"])


def reference(config: dict, weights: Dict[str, torch.Tensor],
              x: torch.Tensor, mode: str = "f64",
              block_rows: int = 4096) -> torch.Tensor:
    """The network over ``x`` (rows × features) in ``mode``, a block of
    rows at a time: (labels × rows) probabilities, in float64 for
    ``"f64"`` and float32 otherwise."""
    dt = precision.dtype_of(mode)
    w1, b1, wo, bo = (weights[k].to(dt) for k in WEIGHTS)
    cols: List[torch.Tensor] = []
    with precision.products(mode), torch.no_grad():
        for start in range(0, x.shape[0], block_rows):
            xb = x[start:start + block_rows].to(dt)
            y1 = torch.relu(precision.mm(w1, xb.t(), mode) + b1[:, None])
            yo = precision.mm(wo, y1, mode) + bo[:, None]
            cols.append(torch.softmax(yo, dim=0))
    return torch.cat(cols, dim=1)
