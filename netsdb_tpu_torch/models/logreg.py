"""Logistic regression in the database — counterpart of
``netsdb_tpu/models/logreg.py`` (the reference LogReg workload,
``src/LogReg/headers/Logistic_Regression.h``, test program
``src/tests/source/LogisticRegressionTest.cc``), which reuses the FF
operator family: one ``FFTransposeMult`` product, then
``FFTransposeBiasSumSigmoid``. ``loss``/``train_step`` are the
reference's training (stable binary cross-entropy, SGD), differentiated
by autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models._common import (as_f32, create_sets, rows_like,
                                             sgd_step)
from netsdb_tpu_torch.ops import nn as nn_ops
from netsdb_tpu_torch.ops.matmul import matmul_t
from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet


@dataclasses.dataclass
class LogRegParams:
    w: BlockedTensor  # (1 x features) — a single-row blocked matrix
    b: BlockedTensor  # (1 x 1)


class LogRegModel:
    SETS = ("inputs", "w", "b", "output")

    def __init__(self, db: str = "logreg", block: Tuple[int, int] = (512, 512),
                 compute_dtype: Optional[str] = None):
        self.db = db
        self.block = block
        self.compute_dtype = compute_dtype

    def setup(self, client, placements=None) -> None:
        """Create the database and its sets; ``placements`` maps a set
        name to its Placement (the inference DAG runs over the placed
        sets through the same ``execute_computations``)."""
        create_sets(client, self.db, self.SETS, placements)

    def load_weights(self, client, w, b: float) -> None:
        client.send_matrix(self.db, "w", as_f32(w).reshape(1, -1),
                           (1, self.block[1]))
        client.send_matrix(self.db, "b", np.asarray([[b]], dtype=np.float32),
                           (1, 1))

    def load_inputs(self, client, x) -> None:
        client.send_matrix(self.db, "inputs", x, self.block)

    def build_inference_dag(self) -> WriteSet:
        cd = self.compute_dtype
        w = ScanSet(self.db, "w")
        x = ScanSet(self.db, "inputs")
        b = ScanSet(self.db, "b")
        z = Join(w, x, fn=lambda ww, xx: matmul_t(ww, xx, cd),
                 label="FFTransposeMult")
        out = Join(z, b, fn=nn_ops.bias_sigmoid,
                   label="FFTransposeBiasSumSigmoid")
        return WriteSet(out, self.db, "output")

    def inference(self, client) -> BlockedTensor:
        """Probabilities (1 x batch)."""
        res = client.execute_computations(self.build_inference_dag(),
                                          job_name=f"{self.db}-inference")
        return next(iter(res.values()))

    # --- pure forms ---------------------------------------------------
    def params_from_store(self, client) -> LogRegParams:
        return LogRegParams(w=client.get_tensor(self.db, "w"),
                            b=client.get_tensor(self.db, "b"))

    def forward(self, params: LogRegParams, x: BlockedTensor) -> BlockedTensor:
        z = matmul_t(params.w, x, self.compute_dtype)
        return nn_ops.bias_sigmoid(z, params.b)

    # --- training (models/logreg.py:87-100 of the reference) -----------
    def loss(self, params: LogRegParams, x: BlockedTensor,
             y) -> torch.Tensor:
        """Binary cross-entropy in its stable form, ``max(z, 0) - z·y +
        log1p(exp(-|z|))``, averaged over the batch; ``y`` is (batch,) in
        {0, 1}, or those values as a 1-d BlockedTensor (``rows_like``)."""
        z = matmul_t(params.w, x, self.compute_dtype)
        logits = z.to_dense().reshape(-1) + params.b.data[0, 0]
        if isinstance(y, BlockedTensor):
            y = y.to_dense()
        y = torch.as_tensor(y, dtype=logits.dtype, device=logits.device)
        return torch.mean(torch.clamp_min(logits, 0) - logits * y
                          + torch.log1p(torch.exp(-logits.abs())))

    def train_step(self, params: LogRegParams, x: BlockedTensor, y,
                   lr: float = 0.5) -> Tuple[LogRegParams, torch.Tensor]:
        """One SGD step over w's and b's padded data; returns ``(new
        params, loss)``. Over a placed ``x`` the labels are laid out like
        its rows, so a data-parallel step gives each position its own."""
        if not isinstance(y, BlockedTensor) and not isinstance(
                x.data, torch.Tensor):
            y = rows_like(y, x)
        return sgd_step(self.loss, params, lr, x, y)
