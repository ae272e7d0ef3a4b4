"""Feed-forward NN inference in the database — counterpart of
``netsdb_tpu/models/ff.py`` (the reference FF application,
``src/FF/source/SimpleFF.cc``, driver ``src/tests/source/FFTest.cc``).

- ``setup`` ≙ ``ff::setup`` + ``ff::createSet`` of {inputs, w1, b1, wo,
  bo, y1, yo, output};
- ``load_random_weights`` ≙ ``ff::loadMatrix``, drawing from the same
  numpy seed path as the JAX package so both hold the same weights;
- ``inference`` ≙ ``ff::inference_unit``:
  y1 = relu(w1·inputsᵀ + b1); yo = wo·y1 + bo; softmax over labels.

Layout follows the reference: inputs are (batch x features), weights
(out x in), activations flow as (features x batch). Weight sets created ``storage="paged"`` stream
through the same DAG page by page (``TensorFold`` on the two weight
joins). ``loss``/``train_step`` are the reference's training extension
(masked softmax cross-entropy, SGD), differentiated by autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models._common import sgd_step
from netsdb_tpu_torch.ops import nn as nn_ops
from netsdb_tpu_torch.ops.matmul import matmul, matmul_t
from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import TensorFold


@dataclasses.dataclass
class FFParams:
    w1: BlockedTensor  # (hidden x features)
    b1: BlockedTensor  # (hidden x 1)
    wo: BlockedTensor  # (labels x hidden)
    bo: BlockedTensor  # (labels x 1)


class FFModel:
    """One-hidden-layer FF classifier stored as database sets."""

    SETS = ("inputs", "w1", "b1", "wo", "bo", "y1", "yo", "output")

    def __init__(self, db: str = "ff", block: Tuple[int, int] = (512, 512),
                 compute_dtype: Optional[str] = None):
        self.db = db
        self.block = block
        self.compute_dtype = compute_dtype

    def setup(self, client, placements: Optional[Dict[str, object]] = None,
              storages: Optional[Dict[str, str]] = None) -> None:
        """Create the model's database and sets. ``placements`` maps a
        set name to its Placement; ``storages`` maps a set name to
        "memory" or "paged": a paged weight set lives as arena pages and
        streams through the inference DAG (the reference's page-fed
        weight scans, ``SimpleFF.cc:94-290``)."""
        client.create_database(self.db)
        for s in self.SETS:
            client.create_set(self.db, s,
                              placement=(placements or {}).get(s),
                              storage=(storages or {}).get(s, "memory"))
        client.register_type("FFMatrixBlock",
                             "netsdb_tpu_torch.core.blocked:BlockedTensor")
        # a w1 set already loaded fixes the block shape the model uses (a
        # RemoteClient has no local catalog: the daemon decides there)
        catalog = getattr(client, "catalog", None)
        placed = (catalog.get_set(self.db, "w1") or {}).get(
            "meta", {}).get("block_shape") if catalog is not None else None
        if placed:
            self.block = tuple(placed)

    def load_weights(self, client, w1, b1, wo, bo) -> None:
        br = self.block[0]
        client.send_matrix(self.db, "w1", w1, self.block)
        client.send_matrix(self.db, "b1", np.asarray(b1).reshape(-1, 1),
                           (br, 1))
        client.send_matrix(self.db, "wo", wo, self.block)
        client.send_matrix(self.db, "bo", np.asarray(bo).reshape(-1, 1),
                           (br, 1))

    def load_random_weights(self, client, features: int, hidden: int,
                            labels: int, seed: int = 0) -> None:
        """ref ff::loadMatrix with random data (FFTest.cc:100-117); the
        draws are the JAX package's, in the same order."""
        rng = np.random.default_rng(seed)
        scale1 = np.sqrt(2.0 / features)
        scale2 = np.sqrt(2.0 / hidden)
        self.load_weights(
            client,
            rng.standard_normal((hidden, features), dtype=np.float32) * scale1,
            rng.standard_normal((hidden,), dtype=np.float32) * 0.01,
            rng.standard_normal((labels, hidden), dtype=np.float32) * scale2,
            rng.standard_normal((labels,), dtype=np.float32) * 0.01,
        )

    def load_inputs(self, client, inputs) -> None:
        client.send_matrix(self.db, "inputs", inputs, self.block)

    # --- inference (ref ff::inference_unit, SimpleFF.cc:331-424) ------
    def build_inference_dag(self, dropout_rate: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            input_set: str = "inputs",
                            output_set: str = "output") -> WriteSet:
        """Computation DAG with the reference's relational shape.
        ``input_set``/``output_set`` let several callers share the
        resident weight sets while scanning and writing private sets."""
        cd = self.compute_dtype
        inputs = ScanSet(self.db, input_set)
        w1 = ScanSet(self.db, "w1")
        b1 = ScanSet(self.db, "b1")
        wo = ScanSet(self.db, "wo")
        bo = ScanSet(self.db, "bo")
        # both weight products are row-decomposable in the weight: a
        # paged weight set streams its row blocks through the same fn and
        # the output rows are concatenated (out_block gives the result
        # the resident path's blocks); resident sets ignore the fold
        # the SUMMA declarations (fn(block, x) == block @ rhs(x)) route
        # both weight streams through the distributed matmul under
        # config.distributed_matmul — declared only under full-precision
        # compute: SUMMA's panel accumulation reassociates the contraction
        # (exact for integer-valued f32 operands, last-ulp otherwise)
        wfold = TensorFold(mode="rows",
                           out_block=(self.block[0], self.block[0]),
                           summa_rhs=(lambda x: x.to_dense().t())
                           if cd is None else None)
        rfold = TensorFold(mode="rows",
                           out_block=(self.block[0], self.block[0]),
                           summa_rhs=(lambda y: y.to_dense())
                           if cd is None else None)
        # FFTransposeMult + FFAggMatrix: w1 · inputsᵀ → (hidden x batch)
        h = Join(w1, inputs, fn=lambda w, x: matmul_t(w, x, cd,
                                                      accum_dtype=cd),
                 label="FFTransposeMult", tensor_fold=wfold)
        y1 = Join(h, b1, fn=lambda hh, bb: nn_ops.bias_relu(
            hh, bb, dropout_rate, generator), label="FFReluBiasSum")
        # FFInputLayerJoin + FFAggMatrix: wo · y1 → (labels x batch)
        yo_lin = Join(wo, y1, fn=lambda w, y: matmul(w, y, cd),
                      label="FFInputLayerJoin", tensor_fold=rfold)
        # FFTransposeBiasSum → FFRowAggregate → FFOutputLayer, fused
        out = Join(yo_lin, bo,
                   fn=lambda y, b: nn_ops.ff_output_layer(y, b, axis=0),
                   label="FFOutputLayer")
        return WriteSet(out, self.db, output_set)

    def inference(self, client, dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> BlockedTensor:
        sink = self.build_inference_dag(dropout_rate, generator)
        results = client.execute_computations(
            sink, job_name=f"{self.db}-inference")
        return next(iter(results.values()))

    def build_fused_inference_dag(self, params: FFParams,
                                  out_mode: str = "softmax") -> WriteSet:
        """The whole network inside ONE computation — the reference's
        ``src/FF_proj`` variant. ``out_mode="label"`` is FF_proj's head
        (sigmoid, then the 0.5 threshold); "softmax" the standard tail."""
        if out_mode not in ("softmax", "label"):
            raise ValueError(
                f"out_mode must be 'softmax' or 'label', got {out_mode!r}")
        cd = self.compute_dtype

        def whole_network(x: BlockedTensor) -> BlockedTensor:
            h = nn_ops.bias_relu(matmul_t(params.w1, x, cd, accum_dtype=cd),
                                 params.b1)
            yo = matmul(params.wo, h, cd)
            if out_mode == "label":
                p = nn_ops.bias_sigmoid(yo, params.bo)
                # margins are sigmoid-remasked to 0, so they stay 0
                return p.with_data((p.data > 0.5).to(p.data.dtype))
            return nn_ops.ff_output_layer(yo, params.bo, axis=0)

        net = Apply(ScanSet(self.db, "inputs"), whole_network,
                    label="FullyConnectedNetwork")
        return WriteSet(net, self.db, "output")

    def inference_fused(self, client,
                        out_mode: str = "softmax") -> BlockedTensor:
        """FF_proj-style single-UDF inference over the stored weights."""
        sink = self.build_fused_inference_dag(self.params_from_store(client),
                                              out_mode)
        results = client.execute_computations(
            sink, job_name=f"{self.db}-inference-fused-{out_mode}")
        return next(iter(results.values()))

    # --- pure-function forms ------------------------------------------
    def params_from_store(self, client) -> FFParams:
        return FFParams(w1=client.get_tensor(self.db, "w1"),
                        b1=client.get_tensor(self.db, "b1"),
                        wo=client.get_tensor(self.db, "wo"),
                        bo=client.get_tensor(self.db, "bo"))

    def forward(self, params: FFParams,
                inputs: BlockedTensor) -> BlockedTensor:
        """(batch x features) → softmax probs (labels x batch), the DAG's
        math as one function. Under ``compute_dtype`` the hidden
        activation stays in that dtype; the output layer accumulates f32."""
        return nn_ops.ff_output_layer(self.logits(params, inputs),
                                      params.bo, axis=0)

    def logits(self, params: FFParams,
               inputs: BlockedTensor) -> BlockedTensor:
        cd = self.compute_dtype
        h = nn_ops.bias_relu(matmul_t(params.w1, inputs, cd, accum_dtype=cd),
                             params.b1)
        return matmul(params.wo, h, cd)

    # --- training (the reference's extension, models/ff.py:251-267) ----
    def loss(self, params: FFParams, inputs: BlockedTensor,
             labels_onehot: BlockedTensor) -> torch.Tensor:
        """Masked softmax cross-entropy over the labels axis, summed and
        divided by the logical batch. ``labels_onehot`` is (labels x
        batch), blocked like the output. Padded batch columns are masked
        whole: their log-softmax is NaN and reads 0, with no gradient."""
        lg = self.logits(params, inputs)
        masked = torch.where(lg.mask(torch.bool), lg.data,
                             torch.full((), float("-inf"), dtype=lg.dtype,
                                        device=lg.device))
        logp = torch.nan_to_num(torch.log_softmax(masked, dim=0), nan=0.0,
                                neginf=0.0)
        return -(labels_onehot.data * logp).sum() / inputs.shape[0]

    def train_step(self, params: FFParams, inputs: BlockedTensor,
                   labels_onehot: BlockedTensor,
                   lr: float = 0.1) -> Tuple[FFParams, torch.Tensor]:
        """One SGD step over the whole padded data of every param;
        returns ``(new params, loss)``."""
        return sgd_step(self.loss, params, lr, inputs, labels_onehot)
