"""LSTM cell serving in the database — counterpart of
``netsdb_tpu/models/lstm_model.py`` (the reference LSTM workload,
``src/tests/source/LSTMTest.cc``): twelve weight sets (w/u per gate plus
biases), input and state sets, one cell step as 8 matmuls and the gate
fusions. ``step`` writes the new state through the store as the
reference test program does per timestep; ``run_sequence`` loops the
cell over a sequence (``ops.lstm.lstm_unroll``) as one program of the
executor's compiled-program cache (``lstm::<db>::<compute dtype>``: one
CUDA graph per sequence shape on the card, the stored weights and state
read in place), as the reference runs it as one ``lax.scan``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models._common import as_f32, create_sets
from netsdb_tpu_torch.ops.lstm import LSTMParams, lstm_cell, lstm_unroll
from netsdb_tpu_torch.storage.store import SetIdentifier

_GATES = ("i", "f", "c", "o")


class LSTMModel:
    def __init__(self, db: str = "lstm", block: Tuple[int, int] = (512, 512),
                 compute_dtype: Optional[str] = None):
        self.db = db
        self.block = block
        self.compute_dtype = compute_dtype

    @property
    def weight_sets(self):
        return ([f"w_{g}" for g in _GATES] + [f"u_{g}" for g in _GATES]
                + [f"b_{g}" for g in _GATES])

    def setup(self, client, placements=None) -> None:
        """Create the database, the 12 weight sets and the state sets;
        ``placements`` maps a set name to its Placement (the cell then runs
        by the placed-op rule, ``parallel/placed_ops``)."""
        create_sets(client, self.db,
                    self.weight_sets + ["x", "h", "c", "h_out", "c_out"],
                    placements)

    def load_weights(self, client, weights: dict) -> None:
        """``weights``: {'w_i': (hidden x input), ..., 'b_i': (hidden,)}."""
        for g in _GATES:
            client.send_matrix(self.db, f"w_{g}", weights[f"w_{g}"], self.block)
            client.send_matrix(self.db, f"u_{g}", weights[f"u_{g}"], self.block)
            b = as_f32(weights[f"b_{g}"]).reshape(-1, 1)
            client.send_matrix(self.db, f"b_{g}", b, (self.block[0], 1))

    def load_state(self, client, h, c) -> None:
        client.send_matrix(self.db, "h", h, self.block)
        client.send_matrix(self.db, "c", c, self.block)

    def params_from_store(self, client) -> LSTMParams:
        return LSTMParams(**{name: client.get_tensor(self.db, name)
                             for name in self.weight_sets})

    def step(self, client, x) -> Tuple[BlockedTensor, BlockedTensor]:
        """One cell step from the stored state; writes the h_out and c_out
        sets (LSTMTest.cc's per-step executeComputations)."""
        params = self.params_from_store(client)
        xb = BlockedTensor.from_dense(as_f32(x), self.block,
                                      dtype=torch.float32,
                                      device=client.device)
        h = client.get_tensor(self.db, "h")
        c = client.get_tensor(self.db, "c")
        h2, c2 = lstm_cell(params, xb, h, c, self.compute_dtype)
        client.store.put_tensor(SetIdentifier(self.db, "h_out"), h2)
        client.store.put_tensor(SetIdentifier(self.db, "c_out"), c2)
        return h2, c2

    def run_sequence(self, client, xs):
        """``xs``: (T, input, batch) → (h_T, c_T, every h), from the stored
        state."""
        params = self.params_from_store(client)
        h = client.get_tensor(self.db, "h")
        c = client.get_tensor(self.db, "c")
        # x's row blocking must match w's COLUMN blocking (x rows are the
        # contraction dim of w·x), and its column blocking h's
        x_block = (self.block[1], self.block[1])
        xs = as_f32(xs)
        xs_padded = torch.stack([
            BlockedTensor.from_dense(xs[t], x_block, dtype=torch.float32,
                                     device=client.device).data
            for t in range(xs.shape[0])])
        from netsdb_tpu_torch.plan.executor import run_program

        with torch.inference_mode():
            return run_program(f"lstm::{self.db}::{self.compute_dtype}",
                               lstm_unroll, params, xs_padded, h, c,
                               self.compute_dtype, ref_args=(0, 2, 3))
