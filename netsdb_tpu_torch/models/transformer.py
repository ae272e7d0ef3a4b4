"""Transformer layer serving — counterpart of
``netsdb_tpu/models/transformer.py``.

A transformer block whose weights live in database sets like every
other model's, run through the same Computation DAG. Layer = pre-LN MHA
+ residual, pre-LN MLP (gelu) + residual; x is (batch, seq, embed). On a
Hopper card the attention core is the hand-written CUDA flash kernel
(``ops.attention.attention_dispatch``). The sequence-parallel forward,
the staged (paged-weight) DAG and training are ROADMAP.md A4, A2, A3.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from netsdb_tpu_torch.ops.attention import mha_forward
from netsdb_tpu_torch.ops.common import hi_einsum
from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet


@dataclasses.dataclass
class TransformerLayerParams:
    w_qkv: torch.Tensor   # (E, 3E)
    w_out: torch.Tensor   # (E, E)
    w_up: torch.Tensor    # (E, 4E)
    w_down: torch.Tensor  # (4E, E)


def _no_placement(placement) -> None:
    if placement is not None:
        raise NotImplementedError(
            "placed (sequence-sharded) transformer inputs and the "
            "ring-attention forward are not ported yet: ROADMAP.md A4")


class TransformerLayerModel:
    SETS = ("w_qkv", "w_out", "w_up", "w_down")

    def __init__(self, db: str = "transformer", num_heads: int = 8):
        self.db = db
        self.num_heads = num_heads

    def setup(self, client, placements=None, storages=None) -> None:
        """Create the weight sets. ``placements`` and ``storages="paged"``
        entries reach ``create_set``, which raises
        ``NotImplementedError`` for them in this slice."""
        client.create_database(self.db)
        for s in self.SETS:
            client.create_set(self.db, s,
                              placement=(placements or {}).get(s),
                              storage=(storages or {}).get(s, "memory"))

    def load_random_weights(self, client, embed: int, seed: int = 0) -> None:
        """The JAX package's draws, in the same order, so both packages
        hold the same weights; each set is blocked
        (min(512, rows), min(512, cols))."""
        rng = np.random.default_rng(seed)
        scale = embed ** -0.5
        for name, shape in (("w_qkv", (embed, 3 * embed)),
                            ("w_out", (embed, embed)),
                            ("w_up", (embed, 4 * embed)),
                            ("w_down", (4 * embed, embed))):
            client.send_matrix(self.db, name,
                               rng.standard_normal(shape).astype(np.float32)
                               * scale,
                               (min(512, shape[0]), min(512, shape[1])))

    def params_from_store(self, client) -> TransformerLayerParams:
        def g(n):
            return client.get_tensor(self.db, n).to_dense()

        return TransformerLayerParams(w_qkv=g("w_qkv"), w_out=g("w_out"),
                                      w_up=g("w_up"), w_down=g("w_down"))

    # --- math ---------------------------------------------------------
    @staticmethod
    def _ln(x: torch.Tensor) -> torch.Tensor:
        """Layer norm without affine terms, eps 1e-5, over the
        population variance (``jnp.var``'s default)."""
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + 1e-5)

    def _mlp(self, x: torch.Tensor, p: TransformerLayerParams) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(hi_einsum("bse,ef->bsf", x, p.w_up), approximate="tanh")
        return hi_einsum("bsf,fe->bse", h, p.w_down)

    def forward(self, p: TransformerLayerParams, x: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
        """Single-device forward."""
        a = mha_forward(self._ln(x), p.w_qkv, p.w_out, self.num_heads,
                        causal=causal)
        x = x + a
        return x + self._mlp(self._ln(x), p)

    # --- set-API serving ----------------------------------------------
    def load_inputs(self, client, x, input_set: str = "x",
                    placement=None) -> None:
        """Store an activation batch (batch, seq, embed) as a one-tensor
        set on the client's device."""
        _no_placement(placement)
        client.create_set(self.db, input_set)
        client.clear_set(self.db, input_set)
        client.send_data(self.db, input_set, [np.asarray(x, np.float32)])

    def build_forward_dag(self, client, input_set: str = "x",
                          output_set: str = "y", causal: bool = True,
                          placement=None) -> WriteSet:
        """SCAN(x) ⋈ SCAN(weights...) → forward → OUTPUT, on one device.
        ``client`` is taken for the reference's signature (it looks the
        input set's placement up there); every set is unplaced here."""
        del client
        _no_placement(placement)

        def fwd(gathered, w_down_bt):
            x, wq, wo, wu = gathered
            p = TransformerLayerParams(
                w_qkv=wq.to_dense(), w_out=wo.to_dense(),
                w_up=wu.to_dense(), w_down=w_down_bt.to_dense())
            return self.forward(p, x, causal=causal)

        g1 = Join(ScanSet(self.db, input_set), ScanSet(self.db, "w_qkv"),
                  fn=lambda a, b: (a, b), label="gather:w_qkv",
                  passthrough=True)
        g2 = Join(g1, ScanSet(self.db, "w_out"),
                  fn=lambda a, b: a + (b,), label="gather:w_out",
                  passthrough=True)
        g3 = Join(g2, ScanSet(self.db, "w_up"),
                  fn=lambda a, b: a + (b,), label="gather:w_up",
                  passthrough=True)
        out = Join(g3, ScanSet(self.db, "w_down"), fn=fwd,
                   label=f"transformer-fwd:{self.num_heads}:{causal}")
        return WriteSet(out, self.db, output_set)

    def serve_forward(self, client, input_set: str = "x",
                      output_set: str = "y", causal: bool = True,
                      placement=None) -> torch.Tensor:
        sink = self.build_forward_dag(client, input_set, output_set,
                                      causal, placement=placement)
        results = client.execute_computations(
            sink, job_name=f"{self.db}-forward")
        return next(iter(results.values()))
