"""Transformer layer serving — counterpart of
``netsdb_tpu/models/transformer.py``.

A transformer block whose weights live in database sets like every
other model's, run through the same Computation DAG. Layer = pre-LN MHA
+ residual, pre-LN MLP (gelu) + residual; x is (batch, seq, embed).

Two forwards, chosen by how the sets were created: unplaced sets run
the single-device :meth:`TransformerLayerModel.forward`, whose attention
core on a Hopper card is the CUDA flash kernel (B1,
``ops.attention.attention_dispatch``); an input set placed with its
sequence axis sharded runs :meth:`TransformerLayerModel.forward_sp`
over the placement's mesh, whose attention core is ring attention
folded by the CUDA ring-step kernel (B2, ``parallel.ring``).

:meth:`TransformerLayerModel.build_forward_dag_staged` writes the same
layer as staged nodes, so every weight may live in a ``storage="paged"``
set and stream through the DAG (reduce-mode ``TensorFold``s, the
attention core again B1). :meth:`TransformerLayerModel.train_step` is
the reference's training dry run (MSE of the single-device forward, SGD
over the four weights); on the card its attention is B1 under autograd
(``ops.cuda_kernels.FlashAttentionFunction``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from netsdb_tpu_torch.models._common import sgd_step
from netsdb_tpu_torch.ops.attention import (attention_dispatch, merge_heads,
                                            merge_project, mha_forward,
                                            qkv_project, split_qkv_heads)
from netsdb_tpu_torch.ops.common import full_f32_precision, hi_einsum
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, as_sharded,
                                            visible_devices)
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.parallel.ring import ring_attention
from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import TensorFold
from netsdb_tpu_torch.storage.store import SetIdentifier


@dataclasses.dataclass
class TransformerLayerParams:
    w_qkv: torch.Tensor   # (E, 3E)
    w_out: torch.Tensor   # (E, E)
    w_up: torch.Tensor    # (E, 4E)
    w_down: torch.Tensor  # (4E, E)


def _dense(t):
    """A tensor from a tensor or a sharded value: a replicated value's
    first shard, anything else gathered and counted (the single-device
    forward and the staged nodes run on one device)."""
    return placed_ops.whole(t, "transformer-layer")


def _contract_partial(carry, start: int, block, acts: torch.Tensor):
    """Reduce-mode step of a projection ``acts @ w`` over w's row block
    ``block`` (rows ``start:start+n`` of w, a contraction slice): the
    matching columns of ``acts`` times the block, accumulated into the
    carry in place (a fresh tensor on the first block, never a cached
    block). ``start`` is a host int, so slicing never syncs."""
    block = _dense(block)
    n, f = block.shape
    # a strided view of the activations (leading dimension E), no copy
    x = acts.reshape(-1, acts.shape[-1])[:, start:start + n]
    full_f32_precision()
    if carry is None:
        return torch.mm(x, block).view(*acts.shape[:-1], f)
    carry.view(-1, f).addmm_(x, block)
    return carry


def _weight(w) -> torch.Tensor:
    """A resident weight set's value as a dense tensor."""
    if isinstance(w, ShardedTensor):
        return _dense(w)
    return _dense(w.to_dense() if hasattr(w, "to_dense") else w)


def _daemon_mesh(placement: Placement, axis: str, x) -> Optional[Mesh]:
    """The mesh a placement resolves to on the daemon running the body:
    over the positions visible to the device type of the stored input
    ``x`` there (its virtual positions too). None on a mesh of size 1
    along ``axis`` (the degraded-hardware rule, as in the process that
    built the DAG)."""
    if isinstance(x, ShardedTensor):
        dev = x.first().device
    else:
        dev = _dense(x).device
    mesh = placement.mesh(visible_devices(dev.type))
    return None if mesh.shape[axis] == 1 else mesh


class _LocalWeights:
    """Each mesh position's copy of a weight: a replicated sharded
    weight on the same mesh gives its own shard; anything else is
    gathered once and copied once to each device that needs it."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._copies: Dict[tuple, torch.Tensor] = {}

    def at(self, w, pos) -> torch.Tensor:
        if isinstance(w, ShardedTensor) and w.mesh is self.mesh \
                and w.is_replicated:
            return w.shards[pos]
        dev = self.mesh.devices[pos]
        key = (id(w), dev)
        if key not in self._copies:
            self._copies[key] = _dense(w).to(dev)
        return self._copies[key]

    def params(self, p: "TransformerLayerParams", pos
               ) -> "TransformerLayerParams":
        return TransformerLayerParams(
            **{f.name: self.at(getattr(p, f.name), pos)
               for f in dataclasses.fields(p)})


class TransformerLayerModel:
    SETS = ("w_qkv", "w_out", "w_up", "w_down")

    def __init__(self, db: str = "transformer", num_heads: int = 8):
        self.db = db
        self.num_heads = num_heads

    def setup(self, client, placements=None, storages=None) -> None:
        """Create the weight sets. ``placements`` maps set name →
        Placement (weights typically replicated); ``storages`` maps set
        name → "memory" or "paged" (a paged weight streams through
        :meth:`build_forward_dag_staged`)."""
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

    def forward_sp(self, p: TransformerLayerParams, x, mesh: Mesh,
                   axis: str = "data", causal: bool = True) -> ShardedTensor:
        """Sequence-parallel forward: x (batch, seq, embed) sharded
        (None, axis, None) over ``mesh`` (a dense x is sharded first).
        Layer norm, the projections and the MLP run per position on that
        position's shard, with that position's copy of the weights; the
        attention core rotates k/v around the ring
        (:func:`~netsdb_tpu_torch.parallel.ring.ring_attention`). Over a
        mesh several processes own, each runs its own positions (SPMD).
        Returns y with x's sharding."""
        spec = (None, axis, None)
        xs = as_sharded(x, mesh, spec)
        weights = _LocalWeights(mesh)
        qkv = {name: np.empty(mesh.devices.shape, dtype=object)
               for name in "qkv"}
        for pos in mesh.local_positions():
            w = weights.at(p.w_qkv, pos)
            for name, t in zip("qkv", qkv_project(self._ln(xs.shards[pos]),
                                                  w, self.num_heads)):
                qkv[name][pos] = t
        b, s, e = xs.shape
        head_shape = (b, self.num_heads, s, e // self.num_heads)
        q, k, v = (ShardedTensor(qkv[name], mesh, (None, None, axis, None),
                                 head_shape) for name in "qkv")
        out = ring_attention(q, k, v, mesh, axis=axis, causal=causal)
        ys = np.empty(mesh.devices.shape, dtype=object)
        for pos in mesh.local_positions():
            lp = weights.params(p, pos)
            x1 = xs.shards[pos] + merge_project(out.shards[pos], lp.w_out)
            ys[pos] = x1 + self._mlp(self._ln(x1), lp)
        return ShardedTensor(ys, mesh, spec, xs.shape)

    # --- set-API serving ----------------------------------------------
    def load_inputs(self, client, x, input_set: str = "x",
                    placement=None) -> None:
        """Store an activation batch (batch, seq, embed) as a one-tensor
        set on the client's device. With a placement whose spec shards
        dim 1, the sequence is stored sharded over the mesh; unplaced
        inputs get a trivial one-position placement, as in the
        reference, so a set placed before is re-placed."""
        if placement is None:
            placement = Placement((("data", 1),), (None,) * np.ndim(x))
        client.create_set(self.db, input_set, placement=placement)
        client.clear_set(self.db, input_set)
        client.send_data(self.db, input_set, [np.asarray(x, np.float32)])

    def build_forward_dag(self, client, input_set: str = "x",
                          output_set: str = "y", causal: bool = True,
                          placement=None) -> WriteSet:
        """SCAN(x) ⋈ SCAN(weights...) → forward → OUTPUT. When the
        input set's placement shards an axis of size > 1, the body runs
        :meth:`forward_sp` over that placement's mesh; otherwise (no
        placement, or a mesh of size 1 on the sharded axis, as the
        degraded-hardware rule gives) the single-device forward. The
        same DAG either way: distribution is decided by how the sets
        were created. ``placement`` defaults to the input set's (a
        RemoteClient has no store: remote callers pass the placement
        they created the set with).

        Behind a RemoteClient the body's closure carries the placement
        and its axis, never a mesh: the mesh is resolved on the daemon,
        over the daemon's own positions, when the body runs (a mesh of
        the client's process would name its devices). The program key
        pins it there: the scanned input set's program scope names the
        mesh its placement resolves to on the daemon."""
        if placement is None and hasattr(client, "store"):
            placement = client.store.placement_of(
                SetIdentifier(self.db, input_set))
        mesh: Optional[Mesh] = None
        axis = None
        remote = None  # the placement a daemon resolves its mesh from
        sharded_axes = [a for a in (placement.spec if placement else ())
                        if a is not None]
        if sharded_axes:
            ax = sharded_axes[0]
            axis = ax[0] if isinstance(ax, tuple) else ax
            if hasattr(client, "device"):
                mesh = placement.mesh(visible_devices(client.device.type))
                if mesh.shape[axis] == 1:
                    mesh = axis = None  # degraded single-device mesh
            else:
                remote = placement
        mesh_tag = (None if mesh is None else
                    (tuple(mesh.shape.items()),
                     tuple(str(d) for d in mesh.devices.flat)))

        def fwd(gathered, w_down_bt):
            x, wq, wo, wu = gathered
            p = TransformerLayerParams(
                w_qkv=wq.to_dense(), w_out=wo.to_dense(),
                w_up=wu.to_dense(), w_down=w_down_bt.to_dense())
            m = mesh if remote is None else _daemon_mesh(remote, axis, x)
            if m is not None:
                return self.forward_sp(p, x, m, axis, causal=causal)
            p = TransformerLayerParams(
                **{f.name: _dense(getattr(p, f.name))
                   for f in dataclasses.fields(p)})
            return self.forward(p, _dense(x), causal=causal)

        g1 = Join(ScanSet(self.db, input_set), ScanSet(self.db, "w_qkv"),
                  fn=lambda a, b: (a, b), label="gather:w_qkv",
                  passthrough=True)
        g2 = Join(g1, ScanSet(self.db, "w_out"),
                  fn=lambda a, b: a + (b,), label="gather:w_out",
                  passthrough=True)
        g3 = Join(g2, ScanSet(self.db, "w_up"),
                  fn=lambda a, b: a + (b,), label="gather:w_up",
                  passthrough=True)
        # the body closes over the mesh (or, remote, the placement it
        # resolves), so the plan's label pins both: a same-shaped DAG
        # built for another mesh must not reuse a stale closure
        tag = mesh_tag if remote is None else remote.label()
        out = Join(g3, ScanSet(self.db, "w_down"), fn=fwd,
                   label=f"transformer-fwd:{self.num_heads}:{causal}:"
                         f"{axis}:{tag}")
        return WriteSet(out, self.db, output_set)

    def build_forward_dag_staged(self, input_set: str = "x",
                                 output_set: str = "y",
                                 causal: bool = True) -> WriteSet:
        """The forward as staged nodes (ln → qkv-proj → attention core →
        out-proj → residual → ln → MLP-up → MLP-down → residual) instead
        of one fn, so every weight (w_qkv, w_out, w_up, w_down) may live
        in a ``storage="paged"`` set and stream: each weight's row
        blocks are contraction slices accumulated by a reduce-mode
        TensorFold (gelu is ``mlp-up``'s finalize). With resident sets
        the same DAG runs the plain fns: storage is a property of the
        set, not of the query. The attention core is
        ``attention_dispatch``, B1 on a Hopper card."""
        heads, db = self.num_heads, self.db

        def proj_fold(finalize=None):
            return TensorFold(mode="reduce", partial=_contract_partial,
                              finalize=finalize)

        def gelu(t):  # jax.nn.gelu's default is the tanh approximation
            return F.gelu(t, approximate="tanh")

        def attn_core(q_k_v):
            q, k, v = split_qkv_heads(q_k_v, heads)
            return merge_heads(attention_dispatch(q, k, v, causal=causal))

        ln1 = Apply(ScanSet(db, input_set), fn=lambda x: self._ln(_dense(x)),
                    label="ln1")
        qkv = Join(ln1, ScanSet(db, "w_qkv"),
                   fn=lambda xs, w: hi_einsum("bse,ef->bsf", xs, _weight(w)),
                   tensor_fold=proj_fold(), label="qkv-proj")
        core = Apply(qkv, fn=attn_core, label=f"attn-core:{heads}:{causal}")
        proj = Join(core, ScanSet(db, "w_out"),
                    fn=lambda o, w: hi_einsum("bse,ef->bsf", o, _weight(w)),
                    tensor_fold=proj_fold(), label="out-proj")
        a1 = Join(ScanSet(db, input_set), proj,
                  fn=lambda x, a: _dense(x) + a, label="residual1")
        ln2 = Apply(a1, fn=self._ln, label="ln2")
        h = Join(ln2, ScanSet(db, "w_up"),
                 fn=lambda xs, w: gelu(hi_einsum("bse,ef->bsf", xs,
                                                 _weight(w))),
                 tensor_fold=proj_fold(lambda c, xs: gelu(c)),
                 label="mlp-up")
        mlp = Join(h, ScanSet(db, "w_down"),
                   fn=lambda hs, w: hi_einsum("bsf,fe->bse", hs, _weight(w)),
                   tensor_fold=proj_fold(), label="mlp-down")
        out = Join(a1, mlp, fn=lambda a, m: a + m, label="residual2")
        return WriteSet(out, db, output_set)

    def serve_forward(self, client, input_set: str = "x",
                      output_set: str = "y", causal: bool = True,
                      placement=None):
        """Run the forward DAG; returns y, a tensor or (over a placed
        input set) a :class:`ShardedTensor`."""
        sink = self.build_forward_dag(client, input_set, output_set,
                                      causal, placement=placement)
        results = client.execute_computations(
            sink, job_name=f"{self.db}-forward")
        return next(iter(results.values()))

    # --- training (models/transformer.py:282-290 of the reference) -----
    def loss(self, p: TransformerLayerParams, x: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """Mean squared error of the single-device forward."""
        return torch.mean((self.forward(p, x) - targets) ** 2)

    def train_step(self, p: TransformerLayerParams, x: torch.Tensor,
                   targets: torch.Tensor, lr: float = 1e-2
                   ) -> Tuple[TransformerLayerParams, torch.Tensor]:
        """One SGD step over the four dense weights; returns ``(new
        params, loss)``."""
        return sgd_step(self.loss, p, lr, x, targets)
