"""Entry points of the port — counterpart of the repository's
``__graft_entry__.py``.

``entry()``               → the flagship FF forward and example args.
``dryrun_multichip(n)``   → every section of the reference's dry run over
                            an n-position mesh: FF through placed sets
                            and a training step over params read back
                            from them, sequence parallelism through the
                            set API (B2 on a Hopper card), the pipeline,
                            placed Q01 and the Q03 row shuffle, paged and
                            placed Q06, expert-parallel MoE, and FF over
                            a paged and placed ``w1``.

Both run on CUDA unless given ``device=``, and raise where there is no
card. With fewer visible positions than ``n`` the dry run runs on ``n``
virtual positions of ``device`` (``parallel.mesh.virtual_devices``).
"""

from __future__ import annotations

import contextlib
import tempfile
from typing import Any, Dict

import numpy as np
import torch

from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models.ff import FFModel, FFParams


def _onehot(labels: np.ndarray, n_labels: int) -> np.ndarray:
    onehot = np.zeros((n_labels, labels.size), np.float32)
    onehot[labels, np.arange(labels.size)] = 1.0
    return onehot


def _tiny_model(block=(8, 8), features=16, hidden=32, labels=8, batch=16,
                device=None):
    """The reference's ``_tiny_model``: the same numpy draws, in order."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    def blocked(a, bs):
        return BlockedTensor.from_dense(a, bs, device=device)

    model = FFModel(block=block)
    params = FFParams(
        w1=blocked(rng.standard_normal((hidden, features)).astype(np.float32),
                   block),
        b1=blocked(np.zeros((hidden, 1), np.float32), (block[0], 1)),
        wo=blocked(rng.standard_normal((labels, hidden)).astype(np.float32),
                   block),
        bo=blocked(np.zeros((labels, 1), np.float32), (block[0], 1)))
    x = blocked(rng.standard_normal((batch, features)).astype(np.float32),
                block)
    y = blocked(_onehot(rng.integers(0, labels, batch), labels), block)
    return model, params, x, y


def entry(device=None):
    """``(fn, example_args)``: the FF forward step and its arguments."""
    model, params, x, _ = _tiny_model(device=device)
    return model.forward, (params, x)


def _finite(x, what: str) -> float:
    """The sum of ``x``'s values (a tensor, a sharded value or a
    BlockedTensor), raising on a non-finite one."""
    from netsdb_tpu_torch.parallel.placed_ops import host_array

    a = np.asarray(host_array(x), np.float64)
    if not np.isfinite(a).all():
        raise RuntimeError(f"{what} gave a non-finite output")
    return float(a.sum())


def _positions(n_devices: int, device):
    """The dry run's positions: the visible cards when there are enough,
    else ``n_devices`` virtual positions of ``device``."""
    from netsdb_tpu_torch.parallel.mesh import virtual_devices

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return contextlib.nullcontext()
    return virtual_devices(n_devices, dev)


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, Any]:
    """The reference's dry run (``__graft_entry__.dryrun_multichip``)
    over ``n_devices`` positions, section by section with the same draws
    in the same order. Raises on a non-finite output of any section, as
    the reference's asserts do. Returns the sections' scalars: the
    training loss, Q01's group counts, the Q03 row count, the paged Q06
    revenue, and the sums of the other sections' outputs."""
    device = resolve_device(device)
    with _positions(n_devices, device):
        return dryrun_sections(n_devices, device)


def dryrun_sections(n: int, device, placed: bool = True) -> Dict[str, Any]:
    """The dry run's sections at its shapes for ``n`` positions, over
    the visible positions. ``placed=False`` runs the same calls on one
    position — no placement, the pipeline's stages one after another,
    MoE without a mesh — which a placed run is held to."""
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.placement import Placement

    def pl(axes, spec):
        return Placement(axes, spec) if placed else None

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    out: Dict[str, Any] = {}
    with tempfile.TemporaryDirectory(prefix="netsdb-dryrun-") as root:
        client = Client(Configuration(root_dir=root), device=device)
        try:
            out.update(_dryrun_ff(client, n, rng, pl))
            out.update(_dryrun_sp(client, n, pl))
            out.update(_dryrun_pp(rng, n, device, placed))
            out.update(_dryrun_tpch(client, n, device, root, placed))
            out.update(_dryrun_ep(rng, n, device, placed))
            out.update(_dryrun_paged_ff(rng, n, device, root, pl))
        finally:
            client.store.close()
    return out


def _dryrun_ff(client, n: int, rng, pl) -> Dict[str, Any]:
    """FF through placed sets, every sharded dim dividing its axis, and a
    training step over params read back from the placed store."""
    model_ax = max(1, n // 2)
    data_ax = n // model_ax
    axes = (("data", data_ax), ("model", model_ax))
    block = (8, 8)
    hidden = 8 * model_ax * 2
    batch = 8 * data_ax * 2
    labels = 8
    model = FFModel(db="ff", block=block)
    model.setup(client, placements={
        "inputs": pl(axes, ("data", None)),
        "w1": pl(axes, ("model", None)),
        "b1": pl(axes, (None, None)),
        "wo": pl(axes, (None, "model")),
        "bo": pl(axes, (None, None)),
        "output": pl(axes, (None, "data")),
    })
    model.load_random_weights(client, features=16, hidden=hidden,
                              labels=labels, seed=0)
    model.load_inputs(
        client, rng.standard_normal((batch, 16)).astype(np.float32))
    ff = _finite(model.inference(client), "ff inference")
    client.create_set("ff", "labels", placement=pl(axes, (None, "data")))
    client.send_matrix("ff", "labels",
                       _onehot(rng.integers(0, labels, batch), labels),
                       block)
    _, loss = model.train_step(model.params_from_store(client),
                               client.get_tensor("ff", "inputs"),
                               client.get_tensor("ff", "labels"))
    return {"ff": ff, "loss": _finite(loss, "the training step")}


def _dryrun_sp(client, n: int, pl) -> Dict[str, Any]:
    """Sequence parallelism through the set API: replicated weight sets,
    activations sharded on the sequence, ring attention over the
    placement's mesh."""
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    rng1 = np.random.default_rng(1)
    embed, seq, heads = 32, 8 * n, 4
    sp_axes = (("sp", n),)
    tl = TransformerLayerModel(db="tl", num_heads=heads)
    tl.setup(client, placements={s: pl(sp_axes, (None, None))
                                 for s in TransformerLayerModel.SETS})
    tl.load_random_weights(client, embed, seed=1)
    tl.load_inputs(client,
                   rng1.standard_normal((1, seq, embed)).astype(np.float32),
                   placement=pl(sp_axes, (None, "sp", None)))
    return {"sp": _finite(tl.serve_forward(client), "the sp forward")}


def _dryrun_pp(rng, n: int, device, placed: bool) -> Dict[str, Any]:
    """The stage-sharded microbatch schedule over a mesh that comes from
    a declarative Placement (unplaced: the stages one after another)."""
    from netsdb_tpu_torch.parallel.mesh import visible_devices
    from netsdb_tpu_torch.parallel.pipeline import pipeline_apply
    from netsdb_tpu_torch.parallel.placement import Placement

    devices = visible_devices(device.type)[:n]
    pp_mesh = Placement((("pp", n),), (None,)).mesh(devices)
    d = 16
    stage_w = torch.from_numpy(rng.standard_normal((n, d, d)).astype(
        np.float32)).to(device) * 0.3
    xs = torch.from_numpy(rng.standard_normal((2, 4, d)).astype(
        np.float32)).to(device)

    def stage(w, x):
        from netsdb_tpu_torch.ops.common import full_f32_precision

        full_f32_precision()
        return torch.tanh(x @ w)

    if placed:
        ys = pipeline_apply(stage, stage_w, xs, pp_mesh, "pp")
    else:
        ys = xs
        for w in stage_w:
            ys = torch.stack([stage(w, x) for x in ys])
    return {"pp": _finite(ys, "the pipeline")}


def _dryrun_tpch(client, n: int, device, root: str,
                 placed: bool) -> Dict[str, Any]:
    """Placed Q01 and the Q03 row shuffle as DAGs over placed sets, and
    Q06 over a lineitem set both paged and placed."""
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.relational.shuffle import q03_row_sink_for
    from netsdb_tpu_torch.workloads import tpch as tpch_rows

    rows = tpch_rows.generate(scale=1, seed=0)
    client.create_database("tpch")
    # the row shuffle needs placed sets: one position's when unplaced
    row_pl = Placement((("data", n if placed else 1),), ("data",))
    for name in ("lineitem", "orders", "customer"):
        client.create_set("tpch", name, type_name="table",
                          placement=row_pl if name != "customer" else None)
        client.send_table("tpch", name, rows[name])
    q01 = rdag.run_query(client, rdag.q01_sink("tpch"))
    _finite(q01["sum_qty"], "the set-API q01")
    q03 = next(iter(client.execute_computations(
        q03_row_sink_for(client, "tpch")).values()))
    if not q03:
        raise RuntimeError("the row-shuffle q03 DAG returned no rows")
    pclient = Client(Configuration(root_dir=f"{root}/paged",
                                   page_size_bytes=4096,
                                   page_pool_bytes=16384), device=device)
    try:
        pclient.create_database("tpch")
        pclient.create_set("tpch", "lineitem", type_name="table",
                           storage="paged", placement=row_pl)
        pclient.send_table("tpch", "lineitem", rows["lineitem"])
        q06 = rdag.run_query(pclient, rdag.q06_sink("tpch"))
        revenue = _finite(q06["revenue"][:1], "the paged and placed q06")
    finally:
        pclient.store.close()
    return {"q01_count": [int(c) for c in _host_ints(q01)],
            "q03_rows": len(q03), "q06_revenue": revenue}


def _host_ints(q01) -> list:
    from netsdb_tpu_torch.parallel.placed_ops import host_array

    counts = host_array(q01["count"])
    valid = host_array(q01.valid) if q01.valid is not None else None
    return counts[valid] if valid is not None else counts


def _dryrun_ep(rng, n: int, device, placed: bool) -> Dict[str, Any]:
    """Expert parallelism: the experts split over the placement's model
    axis (unplaced: no mesh)."""
    from netsdb_tpu_torch.models.moe import init_moe_params, moe_forward
    from netsdb_tpu_torch.parallel.mesh import visible_devices
    from netsdb_tpu_torch.parallel.placement import Placement

    ep_mesh = Placement((("data", 1), ("model", n)), (None, None)).mesh(
        visible_devices(device.type)[:n])
    moe_p = init_moe_params(d=16, hidden=32, n_experts=max(n, 2),
                            device=device)
    moe_x = torch.from_numpy(rng.standard_normal((32, 16)).astype(
        np.float32)).to(device)
    return {"ep": _finite(moe_forward(moe_p, moe_x, 4.0,
                                      ep_mesh if placed else None, "model"),
                          "the expert-parallel MoE")}


def _dryrun_paged_ff(rng, n: int, device, root: str,
                     pl) -> Dict[str, Any]:
    """FF over paged weight sets, ``w1`` also placed: each streamed block
    is placed on the mesh before its step."""
    from netsdb_tpu_torch.config import Configuration

    pclient = Client(Configuration(
        root_dir=f"{root}/paged-ff", page_size_bytes=4096,
        page_pool_bytes=16384), device=device)
    try:
        pw = FFModel(db="ffpw", block=(8, 8))
        pw.setup(pclient,
                 placements={"w1": pl((("model", n),), (None, "model"))},
                 storages={"w1": "paged", "wo": "paged"})
        pw.load_random_weights(pclient, 16, 32, 8, seed=0)
        pw.load_inputs(pclient, np.asarray(
            rng.standard_normal((16, 16)), np.float32))
        return {"paged_ff": _finite(pw.inference(pclient),
                                    "the paged-weight inference")}
    finally:
        pclient.store.close()
