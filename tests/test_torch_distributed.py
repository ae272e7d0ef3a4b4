"""The single-process half of the cluster layer (``parallel/distributed``)
and the whole dry run (``graft_entry.dryrun_multichip``) of the port
against the JAX package, on the CPU.

``hybrid_mesh`` and ``cluster_info`` as ``tests/test_attention_parallel.py
:154-170`` check them, on 8 virtual CPU positions in the port and
``tests/conftest.py``'s 8 CPU devices in the reference. A coordinator
and a process count join a cluster (here of one process over gloo; two
processes in ``tests/test_torch_cluster_*.py``).

The dry run at n = 1, 2, 4 and 8 (``tests/test_transformer.py:69-76``):
its returned scalars against the reference's same calls — the reference
dry run's sections made again here with its draws in its order, since
``__graft_entry__.dryrun_multichip`` returns nothing. Counts and row
numbers are held exactly, sums within 1e-5 relative (1e-4 for the
sequence-parallel layer, whose softmax and layer norm differ in the last
bits between the packages)."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as jentry
from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.parallel import distributed as jdist
from netsdb_tpu.parallel.placement import Placement as JaxPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch.graft_entry import dryrun_multichip
from netsdb_tpu_torch.parallel import distributed as dist
from netsdb_tpu_torch.parallel.mesh import virtual_devices


def test_single_host_mesh_and_cluster_info_match_the_reference():
    want = jdist.hybrid_mesh((4, 2), ("data", "model"))
    with virtual_devices(8, "cpu"):
        mesh = dist.hybrid_mesh((4, 2), ("data", "model"))
        info = dist.cluster_info()
    assert mesh.axis_names == tuple(want.axis_names) == ("hosts", "data",
                                                         "model")
    assert mesh.shape == dict(want.shape)
    assert mesh.shape["hosts"] == 1
    jinfo = jdist.cluster_info()
    # the reference's keys, and the backend (None without a cluster)
    assert set(info) == set(jinfo) | {"backend"}
    assert info["backend"] is None
    assert info["process_count"] == jinfo["process_count"] == 1
    assert info["process_index"] == jinfo["process_index"] == 0
    assert info["global_device_count"] == jinfo["global_device_count"] == 8
    assert len(info["local_devices"]) == 8
    assert info["device_kind"] == "cpu"


@pytest.mark.parametrize("shape", [(3, 2), (8, 2)])
def test_wrong_shape_raises(shape):
    with pytest.raises(ValueError):
        jdist.hybrid_mesh(shape)
    with virtual_devices(8, "cpu"):
        with pytest.raises(ValueError, match="devices"):
            dist.hybrid_mesh(shape)


def test_initialize_cluster_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("NETSDB_TPU_COORDINATOR", raising=False)
    assert dist.initialize_cluster() is jdist.initialize_cluster() is False


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("how", ["num_processes", "address", "env"])
def test_joining_processes_raises_naming_a4_part_3(how, monkeypatch):
    """Joining once raised naming A4 part 3; now a coordinator and a
    process count join, whether given as arguments or through
    ``NETSDB_TPU_COORDINATOR`` (and its two siblings): a cluster of one
    process over 4 CPU positions, gloo, whose mesh is this process's."""
    for var in ("NETSDB_TPU_COORDINATOR", "NETSDB_TPU_NUM_PROCESSES",
                "NETSDB_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    addr = f"127.0.0.1:{_free_port()}"
    if how == "num_processes":
        # a process count needs a coordinator to join through
        with pytest.raises(ValueError, match="NETSDB_TPU_COORDINATOR"):
            dist.initialize_cluster(num_processes=1, process_id=0,
                                    device="cpu")
        kwargs = dict(coordinator_address=addr, num_processes=1,
                      process_id=0)
    else:
        monkeypatch.setenv("NETSDB_TPU_NUM_PROCESSES", "1")
        monkeypatch.setenv("NETSDB_TPU_PROCESS_ID", "0")
        kwargs = {}
        if how == "address":
            kwargs = dict(coordinator_address=addr)
        else:
            monkeypatch.setenv("NETSDB_TPU_COORDINATOR", addr)
    with virtual_devices(4, "cpu"):
        assert dist.initialize_cluster(**kwargs, device="cpu",
                                       timeout_s=30) is True
        try:
            info = dist.cluster_info()
            assert info["backend"] == "gloo"
            assert info["process_count"] == 1
            assert info["global_device_count"] == 4
            mesh = dist.hybrid_mesh((2, 2))
            assert mesh.shape == {"hosts": 1, "data": 2, "model": 2}
            assert not mesh.spans_processes
            with pytest.raises(RuntimeError, match="already joined"):
                dist.initialize_cluster(addr, 1, 0, device="cpu")
        finally:
            dist.shutdown_cluster()
    assert dist.joined() is None and dist.cluster_info(
        "cpu")["backend"] is None


def test_cluster_info_without_a_card_never_falls_back():
    import torch

    if torch.cuda.is_available():
        assert dist.cluster_info()["device_kind"] == \
            torch.cuda.get_device_name(0)
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dist.cluster_info()


def _sum(x) -> float:
    return float(np.asarray(x, np.float64).sum())


def _reference_dryrun(n, tmp_path):
    """The reference's ``dryrun_multichip(n)`` section by section, with
    its draws in its order, returning the scalars the port returns."""
    from netsdb_tpu.models.ff import FFModel
    from netsdb_tpu.models.moe import init_moe_params, moe_forward
    from netsdb_tpu.models.transformer import TransformerLayerModel
    from netsdb_tpu.parallel.pipeline import pipeline_apply
    from netsdb_tpu.relational import dag as rdag
    from netsdb_tpu.relational.shuffle import q03_row_sink_for
    from netsdb_tpu.workloads import tpch as tpch_rows

    clear_compiled_cache()
    devices = jentry._ensure_devices(n)
    out = {}
    model_ax = max(1, n // 2)
    data_ax = n // model_ax
    axes = (("data", data_ax), ("model", model_ax))
    hidden, batch, labels, block = 8 * model_ax * 2, 8 * data_ax * 2, 8, \
        (8, 8)
    rng = np.random.default_rng(0)
    client = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    model = FFModel(db="ff", block=block)
    model.setup(client, placements={
        "inputs": JaxPlacement(axes, ("data", None)),
        "w1": JaxPlacement(axes, ("model", None)),
        "b1": JaxPlacement(axes, (None, None)),
        "wo": JaxPlacement(axes, (None, "model")),
        "bo": JaxPlacement(axes, (None, None)),
        "output": JaxPlacement(axes, (None, "data"))})
    model.load_random_weights(client, features=16, hidden=hidden,
                              labels=labels, seed=0)
    model.load_inputs(client,
                      rng.standard_normal((batch, 16)).astype(np.float32))
    out["ff"] = _sum(model.inference(client).to_dense())
    client.create_set("ff", "labels",
                      placement=JaxPlacement(axes, (None, "data")))
    y = rng.integers(0, labels, batch)
    onehot = np.zeros((labels, batch), np.float32)
    onehot[y, np.arange(batch)] = 1.0
    client.send_matrix("ff", "labels", onehot, block)
    _, loss = jax.jit(model.train_step)(
        model.params_from_store(client), client.get_tensor("ff", "inputs"),
        client.get_tensor("ff", "labels"))
    out["loss"] = float(loss)
    rng1 = np.random.default_rng(1)
    sp_axes = (("sp", n),)
    tl = TransformerLayerModel(db="tl", num_heads=4)
    tl.setup(client, placements={s: JaxPlacement(sp_axes, (None, None))
                                 for s in TransformerLayerModel.SETS})
    tl.load_random_weights(client, 32, seed=1)
    tl.load_inputs(client,
                   rng1.standard_normal((1, 8 * n, 32)).astype(np.float32),
                   placement=JaxPlacement(sp_axes, (None, "sp", None)))
    out["sp"] = _sum(tl.serve_forward(client))
    pp_mesh = JaxPlacement((("pp", n),), (None,)).mesh(devices)
    stage_w = jnp.asarray(rng.standard_normal((n, 16, 16)),
                          jnp.float32) * 0.3
    xs = jnp.asarray(rng.standard_normal((2, 4, 16)), jnp.float32)
    out["pp"] = _sum(pipeline_apply(lambda p, x2: jnp.tanh(x2 @ p), stage_w,
                                    xs, pp_mesh, "pp"))
    rows = tpch_rows.generate(scale=1, seed=0)
    client.create_database("tpch")
    row_pl = JaxPlacement((("data", n),), ("data",))
    for name in ("lineitem", "orders", "customer"):
        client.create_set("tpch", name, type_name="table",
                          placement=row_pl if name != "customer" else None)
        client.send_table("tpch", name, rows[name])
    q01 = rdag.run_query(client, rdag.q01_sink("tpch"))
    valid = np.asarray(q01.mask())
    out["q01_count"] = [int(c) for c in np.asarray(q01["count"])[valid]]
    out["q03_rows"] = len(next(iter(client.execute_computations(
        q03_row_sink_for(client, "tpch")).values())))
    pclient = JaxClient(JaxConfiguration(
        root_dir=str(tmp_path / "jax-paged"), page_size_bytes=4096,
        page_pool_bytes=16384))
    pclient.create_database("tpch")
    pclient.create_set("tpch", "lineitem", type_name="table",
                       storage="paged", placement=row_pl)
    pclient.send_table("tpch", "lineitem", rows["lineitem"])
    out["q06_revenue"] = float(np.asarray(rdag.run_query(
        pclient, rdag.q06_sink("tpch"))["revenue"])[0])
    ep_mesh = JaxPlacement((("data", 1), ("model", n)),
                           (None, None)).mesh(devices)
    moe_p = init_moe_params(d=16, hidden=32, n_experts=max(n, 2))
    moe_x = jnp.asarray(rng.standard_normal((32, 16)), jnp.float32)
    out["ep"] = _sum(jax.jit(lambda p, xx: moe_forward(
        p, xx, 4.0, ep_mesh, "model"))(moe_p, moe_x))
    pw = FFModel(db="ffpw", block=(8, 8))
    pw.setup(pclient, placements={"w1": JaxPlacement((("model", n),),
                                                     (None, "model"))},
             storages={"w1": "paged", "wo": "paged"})
    pw.load_random_weights(pclient, 16, 32, 8, seed=0)
    pw.load_inputs(pclient, np.asarray(rng.standard_normal((16, 16)),
                                       np.float32))
    out["paged_ff"] = _sum(pw.inference(pclient).to_dense())
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_matches_the_reference(n, tmp_path):
    want = _reference_dryrun(n, tmp_path)
    got = dryrun_multichip(n, device="cpu")
    assert set(got) == set(want)
    assert got["q01_count"] == want["q01_count"]
    assert got["q03_rows"] == want["q03_rows"] > 0
    for key in ("ff", "loss", "pp", "q06_revenue", "ep", "paged_ff"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got["sp"], want["sp"], rtol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_equals_its_one_position_run(n):
    """What phase 19 of ``chip_smoke.py`` holds on the card: the placed
    dry run against the same calls on one position (no placement, the
    pipeline's stages in turn, MoE without a mesh)."""
    from netsdb_tpu_torch.graft_entry import dryrun_sections

    got = dryrun_multichip(n, device="cpu")
    one = dryrun_sections(n, "cpu", placed=False)
    assert got["q01_count"] == one["q01_count"]
    assert got["q03_rows"] == one["q03_rows"]
    for key in ("ff", "loss", "pp", "q06_revenue", "ep", "paged_ff"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(got["sp"], one["sp"], rtol=1e-4)
