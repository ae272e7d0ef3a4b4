"""The port's explicit collectives (``parallel/collectives.py``) and the
mesh's position-order helpers against the JAX package's ``shard_map``
collectives, on the CPU.

The JAX side runs on ``tests/conftest.py``'s virtual CPU devices; the
port on as many virtual positions of the CPU (``virtual_devices(n,
"cpu")``). Both take the same numpy operands from a seed: random normal
operands within the reference tests' 1e-4 (and the two packages within
1e-5 of each other), integer-valued ones byte-equal to one product on one
position. Also here: ``virtual_devices`` defaults to the card and, with no
card, raises like ``visible_devices("cuda")``; and the entry points that
once raised naming ROADMAP.md A4 part 3, inside a joined cluster."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.parallel import collectives as J
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu_torch.parallel import collectives as C
from netsdb_tpu_torch.parallel import mesh as M
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                            virtual_devices)

RNG_SEED = 0
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def mesh8():
    with virtual_devices(8, "cpu"):
        yield make_mesh((8,), ("model",))


@pytest.fixture(scope="module")
def jmesh8():
    return jmake_mesh((8,), ("model",))


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def ints(shape, seed):
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(
        np.float32)


CASES = {
    "psum": ((16, 64), (64, 24), (None, None)),
    "psum_scatter": ((16, 64), (64, 24), ("model", None)),
    "allgather": ((32, 16), (16, 8), ("model", None)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matmul_matches_the_reference(name, mesh8, jmesh8):
    sa, sb, spec = CASES[name]
    a, b = normal(sa, 1), normal(sb, 2)
    got = getattr(C, f"matmul_{name}")(torch.from_numpy(a),
                                       torch.from_numpy(b), mesh8)
    want = getattr(J, f"matmul_{name}")(jnp.asarray(a), jnp.asarray(b),
                                        jmesh8)
    assert isinstance(got, ShardedTensor)
    assert got.spec == spec
    dense = got.to_dense().numpy()
    np.testing.assert_allclose(dense, a @ b, **TOL)
    np.testing.assert_allclose(dense, np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_integer_valued_collectives_are_byte_equal(name, mesh8):
    """Sums of small integers are exact in any order: each collective is
    byte-equal to one product on one position."""
    sa, sb, _ = CASES[name]
    a, b = torch.from_numpy(ints(sa, 3)), torch.from_numpy(ints(sb, 4))
    got = getattr(C, f"matmul_{name}")(a, b, mesh8).to_dense()
    assert torch.equal(got, torch.matmul(a, b))


def test_psum_replicas_share_one_tensor_per_device(mesh8):
    a, b = torch.from_numpy(normal((16, 64), 5)), torch.from_numpy(
        normal((64, 24), 6))
    out = C.matmul_psum(a, b, mesh8)
    assert len({id(t) for t in out.shards.flat}) == 1


@pytest.mark.parametrize("dims", [(0, 1), (1, 2), (2, 0)])
def test_all_to_all_resharding_matches_the_reference(dims, mesh8, jmesh8):
    x = normal((16, 24, 8), 7)
    got = C.all_to_all_resharding(torch.from_numpy(x), mesh8, "model",
                                  from_dim=dims[0], to_dim=dims[1])
    want = J.all_to_all_resharding(jnp.asarray(x), jmesh8, "model",
                                   from_dim=dims[0], to_dim=dims[1])
    spec = [None] * 3
    spec[dims[1]] = "model"
    assert got.spec == tuple(spec)
    assert np.array_equal(got.to_dense().numpy(), x)
    assert np.array_equal(np.asarray(want), x)
    # each position holds its block of the destination dimension
    for i in range(8):
        blk = got.shards.flat[i].numpy()
        sl = [slice(None)] * 3
        n = x.shape[dims[1]] // 8
        sl[dims[1]] = slice(i * n, (i + 1) * n)
        assert np.array_equal(blk, x[tuple(sl)])


def test_collectives_over_one_axis_of_a_two_axis_mesh():
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((2, 4), ("data", "model"))
        a, b = torch.from_numpy(ints((8, 32), 1)), torch.from_numpy(
            ints((32, 4), 2))
        out = C.matmul_psum_scatter(a, b, mesh)
        assert out.shards.shape == (2, 4)
        assert torch.equal(out.to_dense(), a @ b)
        assert torch.equal(out.shards[0, 1], out.shards[1, 1])


# --- the position-order helpers -------------------------------------------

def test_position_sum_adds_in_position_order():
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
    # ((1e8 + 1) - 1e8) + 1 in f32 is 1, not the exact 2
    assert M.position_sum(parts).item() == 1.0
    assert parts[0].item() == 1e8  # the first partial is not written


def test_position_gather_scatter_and_all_to_all_round_trip():
    devices = [torch.device("cpu")] * 4
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    blocks = M.position_scatter(x, devices, dim=0)
    assert [b.shape for b in blocks] == [(2, 8)] * 4
    assert torch.equal(M.position_gather(blocks, 0), x)
    cols = M.position_all_to_all(blocks, 1, 0)
    assert torch.equal(torch.cat(cols, dim=1), x)
    with pytest.raises(ValueError, match="split"):
        M.position_scatter(torch.zeros(6, 2), devices)


# --- the default device -----------------------------------------------------

def test_virtual_devices_defaults_to_the_card():
    """``virtual_devices(n)`` puts the positions on the first card; with
    no card visible it raises the same error as ``visible_devices(
    "cuda")`` and never hands back CPU positions."""
    import inspect

    assert inspect.signature(M.virtual_devices).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        with virtual_devices(2) as devs:
            assert devs == (torch.device("cuda", 0),) * 2
        return
    with pytest.raises(RuntimeError, match="no CUDA card") as want:
        M.visible_devices("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card") as got:
        with virtual_devices(2):
            pytest.fail("virtual_devices(2) gave positions without a card")
    assert str(got.value) == str(want.value)
    assert M._virtual is None  # nothing was left installed


# --- once refused, naming ROADMAP.md A4 part 3; now inside a cluster -----

@pytest.mark.parametrize("name", ["initialize_cluster", "hybrid_mesh",
                                  "cluster_info", "pipeline_apply"])
def test_multi_process_entry_points_raise_naming_a4_part_3(name):
    """These once raised naming A4 part 3 when processes joined; they are
    exported as the reference exports them, and each case holds one
    against the reference inside a joined cluster (of one process over
    gloo, its 8 CPU positions: the same mesh the reference's one process
    sees)."""
    import socket

    from netsdb_tpu import parallel as jparallel
    from netsdb_tpu_torch import parallel

    assert name in parallel.__all__ and name in jparallel.__all__
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    with virtual_devices(8, "cpu"):
        assert parallel.initialize_cluster(addr, 1, 0, device="cpu",
                                           timeout_s=30) is True
        try:
            _joined_entry_point(name, parallel, jparallel)
        finally:
            parallel.shutdown_cluster()


def _joined_entry_point(name, parallel, jparallel):
    if name == "initialize_cluster":
        assert parallel.initialize_cluster() is \
            jparallel.initialize_cluster() is False
        with pytest.raises(RuntimeError, match="already joined"):
            parallel.initialize_cluster("127.0.0.1:1", 1, 0,
                                        device="cpu")
    elif name == "hybrid_mesh":
        got, want = (p.hybrid_mesh((2, 4), ("data", "model"))
                     for p in (parallel, jparallel))
        assert got.axis_names == tuple(want.axis_names)
        assert got.shape == dict(want.shape)
    elif name == "cluster_info":
        got, want = parallel.cluster_info(), jparallel.cluster_info()
        assert set(got) == set(want) | {"backend"}
        assert got["backend"] == "gloo"
        for key in ("process_index", "process_count",
                    "global_device_count"):
            assert got[key] == want[key]
        assert got["device_kind"] == "cpu"
    else:
        x = normal((3, 2, 4), 1)
        w = normal((8, 4, 4), 2)
        want = np.asarray(jparallel.pipeline_apply(
            lambda p, v: v @ p, jnp.asarray(w), jnp.asarray(x),
            jmake_mesh((8,), ("pp",)), "pp"))
        got = parallel.pipeline_apply(
            lambda p, v: v @ p, torch.from_numpy(w), torch.from_numpy(x),
            make_mesh((8,), ("pp",)), "pp")
        np.testing.assert_allclose(got.to_dense().numpy(), want, **TOL)


def test_expert_parallel_moe_and_model_placements_raise(tmp_path):
    """Both once raised naming A4 part 3 and are ported: expert-parallel
    MoE equals ``mesh=None``, and each model family's setup creates its
    sets placed as asked."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models import LogRegModel, LSTMModel, Word2VecModel
    from netsdb_tpu_torch.models.moe import init_moe_params, moe_forward
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.storage.store import SetIdentifier

    params = init_moe_params(4, 8, 4, device="cpu")
    x = torch.from_numpy(normal((6, 4), 3))
    with virtual_devices(4, "cpu"):
        ep = moe_forward(params, x, 2.0, make_mesh((4,), ("model",)),
                         "model")
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        for model in (LogRegModel(), Word2VecModel(), LSTMModel()):
            sets = getattr(model, "SETS", None) or model.weight_sets
            model.setup(c, placements={s: Placement.replicated()
                                       for s in sets})
            for s in sets:
                assert c.store.placement_of(SetIdentifier(
                    model.db, s)) == Placement.replicated()
    # one expert a position: the batched products may take another
    # kernel than four experts' and differ in the last bits
    np.testing.assert_allclose(ep.numpy(),
                               moe_forward(params, x, 2.0).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("driver", ["kmeans", "pagerank", "topk"])
def test_placed_workloads_raise_naming_a4_part_3(driver, tmp_path):
    """The drivers once refused placed sets naming A4 part 3; they are
    ported, and over placed sets give the one-device result: k-means over
    a row-sharded matrix (the same init; integer points make every sum
    exact, so the centroids are equal), PageRank and top-k over placed
    object sets (host records, the same as unplaced)."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.placement import Placement
    import importlib

    kmeans, pagerank, topk = (
        importlib.import_module(f"netsdb_tpu_torch.workloads.{m}")
        for m in ("kmeans", "pagerank", "topk"))
    rng = np.random.default_rng(5)
    pts = (rng.integers(0, 4, (30, 1)) * 16
           + rng.integers(-2, 3, (30, 4))).astype(np.float32)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, 6, (20, 2))]

    def run(tag, placement):
        c = Client(Configuration(root_dir=str(tmp_path / tag)),
                   device="cpu")
        c.create_database("d")
        if driver == "kmeans":
            c.create_set("d", "s", placement=placement)
            c.send_matrix("d", "s", pts, (4, 4))
            cents, assign = kmeans.kmeans_on_set(c, "d", "s", 4, iters=5,
                                                 seed=1)
            return cents.numpy(), assign.numpy()
        c.create_set("d", "s", type_name="object", placement=placement)
        c.send_data("d", "s", edges)
        if driver == "pagerank":
            return pagerank.pagerank_on_set(c, "d", "s", 6)
        return topk.top_k_on_set(c, "d", "s", 3,
                                 score=lambda e: float(e[0] * 7 + e[1]))

    with virtual_devices(4, "cpu"):
        placed = run("placed", Placement.data_parallel(ndim=2))
    solo = run("solo", None)
    if driver == "kmeans":
        np.testing.assert_array_equal(placed[0], solo[0])
        np.testing.assert_array_equal(placed[1], solo[1])
    elif driver == "pagerank":
        np.testing.assert_array_equal(placed, solo)
    else:
        assert placed == solo


def test_ff_inference_over_placed_sets_matches_one_device(tmp_path):
    """As ``tests/test_placement_api.py:104``: FF over sets placed on a
    (data 4, model 2) mesh — inputs and w1 stored sharded — equals the
    unplaced run within 1e-5."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.parallel.placement import Placement

    def run(tag, placements):
        c = Client(Configuration(root_dir=str(tmp_path / tag)),
                   device="cpu")
        m = FFModel(db="ffp", block=(8, 8))
        m.setup(c, placements=placements)
        m.load_random_weights(c, features=16, hidden=32, labels=8, seed=3)
        x = np.random.default_rng(7).standard_normal((32, 16)).astype(
            np.float32)
        m.load_inputs(c, x)
        return c, m.inference(c).to_dense()

    axes = (("data", 4), ("model", 2))
    with virtual_devices(8, "cpu"):
        c, dist = run("dist", {
            "inputs": Placement(axes, ("data", None)),
            "w1": Placement(axes, ("model", None)),
            "b1": Placement(axes, (None, None)),
            "wo": Placement(axes, (None, "model")),
            "bo": Placement(axes, (None, None))})
        shards = c.get_tensor("ffp", "inputs").data.shards
        assert len({id(s) for s in shards.flat}) > 1
    _, solo = run("solo", None)
    if isinstance(dist, ShardedTensor):
        dist = dist.to_dense()
    np.testing.assert_allclose(dist.numpy(), solo.numpy(), rtol=1e-5,
                               atol=1e-5)
