"""The rule for ops over placed tensors (``parallel/placed_ops``), its
gather log (``parallel.mesh.gather_log``) and training over placed
params, on the CPU.

The rule's three cases against the dense computation: per position (the
output keeps the operands' layout), the position-order psum of a
contraction sharded on one or both sides (integer-valued operands make
every sum exact, so the result equals one product on one position bit
for bit), and the counted gather of anything else, logged with the op
and the layouts. A data-parallel request of FF logs no gather, a request
on one device leaves the log empty, and a training step over the dry
run's model-sharded ``w1`` logs its gathers with the reason.

Placed training against the reference's ``train_step`` over params read
back from its sharded store (``__graft_entry__.py:121-134``): FF and
logistic regression with data-parallel inputs and replicated params,
three chained steps, the loss and every updated param within 1e-5 of the
reference's (``tests/test_torch_train.py``'s limit); the replicas of
every param hold the same bits after each step.
"""

import jax
import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.models.ff import FFModel as JaxFF
from netsdb_tpu.models.logreg import LogRegModel as JaxLogReg
from netsdb_tpu.parallel.placement import Placement as JaxPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.models.logreg import LogRegModel
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, clear_gather_log,
                                            gather_log, make_mesh,
                                            virtual_devices)
from netsdb_tpu_torch.parallel.placed_ops import host_array
from netsdb_tpu_torch.parallel.placement import Placement

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture()
def mesh4():
    clear_gather_log()
    with virtual_devices(4, "cpu"):
        yield make_mesh((2, 2), ("data", "model"))


def ints(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -8, 8, shape).astype(np.float32))


def placed(x, mesh, spec):
    return ShardedTensor.from_dense(x, mesh, spec)


def mm(x, y):
    return x @ y


def test_rule_per_position(mesh4):
    a, b, bias = ints((8, 6), 1), ints((6, 4), 2), ints((8, 1), 3)
    pa = placed(a, mesh4, ("data", None))
    prod = placed_ops.matmul(pa, placed(b, mesh4, (None, "model")), mm,
                             op="t")
    assert prod.spec == ("data", "model")
    assert torch.equal(prod.to_dense(), a @ b)
    summed = placed_ops.elementwise(torch.add, pa, bias[:, :1], op="t")
    assert summed.spec == ("data", None)
    assert torch.equal(summed.to_dense(), a + bias)
    soft = placed_ops.elementwise(lambda t: torch.softmax(t, 1), pa, op="t",
                                  whole_dims=(1,))
    assert soft.spec == ("data", None)
    assert torch.equal(soft.to_dense(), torch.softmax(a, 1))
    assert gather_log() == []


@pytest.mark.parametrize("sides", ["both", "left", "right"])
def test_rule_psum(mesh4, sides):
    a, b = ints((4, 8), 4), ints((8, 6), 5)
    pa = placed(a, mesh4, (None, "model")) if sides != "right" else a
    pb = placed(b, mesh4, ("model", None)) if sides != "left" else b
    out = placed_ops.matmul(pa, pb, mm, op="t")
    assert out.spec == (None, None)
    assert torch.equal(out.to_dense(), a @ b)
    assert len({id(t) for t in out.shards.flat}) == 1  # one copy a device
    assert gather_log() == []
    real = torch.randn(4, 8), torch.randn(8, 6)
    np.testing.assert_allclose(
        placed_ops.matmul(placed(real[0], mesh4, (None, "model")),
                          placed(real[1], mesh4, ("model", None)), mm,
                          op="t").to_dense().numpy(),
        (real[0] @ real[1]).numpy(), rtol=1e-5, atol=1e-5)


def test_rule_counted_gather(mesh4):
    a, b = ints((8, 8), 6), ints((8, 4), 7)
    pa = placed(a, mesh4, (None, "data"))
    out = placed_ops.matmul(pa, placed(b, mesh4, ("model", None)), mm,
                            op="mine")
    assert isinstance(out, torch.Tensor) and torch.equal(out, a @ b)
    mixed = placed_ops.elementwise(torch.add, pa,
                                   placed(a, mesh4, ("data", None)),
                                   op="add")
    assert torch.equal(mixed, a + a)
    soft = placed_ops.elementwise(lambda t: torch.softmax(t, 1), pa,
                                  op="soft", whole_dims=(1,))
    assert torch.equal(soft, torch.softmax(a, 1))
    log = {e["op"]: e for e in gather_log()}
    assert set(log) == {"mine", "add", "soft"}
    assert log["mine"]["gathers"] == 2
    assert "P(None,data)" in log["mine"]["reason"]
    assert "P(model,None)" in log["mine"]["reason"]
    assert log["add"]["bytes"] == 2 * a.numel() * 4
    # a slice that cuts a sharded dimension gathers too, logged
    assert torch.equal(pa[:, :5], a[:, :5])
    assert gather_log()[-1]["op"] == "slice"


def _ff(c, placements, rows=20, cls=FFModel):
    rng = np.random.default_rng(0)
    m = cls(db="ff", block=(8, 8))
    m.setup(c, placements=placements)
    m.load_random_weights(c, 16, 24, 8, seed=0)
    m.load_inputs(c, rng.standard_normal((rows, 16)).astype(np.float32))
    c.create_set("ff", "labels", placement=(placements or {}).get("labels"))
    onehot = np.zeros((8, rows), np.float32)
    onehot[rng.integers(0, 8, rows), np.arange(rows)] = 1.0
    c.send_matrix("ff", "labels", onehot, (8, 8))
    return m


def _dp_ff(cls=Placement):
    rep = cls.replicated(ndim=2, n_devices=4) if cls is JaxPlacement \
        else cls.replicated()
    n = 4 if cls is JaxPlacement else 0
    return {"inputs": cls.data_parallel(ndim=2, n_devices=n), "w1": rep,
            "b1": rep, "wo": rep, "bo": rep,
            "output": cls((("data", n),), (None, "data")),
            "labels": cls((("data", n),), (None, "data"))}


def test_data_parallel_ff_logs_no_gather_and_one_device_leaves_it_empty(
        tmp_path):
    clear_gather_log()
    solo = Client(Configuration(root_dir=str(tmp_path / "solo")),
                  device="cpu")
    want = host_array(_ff(solo, None).inference(solo))
    assert gather_log() == []
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "dp")),
                   device="cpu")
        m = _ff(c, _dp_ff())
        out = m.inference(c)
        assert out.data.spec == (None, "data")
        m.train_step(m.params_from_store(c), c.get_tensor("ff", "inputs"),
                     c.get_tensor("ff", "labels"))
    assert gather_log() == []
    np.testing.assert_array_equal(host_array(out), want)


def test_model_sharded_w1_logs_its_gathers(tmp_path):
    """The dry run's layout: inference runs per position and by the psum
    (no gather); the training step gathers the sharded params and inputs
    onto the first position, each logged with the reason, and writes the
    new params back in their layouts."""
    axes = (("data", 2), ("model", 2))
    pls = {"inputs": Placement(axes, ("data", None)),
           "w1": Placement(axes, ("model", None)),
           "b1": Placement(axes, (None, None)),
           "wo": Placement(axes, (None, "model")),
           "bo": Placement(axes, (None, None)),
           "labels": Placement(axes, (None, "data"))}
    solo = Client(Configuration(root_dir=str(tmp_path / "solo")),
                  device="cpu")
    ms = _ff(solo, None)
    want_out = host_array(ms.inference(solo))
    want, want_loss = ms.train_step(ms.params_from_store(solo),
                                    solo.get_tensor("ff", "inputs"),
                                    solo.get_tensor("ff", "labels"))
    clear_gather_log()
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "mp")),
                   device="cpu")
        m = _ff(c, pls)
        np.testing.assert_allclose(host_array(m.inference(c)), want_out,
                                   **TOL)
        assert gather_log() == []
        new, loss = m.train_step(m.params_from_store(c),
                                 c.get_tensor("ff", "inputs"),
                                 c.get_tensor("ff", "labels"))
    log = gather_log()
    assert log and {e["op"] for e in log} == {"train_step"}
    assert all("not data-parallel" in e["reason"] for e in log)
    assert any("P(model,None)" in e["reason"] for e in log)
    assert new.w1.data.spec == ("model", None)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    for name in ("w1", "b1", "wo", "bo"):
        np.testing.assert_allclose(host_array(getattr(new, name).data),
                                   getattr(want, name).data.numpy(), **TOL)


def _replicas_equal(params):
    for f in ("w1", "b1", "wo", "bo"):
        d = getattr(params, f).data
        first = d.first()
        assert all(torch.equal(t, first) for t in d.shards.flat)


def test_placed_ff_training_matches_the_reference(tmp_path):
    """Three data-parallel steps against the reference's steps over
    params read back from its sharded store; the replicas stay
    bit-identical."""
    clear_compiled_cache()
    jc = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    jm = _ff(jc, _dp_ff(JaxPlacement), cls=JaxFF)
    jp = jm.params_from_store(jc)
    jx, jy = jc.get_tensor("ff", "inputs"), jc.get_tensor("ff", "labels")
    step = jax.jit(jm.train_step)
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "port")),
                   device="cpu")
        m = _ff(c, _dp_ff())
        p = m.params_from_store(c)
        x, y = c.get_tensor("ff", "inputs"), c.get_tensor("ff", "labels")
        for _ in range(3):
            jp, jloss = step(jp, jx, jy)
            p, loss = m.train_step(p, x, y)
            _replicas_equal(p)
            np.testing.assert_allclose(float(loss), float(jloss), **TOL)
            for f in ("w1", "b1", "wo", "bo"):
                np.testing.assert_allclose(
                    host_array(getattr(p, f).data),
                    np.asarray(getattr(jp, f).data), **TOL)


@pytest.mark.parametrize("rows", [32, 27])
def test_placed_logreg_training_matches_the_reference(tmp_path, rows):
    clear_compiled_cache()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((rows, 13)).astype(np.float32)
    w = rng.standard_normal(13).astype(np.float32)
    y = rng.integers(0, 2, rows).astype(np.float32)
    jc = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    jm = JaxLogReg(db="lr", block=(8, 8))
    jm.setup(jc, placements={"inputs": JaxPlacement.data_parallel(
        ndim=2, n_devices=4)})
    jm.load_weights(jc, w, 0.25)
    jm.load_inputs(jc, x)
    jp, jx = jm.params_from_store(jc), jc.get_tensor("lr", "inputs")
    clear_gather_log()
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "port")),
                   device="cpu")
        m = LogRegModel(db="lr", block=(8, 8))
        m.setup(c, placements={"inputs": Placement.data_parallel(ndim=2)})
        m.load_weights(c, w, 0.25)
        m.load_inputs(c, x)
        p, px = m.params_from_store(c), c.get_tensor("lr", "inputs")
        for _ in range(3):
            jp, jloss = jax.jit(jm.train_step)(jp, jx, y)
            p, loss = m.train_step(p, px, y)
            np.testing.assert_allclose(float(loss), float(jloss), **TOL)
            for f in ("w", "b"):
                np.testing.assert_allclose(
                    getattr(p, f).data.numpy(),
                    np.asarray(getattr(jp, f).data), **TOL)
    assert gather_log() == []
