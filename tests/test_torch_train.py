"""Training through the port against the JAX package on the CPU: the same
numpy params and inputs go through ``jax.value_and_grad`` of the
reference's ``loss`` (its ``train_step``) and through the port's
``train_step``, and the loss and every updated param (the whole padded
data) must agree over two chained steps — FF and logistic regression in
f32 within 1e-5 abs, the transformer layer (embed 32, 2 heads, seq 64)
within 1e-4 abs. Also: B1's autograd node against a float64 gradient
check, B2's refusal under grad, inference tensors refused, and the
port's ``graft_entry`` against the repository's ``__graft_entry__``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.models.ff import FFModel as JaxFF, FFParams as JaxFFParams
from netsdb_tpu.models.logreg import (LogRegModel as JaxLogReg,
                                      LogRegParams as JaxLogRegParams)
from netsdb_tpu.models.transformer import (
    TransformerLayerModel as JaxLayer,
    TransformerLayerParams as JaxLayerParams)
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.graft_entry import dryrun_multichip, entry
from netsdb_tpu_torch.models.ff import FFModel, FFParams
from netsdb_tpu_torch.models.logreg import LogRegModel, LogRegParams
from netsdb_tpu_torch.models.transformer import (TransformerLayerModel,
                                                 TransformerLayerParams)
from netsdb_tpu_torch.ops.attention import attention
from netsdb_tpu_torch.ops.cuda_kernels import (FlashAttentionFunction,
                                               flash_attention_step)
from netsdb_tpu_torch.weights import (ff_params_from_numpy, logical,
                                      params_to_numpy)

TOL = dict(rtol=0, atol=1e-5)
LAYER_TOL = dict(rtol=0, atol=1e-4)

# the _tiny_model shapes of __graft_entry__.py, and a ragged batch of 13
# rows under blocks of 8 (its padded batch columns are masked whole)
FF_SIZES = {"tiny": dict(features=16, hidden=32, labels=8, batch=16),
            "ragged": dict(features=13, hidden=27, labels=5, batch=13)}
LOGREG_SIZES = {"aligned": dict(features=16, rows=16),
                "ragged": dict(features=13, rows=11)}
BLOCK = (8, 8)


@pytest.fixture()
def port_client(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def both_blocked(dense, block):
    return (JaxBlocked.from_dense(dense, block),
            BlockedTensor.from_dense(dense, block, device="cpu"))


def onehot(rng, labels, batch):
    y = np.zeros((labels, batch), np.float32)
    y[rng.integers(0, labels, batch), np.arange(batch)] = 1.0
    return y


def ff_pair(size, seed=0):
    rng = np.random.default_rng(seed)
    f, h, lb, b = (size[k] for k in ("features", "hidden", "labels", "batch"))
    dense = dict(w1=rng.standard_normal((h, f)) * 0.3,
                 b1=rng.standard_normal((h, 1)) * 0.1,
                 wo=rng.standard_normal((lb, h)) * 0.3,
                 bo=rng.standard_normal((lb, 1)) * 0.1)
    blocks = dict(w1=BLOCK, b1=(BLOCK[0], 1), wo=BLOCK, bo=(BLOCK[0], 1))
    pairs = {n: both_blocked(a.astype(np.float32), blocks[n])
             for n, a in dense.items()}
    x = both_blocked(rng.standard_normal((b, f)).astype(np.float32), BLOCK)
    y = both_blocked(onehot(rng, lb, b), BLOCK)
    return (JaxFFParams(**{n: p[0] for n, p in pairs.items()}),
            FFParams(**{n: p[1] for n, p in pairs.items()}), x, y)


def close_blocked(ours: BlockedTensor, ref, tol=TOL):
    assert ours.shape == tuple(ref.shape)
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(ref.data), **tol)
    assert torch.isfinite(ours.data).all()
    assert torch.count_nonzero(ours.data * (1 - ours.mask())) == 0


@pytest.mark.parametrize("size", sorted(FF_SIZES))
def test_ff_train_steps_match_jax(size):
    jp, pp, (jx, px), (jy, py) = ff_pair(FF_SIZES[size])
    jm, pm = JaxFF(block=BLOCK), FFModel(block=BLOCK)
    np.testing.assert_allclose(float(pm.loss(pp, px, py)),
                               float(jm.loss(jp, jx, jy)), **TOL)
    for _ in range(2):  # chained: each step starts from the last one's params
        jp, jl = jm.train_step(jp, jx, jy)
        pp, pl = pm.train_step(pp, px, py)
        np.testing.assert_allclose(float(pl), float(jl), **TOL)
        for name in ("w1", "b1", "wo", "bo"):
            close_blocked(getattr(pp, name), getattr(jp, name))
            assert not getattr(pp, name).data.requires_grad


def logreg_pair(size, seed=0):
    rng = np.random.default_rng(seed)
    f, n = size["features"], size["rows"]
    w = both_blocked((rng.standard_normal((1, f)) * 0.3).astype(np.float32),
                     (1, BLOCK[1]))
    b = both_blocked(np.array([[0.1]], np.float32), (1, 1))
    x = both_blocked(rng.standard_normal((n, f)).astype(np.float32), BLOCK)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return (JaxLogRegParams(w=w[0], b=b[0]), LogRegParams(w=w[1], b=b[1]),
            x, y)


@pytest.mark.parametrize("size", sorted(LOGREG_SIZES))
def test_logreg_train_steps_match_jax(size):
    jp, pp, (jx, px), y = logreg_pair(LOGREG_SIZES[size])
    jm, pm = JaxLogReg(block=BLOCK), LogRegModel(block=BLOCK)
    for _ in range(2):
        jp, jl = jm.train_step(jp, jx, jnp.asarray(y))
        pp, pl = pm.train_step(pp, px, torch.from_numpy(y))
        np.testing.assert_allclose(float(pl), float(jl), **TOL)
        close_blocked(pp.w, jp.w)
        close_blocked(pp.b, jp.b)


def layer_pair(batch, seq, embed=32, seed=0):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal(s) * embed ** -0.5).astype(np.float32)
         for n, s in (("w_qkv", (embed, 3 * embed)), ("w_out", (embed, embed)),
                      ("w_up", (embed, 4 * embed)),
                      ("w_down", (4 * embed, embed)))}
    x, t = (rng.standard_normal((batch, seq, embed)).astype(np.float32)
            for _ in range(2))
    return (JaxLayerParams(**{n: jnp.asarray(a) for n, a in w.items()}),
            TransformerLayerParams(**{n: torch.from_numpy(a)
                                      for n, a in w.items()}), x, t)


@pytest.mark.parametrize("batch,seq", [(2, 64), (1, 32)])
def test_transformer_train_steps_match_jax(batch, seq):
    jp, pp, x, t = layer_pair(batch, seq)
    jm, pm = JaxLayer(num_heads=2), TransformerLayerModel(num_heads=2)
    for _ in range(2):
        jp, jl = jm.train_step(jp, jnp.asarray(x), jnp.asarray(t))
        pp, pl = pm.train_step(pp, torch.from_numpy(x), torch.from_numpy(t))
        np.testing.assert_allclose(float(pl), float(jl), **LAYER_TOL)
        ours = params_to_numpy(pp)
        for name, value in ours.items():
            np.testing.assert_allclose(value, np.asarray(getattr(jp, name)),
                                       **LAYER_TOL)


@pytest.mark.parametrize("causal,blocks", [(True, (8, 8)), (False, (8, 8)),
                                           (True, (16, 8))])
def test_flash_attention_function_gradients(causal, blocks):
    """B1's autograd node on CPU tensors (the forward is then the plain
    version, the backward its recompute): a float64 gradient check, and
    its gradients against autograd through the plain softmax attention."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 16, 4, generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))

    def node(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, None, *blocks)

    assert torch.autograd.gradcheck(node, (q, k, v))
    g = torch.randn(1, 2, 16, 4, generator=gen, dtype=torch.float64)
    ours = torch.autograd.grad(node(q, k, v), (q, k, v), g)
    ref = torch.autograd.grad(attention(q, k, v, causal), (q, k, v), g)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("operand", ["q", "acc"])
def test_flash_attention_step_refuses_grad(operand):
    """B2 writes its carry in place: an operand that requires grad raises
    under grad mode (sequence-parallel training is ROADMAP.md A4), and the
    same call runs under ``torch.no_grad()``."""
    def call():
        t = dict(q=torch.randn(2, 16, 4), k=torch.randn(2, 16, 4),
                 v=torch.randn(2, 16, 4), acc=torch.zeros(2, 16, 4),
                 l=torch.zeros(2, 16, 1), m=torch.full((2, 16, 1), -1e30))
        t[operand].requires_grad_()
        return flash_attention_step(t["q"], t["k"], t["v"], t["acc"], t["l"],
                                    t["m"], 0, 0)

    with pytest.raises(RuntimeError, match="ROADMAP.md A4"):
        call()
    with torch.no_grad():
        acc, l, _ = call()
    assert torch.isfinite(acc / l).all()


def ff_on_clients(port_client, seed=2):
    """The same FF weights, inputs and one-hot labels in a JAX client and
    a port client; ``inference`` runs first on both."""
    size = FF_SIZES["ragged"]
    rng = np.random.default_rng(seed)
    f, h, lb, b = (size[k] for k in ("features", "hidden", "labels", "batch"))
    weights = dict(w1=rng.standard_normal((h, f)).astype(np.float32) * 0.3,
                   b1=rng.standard_normal(h).astype(np.float32) * 0.1,
                   wo=rng.standard_normal((lb, h)).astype(np.float32) * 0.3,
                   bo=rng.standard_normal(lb).astype(np.float32) * 0.1)
    x = rng.standard_normal((b, f)).astype(np.float32)
    y = onehot(rng, lb, b)
    jc = JaxClient(JaxConfiguration(root_dir=str(port_client.config.root_dir)
                                    + "-jax"))
    out = []
    for cls, c in ((JaxFF, jc), (FFModel, port_client)):
        m = cls(block=BLOCK)
        m.setup(c)
        m.load_weights(c, **weights)
        m.load_inputs(c, x)
        m.inference(c)
        c.create_set("ff", "labels")
        c.send_matrix("ff", "labels", y, BLOCK)
        out.append((m, c))
    return out


def test_training_after_inference_on_the_same_client(port_client):
    """Params read back from the store after a DAG ran are ordinary
    tensors: training on them works and matches the reference."""
    (jm, jc), (pm, pc) = ff_on_clients(port_client)
    jp, jl = jm.train_step(jm.params_from_store(jc),
                           jc.get_tensor("ff", "inputs"),
                           jc.get_tensor("ff", "labels"))
    pp, pl = pm.train_step(pm.params_from_store(pc),
                           pc.get_tensor("ff", "inputs"),
                           pc.get_tensor("ff", "labels"))
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    for name in ("w1", "b1", "wo", "bo"):
        close_blocked(getattr(pp, name), getattr(jp, name))
    # the stored params were not touched
    assert not torch.equal(pc.get_tensor("ff", "w1").data, pp.w1.data)


@pytest.mark.parametrize("model", ["ff", "logreg", "transformer"])
def test_inference_tensors_raise(port_client, model):
    """A set written by a DAG holds inference tensors, which autograd
    cannot save: train_step says so instead of failing inside autograd."""
    if model == "ff":
        (_, _), (pm, pc) = ff_on_clients(port_client)
        params = pm.params_from_store(pc)
        written = pc.get_tensor("ff", "output")  # the DAG's output set
        assert written.data.is_inference()
        with pytest.raises(ValueError, match="argument 2 is an inference"):
            pm.train_step(params, pc.get_tensor("ff", "inputs"), written)
        return
    with torch.inference_mode():
        if model == "logreg":
            _, params, (_, x), y = logreg_pair(LOGREG_SIZES["aligned"])
            params = LogRegParams(w=params.w.with_data(params.w.data * 1),
                                  b=params.b)
        else:
            _, params, x, y = layer_pair(1, 32)
            params = TransformerLayerParams(
                w_qkv=params.w_qkv * 1, w_out=params.w_out,
                w_up=params.w_up, w_down=params.w_down)
            x, y = torch.from_numpy(x), torch.from_numpy(y)
    m = LogRegModel(block=BLOCK) if model == "logreg" \
        else TransformerLayerModel(num_heads=2)
    with pytest.raises(ValueError, match=r"params\.w.* is an inference"):
        m.train_step(params, x, y)


def test_entry_matches_reference():
    fn, args = entry(device="cpu")
    ref_fn, ref_args = jax_entry.entry()
    out = fn(*args)
    assert out.device.type == "cpu"
    close_blocked(out, ref_fn(*ref_args))


def test_dryrun_one_device_matches_reference_ff_section(tmp_path):
    """``dryrun_multichip(1)``'s loss is the reference dry run's FF
    section at one device: the same draws, inference, then one step on
    params read back from the store."""
    loss = dryrun_multichip(1, device="cpu")["loss"]
    rng = np.random.default_rng(0)
    c = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    m = JaxFF(db="ff", block=BLOCK)
    m.setup(c)
    m.load_random_weights(c, features=16, hidden=16, labels=8, seed=0)
    m.load_inputs(c, rng.standard_normal((16, 16)).astype(np.float32))
    m.inference(c)
    c.create_set("ff", "labels")
    c.send_matrix("ff", "labels", onehot(rng, 8, 16), BLOCK)
    _, ref = m.train_step(m.params_from_store(c), c.get_tensor("ff", "inputs"),
                          c.get_tensor("ff", "labels"))
    np.testing.assert_allclose(loss, float(ref), **TOL)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_more_devices_raise(n_devices):
    """The dry run over more than one device once raised naming ROADMAP.md
    A4; it is ported: over 2 and 8 CPU positions every section runs and
    its scalars are the reference's (``tests/test_torch_distributed.py``
    holds each against the reference's same calls). Here: the counts and
    row numbers are the one-position run's, and the placed sums agree
    with it where the section's shapes do not depend on n."""
    one = dryrun_multichip(1, device="cpu")
    got = dryrun_multichip(n_devices, device="cpu")
    assert set(got) == set(one)
    assert got["q01_count"] == one["q01_count"]
    assert got["q03_rows"] == one["q03_rows"]
    np.testing.assert_allclose(got["q06_revenue"], one["q06_revenue"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["paged_ff"], one["paged_ff"], rtol=1e-5)
    assert all(np.isfinite(v) for k, v in got.items() if k != "q01_count")


def test_params_to_numpy_round_trip():
    _, pp, _, _ = ff_pair(FF_SIZES["ragged"])
    arrays = params_to_numpy(pp)
    back = ff_params_from_numpy(arrays, device="cpu")
    for name in ("w1", "b1", "wo", "bo"):
        assert torch.equal(getattr(back, name).data, getattr(pp, name).data)
        np.testing.assert_array_equal(logical(arrays[name]),
                                      getattr(pp, name).to_dense().numpy())
    _, lp, _, _ = logreg_pair(LOGREG_SIZES["ragged"])
    w, shape, block = params_to_numpy(lp)["w"]
    assert w.shape == (1, 16) and shape == (1, 13) and block == (1, 8)
