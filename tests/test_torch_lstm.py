"""The LSTM model through the port's database path against the JAX
package's, on the CPU: the same 12 numpy gate weights, state and
inputs, drawn from a seed, go into a JAX ``Client`` and a port
``Client(device="cpu")``. ``lstm_cell``, ``step`` and ``run_sequence``
must agree, f32 within 1e-5; with ``compute_dtype="bfloat16"`` within
2e-2 (the port rounds each product to bf16, the JAX package keeps it
f32). The padded margin of h and c is zero after every step."""

import dataclasses

import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.models.lstm_model import LSTMModel as JaxLSTM
from netsdb_tpu.ops import lstm as jlstm
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models import LSTMModel
from netsdb_tpu_torch.ops import lstm as plstm
from netsdb_tpu_torch.ops.lstm import LSTMParams
from netsdb_tpu_torch.weights import lstm_params_from_numpy

torch.set_num_threads(2)

TOLS = {None: dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=0, atol=2e-2)}
BLOCK = (8, 8)
# "ragged" leaves a margin on hidden, input and batch
SIZES = {"tiny": dict(nin=8, nh=16, batch=8, steps=3),
         "ragged": dict(nin=6, nh=10, batch=5, steps=4)}


@pytest.fixture()
def port_client(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def draw(size, seed):
    s = SIZES[size]
    rng = np.random.default_rng(seed)
    nin, nh, b = s["nin"], s["nh"], s["batch"]
    w = {}
    for g in "ifco":
        w[f"w_{g}"] = (rng.standard_normal((nh, nin))
                       / np.sqrt(nin)).astype(np.float32)
        w[f"u_{g}"] = (rng.standard_normal((nh, nh))
                       / np.sqrt(nh)).astype(np.float32)
        w[f"b_{g}"] = rng.standard_normal(nh).astype(np.float32) * 0.1
    h0 = rng.standard_normal((nh, b)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((nh, b)).astype(np.float32) * 0.5
    xs = rng.standard_normal((s["steps"], nin, b)).astype(np.float32)
    return w, h0, c0, xs


def pair(client, port_client, size, seed, compute_dtype=None):
    w, h0, c0, xs = draw(size, seed)
    models = []
    for cls, c in ((JaxLSTM, client), (LSTMModel, port_client)):
        m = cls(block=BLOCK, compute_dtype=compute_dtype)
        m.setup(c)
        m.load_weights(c, w)
        m.load_state(c, h0, c0)
        models.append(m)
    return models, xs


def zero_margin(t: BlockedTensor) -> bool:
    return torch.count_nonzero(t.data * (1 - t.mask())) == 0


def close(ours, ref, tol):
    """A port BlockedTensor against a JAX one, margin included."""
    assert ours.shape == tuple(ref.shape)
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(ref.data),
                               **tol)
    assert zero_margin(ours)


@pytest.mark.parametrize("activation", ["sigmoid", "tanh"])
def test_three_way_sum_matches_jax(activation):
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((10, 5)).astype(np.float32) for _ in "ab")
    bias = rng.standard_normal((10, 1)).astype(np.float32)
    got = plstm.three_way_sum(*(BlockedTensor.from_dense(v, BLOCK)
                                for v in (a, b)),
                              BlockedTensor.from_dense(bias, (8, 1)),
                              activation)
    ref = jlstm.three_way_sum(*(JaxBlocked.from_dense(v, BLOCK)
                                for v in (a, b)),
                              JaxBlocked.from_dense(bias, (8, 1)), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOLS[None])
    with pytest.raises(ValueError):
        plstm.three_way_sum(BlockedTensor.from_dense(a, BLOCK),
                            BlockedTensor.from_dense(b, BLOCK),
                            BlockedTensor.from_dense(bias, (8, 1)), "relu")


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_cell_with_carried_params_matches_jax(client, port_client, size,
                                              compute_dtype):
    (jm, pm), xs = pair(client, port_client, size, 1)
    jp = jm.params_from_store(client)
    carried = lstm_params_from_numpy(
        {f.name: (np.asarray(getattr(jp, f.name).data),
                  getattr(jp, f.name).meta.shape,
                  getattr(jp, f.name).meta.block_shape)
         for f in dataclasses.fields(LSTMParams)}, device="cpu")
    stored = pm.params_from_store(port_client)
    for f in dataclasses.fields(LSTMParams):
        assert torch.equal(getattr(carried, f.name).data,
                           getattr(stored, f.name).data)
    h, c = (port_client.get_tensor("lstm", n) for n in ("h", "c"))
    jh, jc = (client.get_tensor("lstm", n) for n in ("h", "c"))
    got = plstm.lstm_cell(carried, BlockedTensor.from_dense(xs[0], BLOCK),
                          h, c, compute_dtype)
    ref = jlstm.lstm_cell(jp, JaxBlocked.from_dense(xs[0], BLOCK), jh, jc,
                          compute_dtype)
    for ours, theirs in zip(got, ref):
        close(ours, theirs, TOLS[compute_dtype])


@pytest.mark.parametrize("size", sorted(SIZES))
def test_step_matches_jax_and_writes_the_state_sets(client, port_client,
                                                    size):
    (jm, pm), xs = pair(client, port_client, size, 2)
    h2, c2 = pm.step(port_client, xs[0])
    jh2, jc2 = jm.step(client, xs[0])
    close(h2, jh2, TOLS[None])
    close(c2, jc2, TOLS[None])
    assert port_client.get_tensor("lstm", "h_out") is h2
    assert port_client.get_tensor("lstm", "c_out") is c2
    # the stored state is read, not changed
    assert port_client.get_tensor("lstm", "h").shape == h2.shape


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_run_sequence_matches_jax(client, port_client, size, compute_dtype):
    (jm, pm), xs = pair(client, port_client, size, 3, compute_dtype)
    h, c, hs = pm.run_sequence(port_client, xs)
    jh, jc, jhs = jm.run_sequence(client, xs)
    tol = TOLS[compute_dtype]
    close(h, jh, tol)
    close(c, jc, tol)
    assert tuple(hs.shape) == tuple(jhs.shape)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), **tol)
    # every step's h keeps a zero margin (the re-mask of each step)
    for t in range(hs.shape[0]):
        assert zero_margin(h.with_data(hs[t]))
    # a torch input gives the same sequence
    h_t, _, _ = pm.run_sequence(port_client, torch.as_tensor(xs))
    assert torch.equal(h_t.data, h.data)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_unroll_equals_the_cell_step_by_step(client, port_client,
                                             compute_dtype):
    """lstm_unroll rounds the weights and xs once for the sequence; the
    values are those of calling the cell step by step, bit for bit."""
    (_, pm), xs = pair(client, port_client, "ragged", 5)
    params = pm.params_from_store(port_client)
    h, c = (port_client.get_tensor("lstm", n) for n in ("h", "c"))
    xb = [BlockedTensor.from_dense(x, BLOCK) for x in xs]
    hu, cu, hs = plstm.lstm_unroll(params, torch.stack([b.data for b in xb]),
                                   h, c, compute_dtype)
    for t, x in enumerate(xb):
        h, c = plstm.lstm_cell(params, x, h, c, compute_dtype)
        assert torch.equal(hs[t], h.data)
    assert torch.equal(hu.data, h.data) and torch.equal(cu.data, c.data)
    assert params.w_i.dtype == torch.float32  # the stored weights stay f32


def test_run_sequence_matches_numpy_oracle(port_client):
    """The reference test's f64 oracle (tests/test_models.py), from a
    zero state."""
    w, _, _, xs = draw("ragged", 4)
    nh, b = SIZES["ragged"]["nh"], SIZES["ragged"]["batch"]
    pm = LSTMModel(block=BLOCK)
    pm.setup(port_client)
    pm.load_weights(port_client, w)
    pm.load_state(port_client, np.zeros((nh, b), np.float32),
                  np.zeros((nh, b), np.float32))
    h_np, c_np = np.zeros((nh, b)), np.zeros((nh, b))

    def sig(v):
        return 1 / (1 + np.exp(-v))

    for x in xs:
        gi, gf, go = (sig(w[f"w_{g}"] @ x + w[f"u_{g}"] @ h_np
                          + w[f"b_{g}"][:, None]) for g in "ifo")
        gg = np.tanh(w["w_c"] @ x + w["u_c"] @ h_np + w["b_c"][:, None])
        c_np = gf * c_np + gi * gg
        h_np = go * np.tanh(c_np)
    h, c, _ = pm.run_sequence(port_client, xs)
    np.testing.assert_allclose(h.to_dense().numpy(), h_np, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.to_dense().numpy(), c_np, rtol=1e-5,
                               atol=1e-6)
