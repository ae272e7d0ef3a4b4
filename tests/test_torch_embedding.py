"""The embedding model families through the port's database path against
the JAX package's, on the CPU: logistic regression, word2vec and the
text classifier. The same numpy weights and inputs, drawn from a seed,
go into a JAX ``Client`` and a port ``Client(device="cpu")``; every DAG
and every pure, lookup and sparse form must agree, f32 within 1e-5
(bf16 within one bf16 rounding of the product), padded margins
included. A one-hot product and a gather pick table rows exactly."""

import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.models.logreg import LogRegModel as JaxLogReg
from netsdb_tpu.models.text_classifier import \
    TextClassifierModel as JaxTextClassifier
from netsdb_tpu.models.word2vec import Word2VecModel as JaxWord2Vec
from netsdb_tpu.ops import embedding as jemb
from netsdb_tpu.ops import linalg as jlinalg
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models import (LogRegModel, LSTMModel,
                                     TextClassifierModel, Word2VecModel)
from netsdb_tpu_torch.ops import embedding as emb
from netsdb_tpu_torch.ops.linalg import transpose
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.weights import logreg_params_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 products: the port rounds the product to bf16 (cuBLAS returns
# bf16), the JAX package keeps it f32; outputs here are sigmoid or
# softmax probabilities
BF16_TOL = dict(rtol=0, atol=2e-2)

# block (8, 8) as tests/test_models.py; "ragged" leaves a margin on
# every dimension
SIZES = {"tiny": dict(vocab=32, dim=16, classes=8, batch=16, features=16),
         "ragged": dict(vocab=29, dim=11, classes=3, batch=5, features=13)}
BLOCK = (8, 8)


@pytest.fixture()
def port_client(tmp_path):
    # the JAX executor caches a compiled plan per job name and plan shape
    clear_compiled_cache()
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def close(ours, ref, tol=TOL):
    """A port BlockedTensor against a JAX one: shape, blocks, data
    (margin included) and a zero margin."""
    assert ours.shape == tuple(ref.shape)
    assert ours.meta.block_shape == tuple(ref.meta.block_shape)
    np.testing.assert_allclose(ours.data.float().numpy(),
                               np.asarray(ref.data, np.float32), **tol)
    assert torch.count_nonzero(ours.data * (1 - ours.mask())) == 0


def draw(size, seed):
    rng = np.random.default_rng(seed)
    v, d, c, b = (size[k] for k in ("vocab", "dim", "classes", "batch"))
    table = rng.standard_normal((v, d)).astype(np.float32)
    fc_w = (rng.standard_normal((c, d)) / np.sqrt(d)).astype(np.float32)
    fc_b = rng.standard_normal(c).astype(np.float32) * 0.1
    ids = rng.integers(0, v, b)
    ids[0] = v - 1  # the last row, next to the margin
    return table, fc_w, fc_b, ids


def bags(rng, vocab, docs):
    """A bag of words: ascending segment ids, the last document empty."""
    nnz = 3 * docs
    seg = np.sort(rng.integers(0, docs - 1, nnz))
    return rng.integers(0, vocab, nnz), seg


# --- ops ------------------------------------------------------------------
@pytest.mark.parametrize("size", sorted(SIZES))
def test_transpose_and_one_hot_match_jax(size):
    s = SIZES[size]
    table, _, _, ids = draw(s, 0)
    jt = jlinalg.transpose(JaxBlocked.from_dense(table, (8, 4)))
    close(transpose(BlockedTensor.from_dense(table, (8, 4))), jt)
    np.testing.assert_array_equal(
        emb.one_hot_matrix(ids, s["vocab"]).numpy(),
        np.asarray(jemb.one_hot_matrix(ids, s["vocab"])))
    assert emb.one_hot_matrix(torch.as_tensor(ids), 40).dtype == torch.float32


@pytest.mark.parametrize("size", sorted(SIZES))
def test_embedding_matmul_and_lookup_match_jax(size):
    s = SIZES[size]
    table, _, _, ids = draw(s, 1)
    onehot = np.asarray(jemb.one_hot_matrix(ids, s["vocab"]))
    ref = jemb.embedding_matmul(JaxBlocked.from_dense(table, BLOCK),
                                JaxBlocked.from_dense(onehot, BLOCK))
    out = emb.embedding_matmul(BlockedTensor.from_dense(table, BLOCK),
                               BlockedTensor.from_dense(onehot, BLOCK))
    close(out, ref)
    np.testing.assert_array_equal(out.to_dense().numpy(), table[ids])
    got = emb.embedding_lookup(BlockedTensor.from_dense(table, BLOCK),
                               ids.reshape(-1, 1))
    assert tuple(got.shape) == (len(ids), 1, s["dim"])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jemb.embedding_lookup(
            JaxBlocked.from_dense(table, BLOCK), ids.reshape(-1, 1))))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_embedding_lookup_sparse_matches_jax(combiner):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((29, 11)).astype(np.float32)
    ids, seg = bags(rng, 29, 6)
    ref = np.asarray(jemb.embedding_lookup_sparse(
        JaxBlocked.from_dense(table, BLOCK), ids, seg, 6, combiner))
    got = emb.embedding_lookup_sparse(BlockedTensor.from_dense(table, BLOCK),
                                      ids, seg, 6, combiner).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[-1].any()  # the empty document reads 0
    with pytest.raises(ValueError):
        emb.embedding_lookup_sparse(BlockedTensor.from_dense(table, BLOCK),
                                    ids, seg, 6, "max")


@pytest.mark.parametrize("bad", ["id", "negative_id", "segment"])
def test_ids_out_of_range_raise(bad):
    """On the card an out-of-range gather or scatter index is a device
    assert; the port checks first and raises. The reference does not
    raise: ``jnp.take`` wraps a negative id to count from the end, gives
    a NaN row for an id >= vocab, and ``segment_sum`` drops out-of-range
    segment ids."""
    table = BlockedTensor.from_dense(np.ones((29, 11), np.float32), BLOCK)
    ids, seg = np.array([0, 3, 28]), np.array([0, 0, 1])
    if bad == "segment":
        with pytest.raises(IndexError, match="segment_ids"):
            emb.embedding_lookup_sparse(table, ids, seg, 1)
        return
    ids[1] = 29 if bad == "id" else -1
    with pytest.raises(IndexError, match=r"ids must lie in \[0, 29\)"):
        emb.embedding_lookup(table, ids)
    with pytest.raises(IndexError, match="ids"):
        emb.embedding_lookup_sparse(table, ids, seg, 2)


# --- logistic regression --------------------------------------------------
def logreg_pair(client, port_client, size, seed, compute_dtype=None):
    s = SIZES[size]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(s["features"])
         / np.sqrt(s["features"])).astype(np.float32)
    x = rng.standard_normal((s["batch"], s["features"])).astype(np.float32)
    models = []
    for cls, c in ((JaxLogReg, client), (LogRegModel, port_client)):
        m = cls(block=BLOCK, compute_dtype=compute_dtype)
        m.setup(c)
        m.load_weights(c, w, 0.3)
        m.load_inputs(c, x)
        models.append(m)
    return models, w, x


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_logreg_inference_matches_jax(client, port_client, size,
                                      compute_dtype):
    (jm, pm), w, x = logreg_pair(client, port_client, size, 3, compute_dtype)
    out = pm.inference(port_client)
    close(out, jm.inference(client), TOL if compute_dtype is None
          else BF16_TOL)
    assert port_client.get_tensor("logreg", "output") is out
    if compute_dtype is None:
        np.testing.assert_allclose(out.to_dense().numpy().ravel(),
                                   1 / (1 + np.exp(-(x @ w + 0.3))), **TOL)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_logreg_forward_and_carried_params_match_jax(client, port_client,
                                                     size):
    (jm, pm), _, x = logreg_pair(client, port_client, size, 4)
    jp = jm.params_from_store(client)
    ref = jm.forward(jp, JaxBlocked.from_dense(x, BLOCK))
    xb = BlockedTensor.from_dense(x, BLOCK)
    close(pm.forward(pm.params_from_store(port_client), xb), ref)
    carried = logreg_params_from_numpy(
        {n: (np.asarray(getattr(jp, n).data), getattr(jp, n).meta.shape,
             getattr(jp, n).meta.block_shape) for n in ("w", "b")},
        device="cpu")
    close(pm.forward(carried, xb), ref)


# --- word2vec -------------------------------------------------------------
def word2vec_pair(client, port_client, size, seed):
    s = SIZES[size]
    table, _, _, ids = draw(s, seed)
    models = []
    for cls, c in ((JaxWord2Vec, client), (Word2VecModel, port_client)):
        m = cls(block=BLOCK)
        m.setup(c)
        m.load_embeddings(c, table)
        models.append(m)
    return models, table, ids


@pytest.mark.parametrize("size", sorted(SIZES))
def test_word2vec_dag_matches_jax(client, port_client, size):
    (jm, pm), table, ids = word2vec_pair(client, port_client, size, 5)
    jm.load_onehot_inputs(client, ids, SIZES[size]["vocab"])
    pm.load_onehot_inputs(port_client, ids, SIZES[size]["vocab"])
    out = pm.inference(port_client)
    close(out, jm.inference(client))
    np.testing.assert_array_equal(out.to_dense().numpy(), table[ids])
    assert out.device.type == "cpu"


@pytest.mark.parametrize("size", sorted(SIZES))
def test_word2vec_lookup_matches_jax(client, port_client, size):
    (jm, pm), table, ids = word2vec_pair(client, port_client, size, 6)
    for got in (pm.lookup(port_client, ids),
                pm.lookup(port_client, torch.as_tensor(ids))):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jm.lookup(client, ids)))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_word2vec_lookup_sparse_matches_jax(client, port_client, combiner):
    (jm, pm), table, _ = word2vec_pair(client, port_client, "ragged", 7)
    ids, seg = bags(np.random.default_rng(7), SIZES["ragged"]["vocab"], 4)
    np.testing.assert_allclose(
        pm.lookup_sparse(port_client, ids, seg, 4, combiner).numpy(),
        np.asarray(jm.lookup_sparse(client, ids, seg, 4, combiner)), **TOL)


# --- text classifier ------------------------------------------------------
def text_pair(client, port_client, size, seed):
    s = SIZES[size]
    table, fc_w, fc_b, ids = draw(s, seed)
    models = []
    for cls, c in ((JaxTextClassifier, client),
                   (TextClassifierModel, port_client)):
        m = cls(block=BLOCK)
        m.setup(c)
        m.load_weights(c, table, fc_w, fc_b)
        models.append(m)
    return models, ids


@pytest.mark.parametrize("size", sorted(SIZES))
def test_text_classifier_dag_matches_jax(client, port_client, size):
    (jm, pm), ids = text_pair(client, port_client, size, 8)
    jm.load_onehot_inputs(client, ids, SIZES[size]["vocab"])
    pm.load_onehot_inputs(port_client, ids, SIZES[size]["vocab"])
    out = pm.inference(port_client)
    close(out, jm.inference(client))
    assert out.shape == (SIZES[size]["classes"], len(ids))
    np.testing.assert_allclose(out.to_dense().sum(0).numpy(), 1.0, **TOL)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_bag_of_words_and_classifier_match_jax(client, port_client, size):
    (jm, pm), _ = text_pair(client, port_client, size, 9)
    s = SIZES[size]
    ids, seg = bags(np.random.default_rng(9), s["vocab"], 5)
    got = pm.classify_bag_of_words(port_client, ids, seg, 5)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.classify_bag_of_words(client, ids, seg,
                                                          5)))
    feats = np.random.default_rng(10).standard_normal(
        (7, s["dim"])).astype(np.float32)
    close(pm.semantic_classifier(BlockedTensor.from_dense(feats, BLOCK),
                                 port_client.get_tensor("textcls", "fc_w"),
                                 port_client.get_tensor("textcls", "fc_b")),
          jm.semantic_classifier(JaxBlocked.from_dense(feats, BLOCK),
                                 client.get_tensor("textcls", "fc_w"),
                                 client.get_tensor("textcls", "fc_b")))


def test_plans_have_the_reference_labels():
    from netsdb_tpu_torch.plan.planner import plan_from_sinks

    for model, labels in (
            (LogRegModel(), ("FFTransposeMult", "FFTransposeBiasSumSigmoid")),
            (Word2VecModel(), ("FFTransposeMult",)),
            (TextClassifierModel(), ("Word2Vec", "SemanticClassifierMatmul",
                                     "SemanticClassifierSoftmax"))):
        text = plan_from_sinks([model.build_inference_dag()]).to_plan_string()
        assert all(label in text for label in labels)


@pytest.mark.parametrize("cls, placed", [(LogRegModel, "w"),
                                         (Word2VecModel, "weights"),
                                         (LSTMModel, "w_i")])
def test_placements_raise_naming_a4(port_client, cls, placed):
    """Placed model sets once raised naming ROADMAP.md A4 part 3; they are
    ported: a placement creates the set placed over the mesh (the catalog
    keeps it under "sharding"), and None an unplaced set. The placed
    requests' parity is ``tests/test_torch_placed_workloads.py``."""
    from netsdb_tpu_torch.parallel.mesh import virtual_devices
    from netsdb_tpu_torch.storage.store import SetIdentifier

    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=port_client.config.root_dir
                                 + "-placed"), device="cpu")
        cls().setup(c, placements={placed: Placement.replicated()})
        assert c.store.placement_of(SetIdentifier(cls().db, placed)) == \
            Placement.replicated()
        assert c.catalog.get_set(cls().db, placed)["meta"]["sharding"] == \
            Placement.replicated().to_meta()
    cls().setup(port_client, placements={placed: None})
    assert port_client.catalog.set_exists(cls().db, placed)
    assert port_client.store.placement_of(
        SetIdentifier(cls().db, placed)) is None
