"""The model families and the workloads over placed sets, the port
against the JAX package on the CPU (``tests/test_placed_workloads.py``
and ``tests/test_placement_api.py:423-450``).

Each case creates the reference test's sets with its placements in both
packages — the JAX side on ``tests/conftest.py``'s virtual CPU devices,
the port inside ``virtual_devices(n, "cpu")`` — sends the same numpy
data made from a seed, runs the same entry point, and holds the port's
placed result to the reference's placed result within the reference
test's limit. Every case runs at the reference test's size over 8
positions and, as ``ragged``, at a row count that 4 does not divide over
4 positions (a block of padding rows only included, where the shapes
give one).

The random starts of k-means, GMM and LDA come from ``jax.random`` in the
reference, which torch cannot reproduce: what the port's set driver runs
(its block-level function over the placed set's row blocks,
``placed_ops.row_blocks``) is given the reference's start (its
``iters=0`` state on the unplaced data), and the driver itself, with its
own random start, is held to the same driver on one device. The
partial sums of a placed run are added in position order, so they differ
from one device's in the last bits; k-means is held as the reference
holds it (centroids within 1e-4, at least 99% of the assignments equal:
a point halfway between two centroids may change cluster). Counts are
exact in any order and are held exactly. A data-parallel layout runs
with no gather (``parallel.mesh.gather_log``).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.parallel.placement import Placement as JaxPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational.table import ColumnTable as JaxTable
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.parallel.mesh import (clear_gather_log, gather_log,
                                            virtual_devices)
from netsdb_tpu_torch.parallel.placed_ops import host_array, row_blocks
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.relational.table import ColumnTable

jw = {m: importlib.import_module(f"netsdb_tpu.workloads.{m}")
      for m in ("kmeans", "gmm", "lda", "pagerank", "topk",
                "conv_fusion")}
pw = {m: importlib.import_module(f"netsdb_tpu_torch.workloads.{m}")
      for m in ("kmeans", "gmm", "lda", "pagerank", "topk",
                "conv_fusion")}

# the reference test's size over 8 positions; a ragged row count over 4
SIZES = ["reference", "ragged"]
POSITIONS = {"reference": 8, "ragged": 4}


class Pair:
    """The two packages' clients for one case, over ``n`` positions."""

    def __init__(self, tmp_path, size):
        clear_compiled_cache()
        clear_gather_log()
        self.n = POSITIONS[size]
        self.jax = JaxClient(JaxConfiguration(
            root_dir=str(tmp_path / "jax")))
        self._vd = virtual_devices(self.n, "cpu")
        self._vd.__enter__()
        self.port = Client(Configuration(root_dir=str(tmp_path / "port")),
                           device="cpu")

    def close(self):
        self._vd.__exit__(None, None, None)

    def dp(self, ndim=2):
        """(the reference's, the port's) data-parallel placement."""
        return (JaxPlacement.data_parallel(ndim=ndim, n_devices=self.n),
                Placement.data_parallel(ndim=ndim))

    def cols(self):
        """Columns over the data axis (the LSTM's h and c)."""
        axes = (("data", self.n),)
        return (JaxPlacement(axes, (None, "data")),
                Placement(axes, (None, "data")))


@pytest.fixture(params=SIZES)
def pair(request, tmp_path):
    p = Pair(tmp_path, request.param)
    p.size = request.param
    try:
        yield p
    finally:
        p.close()


def _np(x):
    """A result of either package as a numpy array (a placed port value
    read shard by shard)."""
    if isinstance(x, (BlockedTensor, torch.Tensor)):
        return np.asarray(host_array(x))
    return np.asarray(x.to_dense() if hasattr(x, "to_dense") else x)


def _jshards(x) -> int:
    return len({s.device for s in x.addressable_shards})


# ------------------------------------------------------------- word2vec
def test_word2vec_placed_matches_the_reference(pair):
    from netsdb_tpu.models.word2vec import Word2VecModel as JW2V
    from netsdb_tpu_torch.models import Word2VecModel

    vocab, n_ids = (64, 24) if pair.size == "reference" else (61, 23)
    rng = np.random.default_rng(5)
    table = rng.standard_normal((vocab, 16)).astype(np.float32)
    ids = rng.integers(0, vocab, n_ids)
    (jdp, dp) = pair.dp()
    outs = []
    for cls, c, pl in ((JW2V, pair.jax, jdp), (Word2VecModel, pair.port,
                                               dp)):
        m = cls(db="w2vp", block=(8, 8))
        m.setup(c, placements={"weights": pl, "inputs": pl})
        m.load_embeddings(c, table)
        m.load_onehot_inputs(c, ids, vocab=vocab)
        outs.append((_np(m.inference(c)), np.asarray(m.lookup(c, ids))))
    assert _jshards(pair.jax.get_tensor("w2vp", "weights").data) == pair.n
    assert pair.port.get_tensor("w2vp", "weights").data.parts(0) == pair.n
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[1][1], table[ids], rtol=1e-6)
    # the one-hot product contracts over the vocabulary, row-sharded on
    # the axis the inputs' rows use: gathered and counted with its reason
    log = gather_log()
    assert [e["op"] for e in log] == ["matmul_t"]
    assert "contraction" in log[0]["reason"]


# --------------------------------------------------------------- logreg
def test_logreg_placed_matches_the_reference(pair):
    from netsdb_tpu.models.logreg import LogRegModel as JLogReg
    from netsdb_tpu_torch.models import LogRegModel

    rows, feats = (32, 16) if pair.size == "reference" else (27, 13)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((rows, feats)).astype(np.float32)
    w = rng.standard_normal(feats).astype(np.float32)
    (jdp, dp) = pair.dp()
    outs = []
    for cls, c, pl in ((JLogReg, pair.jax, jdp), (LogRegModel, pair.port,
                                                  dp)):
        m = cls(db="lrp", block=(8, 8))
        m.setup(c, placements={"inputs": pl})  # batch-sharded
        m.load_weights(c, w, 0.25)
        m.load_inputs(c, x)
        outs.append(_np(m.inference(c)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    assert gather_log() == []


# ----------------------------------------------------------------- LSTM
def test_lstm_placed_matches_the_reference(pair):
    from netsdb_tpu.models.lstm_model import LSTMModel as JLSTM
    from netsdb_tpu_torch.models import LSTMModel

    hidden, inp, batch = (16, 16, 8) if pair.size == "reference" \
        else (16, 12, 13)
    rng = np.random.default_rng(7)
    weights = {}
    for g in "ifco":
        weights[f"w_{g}"] = rng.standard_normal((hidden, inp)).astype(
            np.float32) * np.float32(0.1)
        weights[f"u_{g}"] = rng.standard_normal((hidden, hidden)).astype(
            np.float32) * np.float32(0.1)
        weights[f"b_{g}"] = rng.standard_normal(hidden).astype(
            np.float32) * np.float32(0.1)
    h0 = rng.standard_normal((hidden, batch)).astype(np.float32) * 0.1
    c0 = rng.standard_normal((hidden, batch)).astype(np.float32) * 0.1
    x = rng.standard_normal((inp, batch)).astype(np.float32)
    (jdp, dp), (jcols, cols) = pair.dp(), pair.cols()
    outs = []
    for cls, c, rows_pl, cols_pl in ((JLSTM, pair.jax, jdp, jcols),
                                     (LSTMModel, pair.port, dp, cols)):
        pls = {f"w_{g}": rows_pl for g in "ifco"}
        pls.update({"h": cols_pl, "c": cols_pl})
        m = cls(db="lstmp", block=(8, 8))
        m.setup(c, placements=pls)
        m.load_weights(c, weights)
        m.load_state(c, h0, c0)
        h, cc = m.step(c, x)
        outs.append((_np(h), _np(cc)))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # row-sharded w·x meets column-sharded u·h in each gate's sum: four
    # gathers of two operands each, every one logged with its layouts
    log = gather_log()
    assert [e["op"] for e in log] == ["three_way_sum"]
    assert log[0]["gathers"] == 8
    assert "P(data,None)" in log[0]["reason"]
    assert "P(None,data)" in log[0]["reason"]


# ---------------------------------------------------------- conv fusion
def test_conv_fusion_placed_matches_the_reference(pair):
    rng = np.random.default_rng(8)
    if pair.size == "reference":
        images = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
        kernels = rng.standard_normal((4, 3, 7, 7)).astype(np.float32)
        ksize = 7
    else:  # 3 x 6 x 6 = 108 window rows
        images = rng.standard_normal((3, 3, 10, 10)).astype(np.float32)
        kernels = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
        ksize = 5
    (jdp, dp) = pair.dp()
    outs = []
    for mod, c, pl, rep in ((jw, pair.jax, jdp, JaxPlacement.replicated(
            ndim=2, n_devices=pair.n)), (pw, pair.port, dp,
                                         Placement.replicated())):
        pipe = mod["conv_fusion"].ConvFusionPipeline(kernel_size=ksize,
                                                     block=(16, 16))
        pipe.setup(c, placements={"image_flat": pl, "kernel_flat": rep})
        outs.append(np.stack([i.data for i in pipe.run(c, images,
                                                       kernels)]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    assert pair.port.get_tensor("convfuse", "image_flat").data.parts(0) \
        == pair.n
    assert gather_log() == []


# ------------------------------------------------------------ k-means
def _blobs(pair):
    rows = 512 if pair.size == "reference" else 517
    rng = np.random.default_rng(11)
    return (rng.standard_normal((rows, 16))
            + rng.integers(0, 4, (rows, 1)) * 8).astype(np.float32)


def _load_matrix(c, pl, name, data, block):
    c.create_database("ml")
    c.create_set("ml", name, placement=pl)
    c.send_matrix("ml", name, data, block)


def _placed_blocks(c, name, n):
    """The placed set's row blocks, one a position (a block of padding
    rows only left out), as the set drivers read them."""
    blocks = row_blocks(c.get_tensor("ml", name), "test")
    assert n - 1 <= len(blocks) <= n
    return blocks


def test_kmeans_on_placed_set_matches_the_reference(pair):
    """``tests/test_placement_api.py:423-450``: the reference's test
    limits (centroids rtol = atol = 1e-4, at least 99% of the
    assignments equal)."""
    pts = _blobs(pair)
    (jdp, dp) = pair.dp()
    _load_matrix(pair.jax, jdp, "points", pts, (8, 8))
    jc, ja = jw["kmeans"].kmeans_on_set(pair.jax, "ml", "points", k=4,
                                        iters=8, seed=3)
    assert _jshards(pair.jax.get_tensor("ml", "points").data) == pair.n
    init, _ = jw["kmeans"].kmeans(jax.numpy.asarray(pts), 4, iters=0,
                                  seed=3)
    _load_matrix(pair.port, dp, "points", pts, (8, 8))
    pc, pa = pw["kmeans"].kmeans_blocks(
        _placed_blocks(pair.port, "points", pair.n), k=4, iters=8,
        init_centroids=torch.from_numpy(np.array(init)))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)
    assert pa.shape == (len(pts),)
    assert (pa.numpy() == np.asarray(ja)).mean() >= 0.99
    assert gather_log() == []


def test_kmeans_random_start_does_not_depend_on_the_placement(tmp_path):
    """The port's own random start draws the same rows however the
    points are split; integer points make every sum exact, so a placed
    run equals the one-device run bit for bit, and the driver writes
    back the centroids it returns."""
    rng = np.random.default_rng(2)
    pts = (rng.integers(0, 3, (37, 1)) * 20
           + rng.integers(-3, 4, (37, 4))).astype(np.float32)
    solo = Client(Configuration(root_dir=str(tmp_path / "solo")),
                  device="cpu")
    _load_matrix(solo, None, "points", pts, (4, 4))
    want = pw["kmeans"].kmeans_on_set(solo, "ml", "points", 3, iters=6,
                                      seed=5)
    clear_gather_log()
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "placed")),
                   device="cpu")
        _load_matrix(c, Placement.data_parallel(ndim=2), "points", pts,
                     (4, 4))
        got = pw["kmeans"].kmeans_on_set(c, "ml", "points", 3, iters=6,
                                         seed=5)
        written = host_array(c.get_tensor("ml", "kmeans_centroids"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(written, got[0].numpy())
    assert gather_log() == []


# ----------------------------------------------------------- GMM / LDA
def test_gmm_on_placed_set_matches_the_reference(pair):
    per = 40 if pair.size == "reference" else 39
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(m, 0.3, (per, 4))
                          for m in (-2.0, 0.0, 2.0)]).astype(np.float32)
    (jdp, dp) = pair.dp()
    _load_matrix(pair.jax, jdp, "points", pts, (8, 4))
    jst, jresp = jw["gmm"].gmm_on_set(pair.jax, "ml", "points", k=3,
                                      iters=10, seed=1)
    init, _ = jw["gmm"].gmm_em(jax.numpy.asarray(pts), 3, iters=0, seed=1)
    _load_matrix(pair.port, dp, "points", pts, (8, 4))
    start = pw["gmm"].GMMState(*(torch.from_numpy(np.array(t))
                                 for t in init))
    pst, presp = pw["gmm"].gmm_em(
        _placed_blocks(pair.port, "points", pair.n), 3, iters=10,
        init=start)
    np.testing.assert_allclose(pst.means.numpy(), np.asarray(jst.means),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(presp.numpy(), np.asarray(jresp),
                               rtol=1e-3, atol=1e-3)
    assert presp.shape == (len(pts), 3)
    assert gather_log() == []


def test_lda_on_placed_set_matches_the_reference(pair):
    docs = 48 if pair.size == "reference" else 45
    counts = np.random.default_rng(10).poisson(1.0, (docs, 32)).astype(
        np.float32)
    (jdp, dp) = pair.dp()
    _load_matrix(pair.jax, jdp, "counts", counts, (8, 8))
    jst = jw["lda"].lda_on_set(pair.jax, "ml", "counts", k=4, iters=15,
                               seed=2)
    init = jw["lda"].lda_em(jax.numpy.asarray(counts), 4, iters=0, seed=2)
    _load_matrix(pair.port, dp, "counts", counts, (8, 8))
    pst = pw["lda"].lda_em_blocks(
        _placed_blocks(pair.port, "counts", pair.n), 4, iters=15,
        init=pw["lda"].LDAState(*(torch.from_numpy(np.array(t))
                                  for t in init)))
    np.testing.assert_allclose(pst.topic_word.numpy(),
                               np.asarray(jst.topic_word), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pst.doc_topic.numpy(),
                               np.asarray(jst.doc_topic), rtol=1e-4,
                               atol=1e-5)
    assert gather_log() == []


def _gmm_data():
    rng = np.random.default_rng(9)
    return np.concatenate([rng.normal(m, 0.3, (39, 4))
                           for m in (-2.0, 0.0, 2.0)]).astype(np.float32)


def _lda_data():
    return np.random.default_rng(10).poisson(1.0, (45, 32)).astype(
        np.float32)


def _gmm_driver(c):
    st, resp = pw["gmm"].gmm_on_set(c, "ml", "data", 3, iters=10, seed=1)
    k, d = st.means.shape
    packed = host_array(c.get_tensor("ml", "gmm_state"))
    np.testing.assert_array_equal(packed[:, :d], st.means.numpy())
    np.testing.assert_array_equal(packed[:, d:2 * d], st.variances.numpy())
    np.testing.assert_array_equal(packed[:, 2 * d], st.weights.numpy())
    return {"means": (st.means, 1e-4), "resp": (resp, 1e-3)}


def _lda_driver(c):
    st = pw["lda"].lda_on_set(c, "ml", "data", 4, iters=15, seed=2)
    np.testing.assert_array_equal(
        host_array(c.get_tensor("ml", "lda_topics")), st.topic_word.numpy())
    return {"topic_word": (st.topic_word, 1e-4),
            "doc_topic": (st.doc_topic, 1e-4)}


@pytest.mark.parametrize("name,data,block,run", [
    ("gmm", _gmm_data, (8, 4), _gmm_driver),
    ("lda", _lda_data, (8, 8), _lda_driver)])
def test_set_driver_over_placed_set_matches_one_device(tmp_path, name, data,
                                                       block, run):
    """The set driver with its own random start (drawn alike however the
    rows are split) over a row-sharded set of a ragged row count, held
    to the same driver on one device within the reference's limits
    (GMM means 1e-4, responsibilities 1e-3; LDA rtol 1e-4, atol 1e-5);
    what it writes back is what it returns."""
    arr = data()
    solo = Client(Configuration(root_dir=str(tmp_path / "solo")),
                  device="cpu")
    _load_matrix(solo, None, "data", arr, block)
    want = run(solo)
    clear_gather_log()
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "placed")),
                   device="cpu")
        _load_matrix(c, Placement.data_parallel(ndim=2), "data", arr, block)
        assert c.get_tensor("ml", "data").data.parts(0) == 4
        got = run(c)
    for key, (g, rtol) in got.items():
        np.testing.assert_allclose(g.numpy(), want[key][0].numpy(),
                                   rtol=rtol,
                                   atol=1e-5 if name == "lda" else rtol)
    assert gather_log() == []


# ----------------------------------------------------- PageRank / TopK
def test_pagerank_on_placed_table_matches_the_reference(pair):
    n_nodes, n_edges = 50, (400 if pair.size == "reference" else 403)
    rng = np.random.default_rng(11)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    outs = []
    for c, mod, pl, table in (
            (pair.jax, jw, JaxPlacement.data_parallel(
                ndim=1, n_devices=pair.n),
             JaxTable.from_columns({"src": src, "dst": dst})),
            (pair.port, pw, Placement.data_parallel(ndim=1),
             ColumnTable.from_columns({"src": src, "dst": dst},
                                      device="cpu"))):
        c.create_database("pr")
        c.create_set("pr", "links", type_name="table", placement=pl)
        c.send_table("pr", "links", table)
        outs.append(mod["pagerank"].pagerank_on_table_set(
            c, "pr", "links", n_nodes, iters=15))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-7)
    # the object path over a placed object set: the one-device result
    pair.port.create_set("pr", "links_obj", type_name="object",
                         placement=Placement.data_parallel(ndim=1))
    pair.port.send_data("pr", "links_obj",
                        [(int(s), int(d)) for s, d in zip(src, dst)])
    obj = pw["pagerank"].pagerank_on_set(pair.port, "pr", "links_obj",
                                         n_nodes, iters=15)
    np.testing.assert_allclose(outs[1], obj, rtol=1e-5, atol=1e-7)
    assert gather_log() == []


def test_topk_on_placed_table_matches_the_reference(pair):
    n = 200 if pair.size == "reference" else 203
    scores = np.random.default_rng(12).standard_normal(n).astype(np.float32)
    scores[7] = scores[150]  # a tie: the lower row first in both
    outs = []
    for c, mod, pl, table in (
            (pair.jax, jw, JaxPlacement.data_parallel(
                ndim=1, n_devices=pair.n),
             JaxTable.from_columns({"score": scores})),
            (pair.port, pw, Placement.data_parallel(ndim=1),
             ColumnTable.from_columns({"score": scores}, device="cpu"))):
        c.create_database("tk")
        c.create_set("tk", "scored", type_name="table", placement=pl)
        c.send_table("tk", "scored", table)
        out = mod["topk"].top_k_on_table_set(c, "tk", "scored", "score",
                                             k=7)
        outs.append((np.asarray(out["row"]), np.asarray(out["score"]),
                     np.asarray(out.mask())))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs[1][1], np.sort(scores)[::-1][:7])
    # the object driver over a placed object set: the one-device result
    pair.port.create_set("tk", "emps", type_name="object",
                         placement=Placement.data_parallel(ndim=1))
    pair.port.send_data("tk", "emps", [float(s) for s in scores])
    winners = pw["topk"].top_k_on_set(pair.port, "tk", "emps", 7,
                                      score=lambda v: v)
    np.testing.assert_allclose(winners, np.sort(scores)[::-1][:7])
    assert gather_log() == []
