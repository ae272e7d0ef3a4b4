"""The single-device workloads of the port against the reference's
(``netsdb_tpu/utils/sampler.py``, ``workloads/{kmeans,gmm,lda,pagerank,
topk}.py``), on seeded numpy inputs at small sizes.

Tolerances: the sampler's arrays are identical; k-means assignments
equal and centroids within 1e-5; GMM and LDA states, stepped from the
reference's own initial state, within 1e-5 relative (the reference's
random inits — ``jax.random.choice``, ``jax.random.dirichlet`` — cannot
be drawn in torch, so parity runs through the step); PageRank within
1e-6; top-k indices equal. The whole calls with the port's own random
inits are held to the planted-cluster properties of
``tests/test_workloads.py``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.utils import sampler as jsampler
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.utils import sampler

# the packages' __init__ export functions of the same names as the modules
jgmm, jkmeans, jlda, jpr, jtopk = (importlib.import_module(
    f"netsdb_tpu.workloads.{m}") for m in ("gmm", "kmeans", "lda",
                                           "pagerank", "topk"))
gmm, kmeans, lda, pagerank, topk = (importlib.import_module(
    f"netsdb_tpu_torch.workloads.{m}") for m in ("gmm", "kmeans", "lda",
                                                 "pagerank", "topk"))

TOL = 1e-5


@pytest.fixture()
def port(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def blobs(n_per=50, seed=0, d=2, spread=10.0, k=3):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((k, d)) * spread).astype(np.float32)
    pts = np.concatenate([
        rng.standard_normal((n_per, d)).astype(np.float32) * 0.5 + c
        for c in centers])
    return pts, np.repeat(np.arange(k), n_per), centers


def t(a):
    return torch.from_numpy(np.array(a))


# --- sampler --------------------------------------------------------------

def test_sampler_draws_identical_arrays():
    for args in ((10, 1000, False), (100, 10_000, True), (999, 1000, False),
                 (3, 50, True)):
        assert sampler.compute_fraction_for_sample_size(*args) == \
            jsampler.compute_fraction_for_sample_size(*args)
    assert [sampler.num_std(n) for n in (3, 10, 100)] == \
        [jsampler.num_std(n) for n in (3, 10, 100)]
    a, b = list(range(50)), list(range(50))
    sampler.randomize_in_place(a, seed=3)
    jsampler.randomize_in_place(b, seed=3)
    assert a == b
    pts = np.random.default_rng(1).standard_normal((500, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        sampler.bernoulli_sample_rows(pts, 0.3, seed=7),
        jsampler.bernoulli_sample_rows(pts, 0.3, seed=7))
    for k, seed in ((5, 0), (20, 4), (64, 9)):
        np.testing.assert_array_equal(
            sampler.sample_k_distinct(pts, k, seed=seed),
            jsampler.sample_k_distinct(pts, k, seed=seed))
    with pytest.raises(ValueError):
        sampler.compute_fraction_for_sample_size(5, 0)


# --- k-means --------------------------------------------------------------

@pytest.mark.parametrize("init", ["given", "sample"])
def test_kmeans_matches_the_reference(init):
    pts, _, _ = blobs(n_per=40, seed=2, d=5, k=4)
    init_c = pts[[0, 50, 90, 130]]
    kw = ({"init_centroids": init_c} if init == "given"
          else {"init": "sample", "seed": 3})
    jc, ja = jkmeans.kmeans(jnp.asarray(pts), 4, iters=8,
                            **({"init_centroids": jnp.asarray(init_c)}
                               if init == "given" else kw))
    pc, pa = kmeans.kmeans(t(pts), 4, iters=8,
                           **({"init_centroids": t(init_c)}
                              if init == "given" else kw))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=TOL,
                               atol=TOL)


def test_kmeans_sample_init_equals_the_reference_start():
    pts, _, _ = blobs(n_per=60, seed=5, k=2)
    want = jsampler.sample_k_distinct(pts, 2, seed=2)
    got = kmeans.sample_init(t(pts), 2, seed=2)
    np.testing.assert_array_equal(got.numpy(), want)
    jc, _ = jkmeans.kmeans(jnp.asarray(pts), 2, iters=0, seed=2,
                           init="sample")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc))


def test_kmeans_empty_cluster_keeps_its_centroid_and_ties_go_low():
    pts = np.asarray([[0, 0], [0, 0], [1, 0], [1, 0]], np.float32)
    init_c = np.asarray([[0.5, 0], [0.5, 0], [100, 100]], np.float32)
    jc, ja = jkmeans.kmeans(jnp.asarray(pts), 3, iters=1,
                            init_centroids=jnp.asarray(init_c))
    pc, pa = kmeans.kmeans(t(pts), 3, iters=1, init_centroids=t(init_c))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=TOL)
    assert pc[2].tolist() == [100.0, 100.0]


def test_kmeans_on_set_recovers_blobs(port):
    pts, labels, centers = blobs(n_per=50, seed=0, k=3)
    port.create_database("ml")
    port.create_set("ml", "points")
    port.send_matrix("ml", "points", pts, (16, 2))
    cents, assign = kmeans.kmeans_on_set(port, "ml", "points", 3, iters=15)
    stored = port.get_tensor("ml", "kmeans_centroids")
    assert stored.shape == (3, 2)
    np.testing.assert_array_equal(stored.to_dense().numpy(), cents.numpy())
    for c in centers:
        assert np.min(np.linalg.norm(cents.numpy() - c, axis=1)) < 0.5
    a = assign.numpy()
    for b in range(3):
        blob = a[labels == b]
        assert (blob == np.bincount(blob).argmax()).mean() == 1.0


# --- GMM ------------------------------------------------------------------

def _jstate(s):
    return gmm.GMMState(*(t(np.asarray(x)) for x in s))


def _close_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _close_state(got, want):
    """Means and weights within 1e-5 relative. A variance is E[x²] − μ²
    in f32 (both packages): its rounding is that of E[x²], so it is held
    within 1e-5 of the largest E[x²]."""
    _close_rel(got.means.numpy(), want.means)
    _close_rel(got.weights.numpy(), want.weights)
    ex2 = np.asarray(want.variances) + np.asarray(want.means) ** 2
    np.testing.assert_allclose(got.variances.numpy(), want.variances,
                               rtol=TOL, atol=TOL * ex2.max())


@pytest.mark.parametrize("steps", [1, 4])
def test_gmm_step_matches_the_reference(steps):
    pts, _, _ = blobs(n_per=40, seed=3, d=3, k=3)
    p = jnp.asarray(pts)
    init, _ = jgmm.gmm_em(p, 3, iters=0, seed=1)
    want, want_resp = jgmm.gmm_em(p, 3, iters=steps, seed=1)
    state = _jstate(init)
    for _ in range(steps):
        state = gmm.gmm_step(t(pts), state)
    _close_state(state, want)
    got, resp = gmm.gmm_em(t(pts), 3, iters=steps, init=_jstate(init))
    _close_state(got, want)
    np.testing.assert_allclose(resp.numpy(), np.asarray(want_resp),
                               atol=TOL)


def test_gmm_log_prob_and_likelihood_match_on_a_given_state():
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((64, 4)).astype(np.float32) * 3
    st = jgmm.GMMState(
        means=jnp.asarray(rng.standard_normal((5, 4)), jnp.float32),
        variances=jnp.asarray(rng.random((5, 4)) + 0.2, jnp.float32),
        weights=jnp.asarray(rng.dirichlet(np.ones(5)), jnp.float32))
    old = gmm.CHUNK_ELEMS
    try:
        for chunk in (old, 40):  # whole, and a few rows at a time
            gmm.CHUNK_ELEMS = chunk
            _close_rel(gmm._log_prob(t(pts), _jstate(st)).numpy(),
                       jgmm._log_prob(jnp.asarray(pts), st))
    finally:
        gmm.CHUNK_ELEMS = old
    _close_rel(float(gmm.gmm_log_likelihood(t(pts), _jstate(st))),
               float(jgmm.gmm_log_likelihood(jnp.asarray(pts), st)))


def test_gmm_on_set_recovers_blobs(port):
    pts, _, centers = blobs(n_per=50, seed=3, k=3)
    port.create_database("ml")
    port.create_set("ml", "points")
    port.send_matrix("ml", "points", pts, (16, 2))
    state, resp = gmm.gmm_on_set(port, "ml", "points", 3, iters=25)
    means = state.means.numpy()
    for c in centers:
        assert np.min(np.linalg.norm(means - c, axis=1)) < 0.5
    np.testing.assert_allclose(state.weights.numpy(), 1 / 3, atol=0.05)
    assert resp.max(1).values.mean() > 0.95
    packed = port.get_tensor("ml", "gmm_state").to_dense().numpy()
    assert packed.shape == (3, 5)
    np.testing.assert_array_equal(packed[:, 4], state.weights.numpy())
    s1, _ = gmm.gmm_em(t(pts), 3, 1)
    s20, _ = gmm.gmm_em(t(pts), 3, 20)
    assert float(gmm.gmm_log_likelihood(t(pts), s20)) >= float(
        gmm.gmm_log_likelihood(t(pts), s1)) - 1e-3


# --- LDA ------------------------------------------------------------------

def _counts(seed=1, docs=30, vocab=12):
    rng = np.random.default_rng(seed)
    return rng.poisson(2.0, (docs, vocab)).astype(np.float32)


@pytest.mark.parametrize("steps", [1, 5])
def test_lda_step_matches_the_reference(steps):
    counts = _counts()
    c = jnp.asarray(counts)
    init = jlda.lda_em(c, 3, iters=0, seed=2)
    want = jlda.lda_em(c, 3, iters=steps, seed=2)
    state = lda.LDAState(t(np.asarray(init.doc_topic)),
                         t(np.asarray(init.topic_word)))
    for _ in range(steps):
        state = lda.lda_step(t(counts), state)
    _close_rel(state.doc_topic.numpy(), want.doc_topic)
    _close_rel(state.topic_word.numpy(), want.topic_word)
    got = lda.lda_em(t(counts), 3, iters=steps, init=state._replace(
        doc_topic=t(np.asarray(init.doc_topic)),
        topic_word=t(np.asarray(init.topic_word))))
    _close_rel(got.topic_word.numpy(), want.topic_word)


def test_lda_perplexity_matches_on_a_given_state():
    counts = _counts(seed=3)
    st = jlda.lda_em(jnp.asarray(counts), 4, iters=3, seed=5)
    got = lda.lda_perplexity(t(counts), lda.LDAState(
        t(np.asarray(st.doc_topic)), t(np.asarray(st.topic_word))))
    _close_rel(float(got), float(jlda.lda_perplexity(jnp.asarray(counts),
                                                      st)))


def test_lda_on_set_separates_disjoint_topics(port):
    rng = np.random.default_rng(0)
    counts = np.zeros((40, 10), np.float32)
    counts[:20, :5] = rng.poisson(3.0, (20, 5))
    counts[20:, 5:] = rng.poisson(3.0, (20, 5))
    port.create_database("ml")
    port.create_set("ml", "counts")
    port.send_matrix("ml", "counts", counts, (8, 8))
    state = lda.lda_on_set(port, "ml", "counts", 2, iters=60)
    phi = state.topic_word.numpy()
    half = phi[:, :5].sum(1)
    assert half.max() > 0.95 and half.min() < 0.05
    theta = state.doc_topic.numpy()
    assert theta[:20].mean(0).argmax() != theta[20:].mean(0).argmax()
    np.testing.assert_array_equal(
        port.get_tensor("ml", "lda_topics").to_dense().numpy(), phi)
    c = t(counts)
    assert float(lda.lda_perplexity(c, lda.lda_em(c, 3, 50))) <= float(
        lda.lda_perplexity(c, lda.lda_em(c, 3, 2))) + 1e-3


def test_lda_init_rows_are_distributions():
    st = lda.lda_init(t(_counts()), 4, seed=0)
    np.testing.assert_allclose(st.doc_topic.sum(1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(st.topic_word.sum(1).numpy(), 1.0, rtol=1e-6)
    again = lda.lda_init(t(_counts()), 4, seed=0)
    assert torch.equal(st.topic_word, again.topic_word)


# --- PageRank -------------------------------------------------------------

def _graph(n=40, m=160, seed=0, dangling=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    if not dangling:  # every node links somewhere
        src = np.concatenate([src, np.arange(n, dtype=np.int32)])
        dst = np.concatenate([dst, (np.arange(n, dtype=np.int32) + 1) % n])
    return src, dst


@pytest.mark.parametrize("dangling", [True, False])
def test_pagerank_matches_the_reference(dangling):
    src, dst = _graph(dangling=dangling)
    want = np.asarray(jpr.pagerank(jnp.asarray(src), jnp.asarray(dst), 40,
                                   iters=25))
    got = pagerank.pagerank(t(src), t(dst), 40, iters=25)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got.sum()), 1.0, atol=1e-5)


def test_pagerank_ids_out_of_range_raise():
    with pytest.raises(IndexError, match="outside"):
        pagerank.pagerank(t(np.asarray([0, 5])), t(np.asarray([1, 0])), 3)


def test_the_three_pagerank_drivers_agree(client, port):
    src, dst = _graph(n=30, m=120, seed=4, dangling=False)
    edges = [(int(s), int(d)) for s, d in zip(src, dst)]
    direct = pagerank.pagerank(t(src), t(dst), 30).numpy()
    for c in (client, port):
        c.create_database("web")
        c.create_set("web", "links", type_name="object")
        c.send_data("web", "links", edges)
    want = jpr.pagerank_on_set(client, "web", "links", 30)
    got = pagerank.pagerank_on_set(port, "web", "links", 30)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-7)
    stored = list(port.get_set_iterator("web", "ranks"))
    assert len(stored) == 30 and stored[3] == (3, float(got[3]))
    client.create_set("web", "lt", type_name="table")
    client.send_table("web", "lt", JTable({"src": jnp.asarray(src),
                                           "dst": jnp.asarray(dst)}))
    port.create_set("web", "lt", type_name="table")
    port.send_table("web", "lt", ColumnTable({"src": t(src),
                                              "dst": t(dst)}))
    want_t = jpr.pagerank_on_table_set(client, "web", "lt", 30)
    got_t = pagerank.pagerank_on_table_set(port, "web", "lt", 30)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_t, direct, rtol=1e-6, atol=1e-7)


def test_pagerank_table_drops_invalid_and_minus_one_rows(client, port):
    src, dst = _graph(n=20, m=80, seed=6, dangling=False)
    src[[3, 17]] = -1
    dst[[5, 40]] = -1
    valid = np.ones(len(src), bool)
    valid[[8, 9, 60]] = False
    client.create_database("web")
    client.create_set("web", "lt", type_name="table")
    client.send_table("web", "lt", JTable({"src": jnp.asarray(src),
                                           "dst": jnp.asarray(dst)},
                                          valid=jnp.asarray(valid)))
    port.create_database("web")
    port.create_set("web", "lt", type_name="table")
    port.send_table("web", "lt", ColumnTable({"src": t(src), "dst": t(dst)},
                                             valid=t(valid)))
    want = jpr.pagerank_on_table_set(client, "web", "lt", 20, iters=15)
    got = pagerank.pagerank_on_table_set(port, "web", "lt", 20, iters=15)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pagerank_planted_properties():
    ranks = pagerank.pagerank(t(np.asarray([1, 2, 3, 4])),
                              t(np.asarray([0, 0, 0, 0])), 5,
                              iters=30).numpy()
    assert ranks.argmax() == 0 and ranks[0] > 3 * ranks[1]
    np.testing.assert_allclose(ranks.sum(), 1.0, atol=1e-3)
    cyc = pagerank.pagerank(t(np.asarray([0, 1, 2, 3])),
                            t(np.asarray([1, 2, 3, 0])), 4, iters=50)
    np.testing.assert_allclose(cyc.numpy(), 0.25, atol=1e-4)


# --- top-k ----------------------------------------------------------------

def test_top_k_ties_go_to_the_references_indices():
    rng = np.random.default_rng(2)
    scores = rng.integers(0, 6, 200).astype(np.float32)  # many ties
    for k in (1, 7, 50, 200):
        jv, ji = jtopk.top_k(jnp.asarray(scores), k)
        pv, pi = topk.top_k(t(scores), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        assert pi.dtype == torch.int32


def test_top_k_object_driver(client, port):
    emps = [{"name": n, "salary": s} for n, s in
            zip("abcdefg", (10, 99, 50, 99, 3, 50, 70))]
    for c in (client, port):
        c.create_database("db")
        c.create_set("db", "emps", type_name="object")
        c.send_data("db", "emps", emps)
    want = jtopk.top_k_on_set(client, "db", "emps", 4,
                              score=lambda e: e["salary"])
    got = topk.top_k_on_set(port, "db", "emps", 4,
                            score=lambda e: e["salary"])
    assert got == want
    assert [w["name"] for w in got] == ["b", "d", "g", "c"]
    assert list(port.get_set_iterator("db", "topk")) == got
    assert topk.top_k_on_set(port, "db", "emps", 100,
                             score=lambda e: e["salary"]) == \
        sorted(emps, key=lambda e: -e["salary"])


def test_top_k_table_driver(client, port):
    rng = np.random.default_rng(8)
    scores = rng.integers(0, 20, 300).astype(np.float32)
    valid = rng.random(300) > 0.2
    client.create_database("db")
    client.create_set("db", "s", type_name="table")
    client.send_table("db", "s", JTable({"score": jnp.asarray(scores)},
                                        valid=jnp.asarray(valid)))
    port.create_database("db")
    port.create_set("db", "s", type_name="table")
    port.send_table("db", "s", ColumnTable({"score": t(scores)},
                                           valid=t(valid)))
    for k in (5, 17):
        want = jtopk.top_k_on_table_set(client, "db", "s", "score", k)
        got = topk.top_k_on_table_set(port, "db", "s", "score", k)
        np.testing.assert_array_equal(got["row"].numpy(),
                                      np.asarray(want["row"]))
        np.testing.assert_array_equal(got["score"].numpy(),
                                      np.asarray(want["score"]))
        np.testing.assert_array_equal(got.mask().numpy(),
                                      np.asarray(want.mask()))
        order = np.lexsort((np.arange(300), -np.where(valid, scores,
                                                      -np.inf)))
        np.testing.assert_array_equal(got["row"].numpy(), order[:k])
    assert port.get_table("db", "topk_table").num_rows == 17
