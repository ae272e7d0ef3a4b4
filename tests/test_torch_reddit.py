"""Parity of the port's reddit workloads with the JAX package: the host
DAGs over record sets (three-way join, label selections and their grid,
label propagation, per-author counts, the inference join) compared
exactly and in order, and the columnar pipeline (``reddit_columnar``)
on the CPU: integers exactly, features within 1e-6 relative plus 1e-5
absolute (both float32: XLA turns ``days / 30.44`` into a product with
the rounded reciprocal, the port divides, and one float32 ulp of that
quotient, 6.1e-5 near 600, passes through ``% 12 / 11``); 2e-3 absolute
against the float64 scalar path, as the reference's own test allows."""

import numpy as np
import pytest

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.models.ff import FFModel as JaxFF
from netsdb_tpu.workloads import reddit as JR
from netsdb_tpu.workloads import reddit_columnar as JRC
from netsdb_tpu_torch import Client, Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.workloads import reddit as R
from netsdb_tpu_torch.workloads import reddit_columnar as RC

RTOL = 1e-6
FEATURE_ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    return R.generate(num_comments=240, num_authors=18, num_subs=6, seed=7)


@pytest.fixture()
def loaded(tmp_path, data):
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    p = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    for c in (j, p):
        c.create_database("reddit")
        for name, rows in zip(("comments", "authors", "subs"), data):
            c.create_set("reddit", name, type_name="object")
            c.send_data("reddit", name, rows)
    return j, p


def _run(loaded, jsinks, psinks):
    j, p = loaded
    rj = j.execute_computations(*jsinks)
    rp = p.execute_computations(*psinks)
    return ({k.set: v for k, v in rj.items()},
            {k.set: v for k, v in rp.items()})


def test_generate_matches_the_reference():
    got = R.generate(num_comments=50, num_authors=5, num_subs=3, seed=2)
    want = JR.generate(num_comments=50, num_authors=5, num_subs=3, seed=2)
    for g, w in zip(got, want):
        assert [vars(x) for x in g] == [vars(x) for x in w]


def test_host_three_way_join_matches_in_order(loaded):
    want, got = _run(loaded, [JR.build_three_way_join("reddit")],
                     [R.build_three_way_join("reddit")])
    g, w = got["full_features"], want["full_features"]
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert (a.index, a.label, a.comment_id, a.author_id, a.sub_id) == \
            (b.index, b.label, b.comment_id, b.author_id, b.sub_id)
        np.testing.assert_array_equal(a.features, b.features)


def test_label_selections_grid_propagation_and_counts_match(loaded):
    want, got = _run(
        loaded,
        [JR.label_selection("reddit", True), JR.label_selection("reddit",
                                                                 False),
         *JR.label_partition_selections("reddit", 5),
         JR.build_author_comment_counts("reddit")],
        [R.label_selection("reddit", True), R.label_selection("reddit",
                                                               False),
         *R.label_partition_selections("reddit", 5),
         R.build_author_comment_counts("reddit")])
    assert set(got) == set(want)
    for name in want:
        if name == "author_counts":
            assert list(got[name].items()) == list(want[name].items())
        else:
            assert [vars(c) for c in got[name]] == \
                [vars(c) for c in want[name]]
    want, got = _run(loaded, [JR.build_label_propagation("reddit")],
                     [R.build_label_propagation("reddit")])
    assert [vars(c) for c in got["propagated"]] == \
        [vars(c) for c in want["propagated"]]
    assert got["propagated"]


def test_comment_features_and_blocks_match(data):
    comments = data[0]
    for c in comments[:40]:
        np.testing.assert_array_equal(R.comment_features(c),
                                      JR.comment_features(c))
    assert R.feature_dim() == JR.feature_dim() == 64
    feats = [R.comment_features(c) for c in comments]
    bt = R.features_to_blocked(feats, (32, 32), device="cpu")
    jbt = JR.features_to_blocked(feats, (32, 32))
    assert bt.shape == jbt.shape
    np.testing.assert_array_equal(bt.to_dense().numpy(),
                                  np.asarray(jbt.to_dense()))
    with pytest.raises(ValueError, match="hash_dim"):
        R.comment_features(comments[0], hash_dim=9)


def test_inference_join_matches_the_reference(loaded, data):
    j, p = loaded
    comments = data[0]
    rng = np.random.default_rng(3)
    dim = R.feature_dim()
    w = (rng.standard_normal((64, dim)).astype(np.float32) * 0.2,
         rng.standard_normal(64).astype(np.float32) * 0.01,
         rng.standard_normal((2, 64)).astype(np.float32) * 0.2,
         rng.standard_normal(2).astype(np.float32) * 0.01)
    labels = []
    for c, model in ((j, JaxFF(db="redditff", block=(32, 32))),
                     (p, FFModel(db="redditff", block=(32, 32)))):
        model.setup(c)
        model.load_weights(c, *w)
        params = model.params_from_store(c)
        mod = JR if c is j else R
        out = mod.infer_labels(c, comments, model, params, block=(32, 32))
        assert [o.index for o in out] == [x.index for x in comments]
        labels.append([o.label for o in out])
        stored = list(c.get_set_iterator("reddit", "inferred"))
        assert [o.label for o in stored] == labels[-1]
    assert labels[1] == labels[0]
    assert set(labels[1]) <= {0, 1}


# --- columnar ------------------------------------------------------------
@pytest.fixture(scope="module")
def tables(data):
    return JRC.columnarize(*data), RC.columnarize(*data, device="cpu")


def _np(t):
    return np.asarray(t)


def test_columnarize_matches_the_reference(tables):
    jt, pt = tables
    for name in jt:
        assert list(pt[name].cols) == list(jt[name].cols)
        assert pt[name].dicts == jt[name].dicts
        for col in jt[name].cols:
            np.testing.assert_array_equal(pt[name][col].numpy(),
                                          _np(jt[name][col]))


def test_batch_features_match_the_reference_and_scalar_path(tables, data):
    jt, pt = tables
    got = RC.batch_features(pt["comments"]).numpy()
    np.testing.assert_allclose(got, _np(JRC.batch_features(jt["comments"])),
                               rtol=RTOL, atol=FEATURE_ATOL)
    want = np.stack([R.comment_features(c) for c in data[0]])
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_columnar_ops_match_the_reference(tables, data):
    jt, pt = tables
    jout, jf = JRC.three_way_join(jt)
    pout, pf = RC.three_way_join(pt)
    assert list(pout.cols) == list(jout.cols)
    np.testing.assert_array_equal(pout.mask().numpy(), _np(jout.mask()))
    for col in ("index", "karma", "subscribers", "author_id", "sub_id"):
        np.testing.assert_array_equal(pout[col].numpy(), _np(jout[col]))
    np.testing.assert_allclose(pf.numpy(), _np(jf), rtol=RTOL,
                               atol=FEATURE_ATOL)
    jc, pc = jt["comments"], pt["comments"]
    np.testing.assert_array_equal(RC.propagate_labels(pc).numpy(),
                                  _np(JRC.propagate_labels(jc)))
    np.testing.assert_array_equal(RC.author_comment_counts(pc).numpy(),
                                  _np(JRC.author_comment_counts(jc)))
    for parts in (11, 4):
        np.testing.assert_array_equal(
            RC.label_partition_counts(pc, parts).numpy(),
            _np(JRC.label_partition_counts(jc, parts)))
    # propagation against the host join's set semantics
    pos = {c.author for c in data[0] if c.label == 1}
    assert RC.propagate_labels(pc).tolist() == \
        [int(c.author in pos) for c in data[0]]


def test_columnar_ops_drop_orphan_keys_as_the_reference(tables):
    """An author id outside the authors table (and past the key space
    handed to the kernels) matches nothing and counts for nothing."""
    jt, pt = tables
    n = pt["comments"].num_rows
    aid = pt["comments"]["author_id"].numpy().copy()
    aid[::7] = 99
    lab = np.zeros(n, np.int32)
    lab[::5] = 1
    pc = ColumnTable.from_columns({"author_id": aid, "label": lab,
                                   "index": np.arange(n, dtype=np.int32)},
                                  device="cpu")
    from netsdb_tpu.relational.table import ColumnTable as JaxTable

    jc = JaxTable.from_columns({"author_id": aid, "label": lab,
                                "index": np.arange(n, dtype=np.int32)})
    for n_auth in (18, None):
        np.testing.assert_array_equal(
            RC.propagate_labels(pc, n_auth).numpy(),
            _np(JRC.propagate_labels(jc, n_auth)))
        np.testing.assert_array_equal(
            RC.author_comment_counts(pc, n_auth).numpy(),
            _np(JRC.author_comment_counts(jc, n_auth)))


def test_three_way_sink_matches_the_reference_over_stored_sets(tmp_path,
                                                               tables):
    jt, pt = tables
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax")))
    p = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    for c, tabs in ((j, jt), (p, pt)):
        c.create_database("redditc")
        for name, t in tabs.items():
            c.create_set("redditc", name, type_name="table")
            c.send_table("redditc", name, t)
    want = next(iter(j.execute_computations(
        JRC.three_way_sink_for(j)).values()))
    sink = RC.three_way_sink_for(p)
    got = next(iter(p.execute_computations(sink).values()))
    assert sink.inputs[0].label == JRC.three_way_sink_for(j).inputs[0].label
    np.testing.assert_array_equal(got.mask().numpy(), _np(want.mask()))
    for col in want.cols:
        np.testing.assert_array_equal(got[col].numpy(), _np(want[col]))


def test_sharded_three_way_raises_naming_a4(tables, monkeypatch):
    """``sharded_three_way`` (once ROADMAP.md A4, now ported) over 4
    virtual positions, in both planner branches, gives the reference's
    joined rows over its 4-device mesh: the same valid rows with the same
    karma and subscribers."""
    import jax
    from jax.sharding import Mesh

    from netsdb_tpu.relational import planner as JPLN
    from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from netsdb_tpu_torch.relational import planner as PLN

    def rows(t, valid):
        ok = np.asarray(valid)
        return sorted(zip(*(np.asarray(t[c])[ok].tolist()
                            for c in ("index", "karma", "subscribers"))))

    jmesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    for strategy in (None, "partition"):
        if strategy is not None:
            monkeypatch.setattr(JPLN, "plan_distribution",
                                lambda *a, **k: JPLN.DistPlan("partition"))
            monkeypatch.setattr(PLN, "plan_distribution",
                                lambda *a, **k: PLN.DistPlan("partition"))
        want = JRC.sharded_three_way(tables[0], jmesh)
        with virtual_devices(4, "cpu"):
            got = RC.sharded_three_way(tables[1], make_mesh((4,), ("data",)))
        assert int(got.overflow) == int(want.overflow) == 0
        gcols = {c: v.to_dense().numpy() for c, v in got.cols.items()}
        assert set(gcols) == set(want.cols)
        assert rows(gcols, got.valid.to_dense().numpy()) == \
            rows(want.cols, want.valid)


def test_bench_label_propagation_runs_on_the_cpu():
    res = RC.bench_label_propagation(rows=20_000, n_authors=500, iters=2,
                                     device="cpu")
    assert res["device"] == "cpu" and res["rows_per_sec"] > 0
    cols, dicts = RC.bench_columns(rows=1000, n_authors=40,
                                   n_subs=7)["comments"]
    assert len(dicts["author_id"]) == 40 and cols["label"].sum() < 100
    t = ColumnTable.from_columns(cols, dicts, device="cpu")
    assert RC.batch_features(t).shape == (1000, R.feature_dim())
