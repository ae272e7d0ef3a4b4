"""Parity of the port's device equi-joins for host records
(``relational.autojoin``, ``Join(on=...)``) with the JAX package: the
same seeded reddit records columnarise to the same columns and
dictionaries, and every join (string and int keys, missing keys,
duplicate build keys, masked probes) gives the same rows in the same
order; integers exactly, floats within 1e-6 relative."""

import numpy as np
import pytest

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.relational import autojoin as JA
from netsdb_tpu.workloads import reddit as JR
from netsdb_tpu_torch import Client, Configuration
from netsdb_tpu_torch.plan.computations import (Filter, Join, ScanSet,
                                                WriteSet)
from netsdb_tpu_torch.relational import autojoin as A
from netsdb_tpu_torch.workloads import reddit as R

RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    return R.generate(num_comments=300, num_authors=25, num_subs=6, seed=7)


def _cols(t):
    """A table of either package as (numpy columns, dicts, mask)."""
    return ({n: np.asarray(c) for n, c in t.cols.items()}, dict(t.dicts),
            np.asarray(t.mask()))


def _assert_same_table(got, want):
    gc, gd, gm = _cols(got)
    wc, wd, wm = _cols(want)
    assert list(gc) == list(wc) and gd == wd
    np.testing.assert_array_equal(gm, wm)
    for n in wc:
        if wc[n].dtype.kind == "f":
            np.testing.assert_allclose(gc[n], wc[n], rtol=RTOL)
        else:
            np.testing.assert_array_equal(gc[n], wc[n])


def _both(records):
    return (JA.table_from_objects(records),
            A.table_from_objects(records, device="cpu"))


def test_records_columnarise_as_the_reference(data):
    for records in data:
        want, got = _both(records)
        _assert_same_table(got, want)
        assert got.device.type == "cpu"
    assert "author" in got.dicts or "id" in got.dicts


@pytest.mark.parametrize("case", ["author", "missing", "sub", "dup_build",
                                  "masked_probe", "take_all"])
def test_equijoin_matches_the_reference(data, case):
    comments, authors, subs = data
    jc, pc = _both(comments)
    if case in ("author", "take_all"):
        (ja, pa), key, take = _both(authors), ("author", "author"), \
            (["author_id", "karma"] if case == "author" else None)
    elif case == "missing":
        (ja, pa), key, take = _both(authors[:10]), ("author", "author"), \
            ["author_id"]
    elif case == "sub":
        (ja, pa), key, take = _both(subs), ("subreddit_id", "id"), \
            ["subscribers"]
    elif case == "dup_build":
        dup = list(authors) + [R.Author(author_id=99, author="user3",
                                        karma=7)]
        (ja, pa), key, take = _both(dup), ("author", "author"), ["karma"]
    else:
        (ja, pa), key, take = _both(authors), ("author", "author"), \
            ["karma"]
        jc = jc.filter(np.asarray(jc["score"]) > 1000)
        import torch

        pc = pc.filter(pc["score"] > 1000)
        assert isinstance(pc.valid, torch.Tensor)
    want = JA.equijoin(jc, key[0], ja, key[1], take=take)
    got = A.equijoin(pc, key[0], pa, key[1], take=take)
    _assert_same_table(got, want)
    rows = got.to_rows()
    if case == "missing":
        keep = {a.author for a in authors[:10]}
        assert [r["id"] for r in rows] == [c.id for c in comments
                                           if c.author in keep]
        assert 0 < len(rows) < len(comments)


def test_unify_key_codes_and_concat_match_the_reference(data):
    comments, authors, subs = data
    (jc, pc), (ja, pa) = _both(comments), _both(authors)
    for args in (("author_id", "label"), ("karma", "index")):
        jl, jr, js = JA.unify_key_codes(ja, args[0], jc, args[1])
        pl, pr, ps = A.unify_key_codes(pa, args[0], pc, args[1])
        assert ps == js
        np.testing.assert_array_equal(np.asarray(pl), np.asarray(jl))
        np.testing.assert_array_equal(np.asarray(pr), np.asarray(jr))
    jl, jr, js = JA.unify_key_codes(jc, "author", ja, "author")
    pl, pr, ps = A.unify_key_codes(pc, "author", pa, "author")
    assert ps == js
    np.testing.assert_array_equal(np.asarray(pr), np.asarray(jr))
    with pytest.raises(ValueError, match="type mismatch"):
        A.unify_key_codes(pc, "author", pa, "karma")
    assert A.merge_dicts(["a", "b"], ["c", "a"])[0] == \
        JA.merge_dicts(["a", "b"], ["c", "a"])[0]
    np.testing.assert_array_equal(A.merge_dicts(["a", "b"], ["c", "a"])[1],
                                  JA.merge_dicts(["a", "b"], ["c", "a"])[1])
    (j1, p1), (j2, p2) = _both(comments[:100]), _both(comments[150:])
    _assert_same_table(A.concat_tables(p1, p2), JA.concat_tables(j1, j2))


def test_three_way_string_chain_matches_the_reference(data):
    comments, authors, subs = data
    outs = []
    for mod, kw in ((JA, {}), (A, {"device": "cpu"})):
        ct = mod.table_from_objects(comments, **kw)
        j1 = mod.equijoin(ct, "author", mod.table_from_objects(authors, **kw),
                          "author", take=["author_id", "karma"])
        outs.append(mod.equijoin(j1, "subreddit_id",
                                 mod.table_from_objects(subs, **kw), "id",
                                 take=["subscribers"]))
    _assert_same_table(outs[1], outs[0])


def _load(client, data, type_name):
    client.create_database("reddit")
    for name, items in zip(("comments", "authors", "subs"), data):
        client.create_set("reddit", name, type_name=type_name)
        client.send_data("reddit", name, items)


def test_join_on_dag_matches_the_reference_and_the_host_join(tmp_path, data):
    """``build_three_way_join_device`` over ``objects`` sets equals the
    reference's device DAG, and its rows equal the host hash join's
    (comment index, author_id, karma, subscribers), in order."""
    jdev = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jd")))
    _load(jdev, data, "objects")
    pdev = Client(Configuration(root_dir=str(tmp_path / "pd")), device="cpu")
    _load(pdev, data, "objects")
    phost = Client(Configuration(root_dir=str(tmp_path / "ph")),
                   device="cpu")
    _load(phost, data, "object")
    want = next(iter(jdev.execute_computations(
        JR.build_three_way_join_device("reddit")).values()))
    got = next(iter(pdev.execute_computations(
        R.build_three_way_join_device("reddit")).values()))
    _assert_same_table(got, want)
    host = next(iter(phost.execute_computations(
        R.build_three_way_join("reddit")).values()))
    karma = {a.author_id: a.karma for a in data[1]}
    subscribers = {s.id: s.subscribers for s in data[2]}
    assert [(r["index"], r["author_id"], r["karma"], r["subscribers"])
            for r in got.to_rows()] == \
        [(f.index, f.author_id, karma[f.author_id], subscribers[f.sub_id])
         for f in host]


def test_join_on_columnarises_records_on_the_client_device(tmp_path, data):
    """Plain object sets (records, not tables) reach a ``Join(on=...)``
    columnarised on the client's device; a filtered record input joins
    the same as the reference's."""
    comments, authors, _ = data
    outs = []
    from netsdb_tpu.plan import computations as JC

    for c, M in ((JaxClient(JaxConfiguration(root_dir=str(tmp_path / "j"))),
                  JC),
                 (Client(Configuration(root_dir=str(tmp_path / "p")),
                         device="cpu"), None)):
        _load(c, data, "object")
        F, Jn, S, W = ((Filter, Join, ScanSet, WriteSet) if M is None else
                       (M.Filter, M.Join, M.ScanSet, M.WriteSet))
        node = Jn(F(S("reddit", "comments"), lambda x: x.label == 1,
                    label="pos"),
                  S("reddit", "authors"), on=("author", "author"),
                  take=("karma",))
        outs.append(next(iter(c.execute_computations(
            W(node, "reddit", "o")).values())))
    _assert_same_table(outs[1], outs[0])
    assert outs[1].device.type == "cpu"
    with pytest.raises(ValueError, match="type mismatch"):
        Join(ScanSet("a", "b"), ScanSet("a", "c"),
             on=("author", "karma")).evaluate(comments, authors,
                                              device="cpu")
