"""The shard pool's placement helpers against the reference's
``netsdb_tpu/serve/placement.py``: the splitmix64 mix, slot ids, range
slices, table and item splits (exact equality: a key must land on the
same slot in both packages), and the placement map's wire form after the
same sequence of membership changes."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.serve import placement as JPL
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.serve import placement as PL


def _tables(cols, dicts=None):
    return (JTable(dict(cols), dict(dicts or {}), None),
            ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()},
                        dict(dicts or {}), None))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(-2**31, 2**31 - 1), min_size=1, max_size=64),
       st.integers(1, 9))
def test_mix_and_slot_ids_equal_the_reference(keys, nslots):
    a = np.asarray(keys, np.int64)
    assert np.array_equal(PL.mix64_array(a), JPL.mix64_array(a))
    for dtype in (np.int32, np.int64):
        k = a.astype(dtype)
        assert np.array_equal(PL.hash_slot_ids(k, nslots),
                              JPL.hash_slot_ids(k, nslots))
    # a device-side key column lands on the host mix's slots
    t = torch.from_numpy(a.astype(np.int32))
    assert np.array_equal(PL.hash_slot_ids(t, nslots),
                          JPL.hash_slot_ids(a.astype(np.int32), nslots))


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 500), st.integers(1, 9))
def test_range_slices_equal_the_reference(nrows, nslots):
    got = PL.range_slices(nrows, nslots)
    assert got == JPL.range_slices(nrows, nslots)
    assert got[0][0] == 0 and got[-1][1] == nrows


@pytest.mark.parametrize("item", [
    {"k": 3, "v": "x"}, ("a", 1, 2.5), "plain", 17, [1, 2, 3]])
@pytest.mark.parametrize("nslots", [1, 3, 5])
def test_item_slot_equals_the_reference(item, nslots):
    assert PL.item_slot(item, nslots) == JPL.item_slot(item, nslots)


@pytest.mark.parametrize("mode,key", [("range", None), ("hash", "k")])
@pytest.mark.parametrize("nslots", [2, 3, 4])
def test_split_table_equals_the_reference(mode, key, nslots):
    rng = np.random.default_rng(nslots)
    cols = {"k": rng.integers(0, 50, 997, dtype=np.int32),
            "v": rng.standard_normal(997).astype(np.float32),
            "s": rng.integers(0, 3, 997, dtype=np.int32)}
    jt, pt = _tables(cols, {"s": ["a", "b", "c"]})
    entry = {"mode": mode, "key": key,
             "slots": [{"addr": f"h:{i}", "state": "live"}
                       for i in range(nslots)]}
    want = JPL.split_table(jt, entry)
    got = PL.split_table(pt, entry)
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dicts == w.dicts
        for name in cols:
            assert np.array_equal(g.cols[name].numpy(),
                                  np.asarray(w.cols[name]))


def test_split_table_refuses_a_missing_hash_key_like_the_reference():
    jt, pt = _tables({"other": np.arange(10, dtype=np.int32)})
    entry = {"mode": "hash", "key": "k",
             "slots": [{"addr": "x", "state": "live"}] * 2}
    with pytest.raises(ValueError, match="declares key"):
        JPL.split_table(jt, entry)
    with pytest.raises(ValueError, match="declares key"):
        PL.split_table(pt, entry)


@pytest.mark.parametrize("mode,key,items", [
    ("range", None, list(range(23))),
    ("hash", "k", [{"k": i % 7, "v": i} for i in range(40)]),
    ("hash", "k", [{"k": 1}, "no-key", ("t", 2), {"k": 9}]),
    ("hash", None, ["a", "b", ("c", 1), 4.5])])
def test_split_items_equals_the_reference(mode, key, items):
    entry = {"mode": mode, "key": key,
             "slots": [{"addr": "x", "state": "live"}] * 3}
    assert PL.split_items(list(items), entry) == \
        JPL.split_items(list(items), entry)


def _sequence(m):
    m.create("d", "t", ["a:1", "b:2", "c:3"], mode="hash", key="k")
    m.create("d", "r", ["a:1", "b:2", "c:3"])
    m.degrade_addr("b:2")
    m.readmit_addr("b:2")
    m.degrade_addr("c:3")
    m.rebind_addr("a:1", "z:9")
    m.move_slot("d", "r", 1, "y:8")
    m.create("e", "u", ["z:9", "b:2"], mode="range")
    m.remove("e", "u")
    return m


def test_placement_map_wire_equals_the_reference():
    got, want = _sequence(PL.PlacementMap()), _sequence(JPL.PlacementMap())
    assert got.to_wire() == want.to_wire()
    assert got.sets() == want.sets() and len(got) == len(want)
    assert got.sets_for_addr("b:2") == want.sets_for_addr("b:2")
    assert got.move_slot("d", "r", 7, "q:1") is None
    assert want.move_slot("d", "r", 7, "q:1") is None
    # restore keeps the epochs exactly
    r = PL.PlacementMap()
    assert r.restore(want.to_wire()) == 2
    assert r.to_wire() == want.to_wire()
    assert PL.PlacementMap.entry_from_wire(r.to_wire(), "d", "t") == \
        JPL.PlacementMap.entry_from_wire(want.to_wire(), "d", "t")
    assert PL.PlacementMap.entry_from_wire({}, "d", "t") is None
    with pytest.raises(ValueError, match="hash' or 'range"):
        PL.PlacementMap().create("d", "t", ["a"], mode="mirror")


def test_placement_map_basics():
    m = PL.PlacementMap()
    e = m.create("d", "t", ["a:1", "b:2", "c:3"], mode="hash", key="k")
    assert e["epoch"] == 1 and len(e["slots"]) == 3
    assert m.degrade_addr("b:2") == [("d", "t")]
    e2 = m.entry("d", "t")
    assert e2["epoch"] == 2
    assert [s["state"] for s in e2["slots"]] == [PL.LIVE, PL.HANDOFF,
                                                PL.LIVE]
    m.readmit_addr("b:2")
    assert m.entry("d", "t")["epoch"] == 3
    # readers get copies
    m.entry("d", "t")["slots"][0]["state"] = "mutated"
    assert m.entry("d", "t")["slots"][0]["state"] == PL.LIVE
