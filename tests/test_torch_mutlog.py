"""The port's mutation log against the reference's
(``netsdb_tpu/storage/mutlog.py``): one file format both ways — records
either package appends, the other replays, at equal END offsets — the
same torn-tail truncation, and host-only records (a tensor is logged as
a numpy array, a function inside a logged DAG by value)."""

import os

import numpy as np
import pytest
import torch

from netsdb_tpu_torch.storage.mutlog import MutationLog, host_record

RECORDS = [
    {"op": "frame", "typ": 21, "codec": 1,
     "payload": {"db": "d", "set": "s", "items": [{"i": 1}, {"i": 2}],
                 "__idem__": "tok-1"}},
    {"op": "alias", "alias": "tok-w", "target": "tok-1"},
    {"op": "put", "key": ["d", "t", 1], "token": "tok-2",
     "payload": {"db": "d", "set": "t", "rows": list(range(50))}},
    {"op": "frame", "typ": 22, "codec": 0,
     "payload": {"db": "d", "set": "w",
                 "tensor": {"data": np.arange(12, dtype=np.float32)
                            .reshape(3, 4), "block_shape": [2, 2]}}},
]


def _ref():
    from netsdb_tpu.storage.mutlog import MutationLog as RefLog

    return RefLog


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_records_one_package_appends_the_other_replays(tmp_path, writer):
    path = str(tmp_path / "mirror.log")
    w_cls, r_cls = ((MutationLog, _ref()) if writer == "port"
                    else (_ref(), MutationLog))
    log = w_cls(path)
    ends = [log.append(r) for r in RECORDS]
    assert log.last_offset() == ends[-1] == os.path.getsize(path)
    log.close()
    reader = r_cls(path)
    assert reader.last_offset() == ends[-1]
    got = list(reader.replay(0))
    assert [e for e, _ in got] == ends
    assert all(_equal(r, g) for r, (_, g) in zip(RECORDS, got))
    # replay from a record's END offset yields only what follows it
    assert [e for e, _ in reader.replay(ends[1])] == ends[2:]
    assert list(reader.replay(ends[-1])) == []
    reader.close()


def test_both_packages_write_the_same_bytes(tmp_path):
    """Plain host records pickle alike: the two logs are byte-equal."""
    ours, ref = MutationLog(str(tmp_path / "a.log")), _ref()(
        str(tmp_path / "b.log"))
    for r in RECORDS:
        assert ours.append(r) == ref.append(r)
    ours.close()
    ref.close()
    with open(tmp_path / "a.log", "rb") as fa, \
            open(tmp_path / "b.log", "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("cut", ["header", "payload", "checksum"])
def test_torn_tail_is_truncated_at_the_same_offset(tmp_path, cut):
    """A crash mid-append leaves a torn record: both packages open the
    log at the same valid prefix, and the next append lands there."""
    path = str(tmp_path / "t.log")
    log = MutationLog(path)
    ends = [log.append(r) for r in RECORDS]
    log.close()
    with open(path, "r+b") as f:
        if cut == "header":
            f.truncate(ends[-2] + 5)
        elif cut == "payload":
            f.truncate(ends[-1] - 3)
        else:
            f.seek(ends[-2] + 14)  # a payload byte of the last record
            byte = f.read(1)
            f.seek(ends[-2] + 14)
            f.write(bytes([byte[0] ^ 0xFF]))
    import shutil

    shutil.copy(path, str(tmp_path / "t2.log"))
    ours, ref = MutationLog(path), _ref()(str(tmp_path / "t2.log"))
    assert ours.last_offset() == ref.last_offset() == ends[-2]
    assert os.path.getsize(path) == ends[-2]
    assert [e for e, _ in ours.replay(0)] == ends[:-1]
    assert ours.append({"op": "after"}) == ref.append({"op": "after"})
    ours.close()
    ref.close()


def test_truncate_empties_the_log(tmp_path):
    log = MutationLog(str(tmp_path / "x.log"))
    for r in RECORDS:
        log.append(r)
    log.truncate()
    assert log.last_offset() == 0 and list(log.replay(0)) == []
    assert log.append({"op": "again"}) > 0
    log.close()
    with pytest.raises(ValueError, match="closed"):
        log.append({"op": "late"})


def test_tensors_are_logged_as_host_arrays(tmp_path):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    rec = {"payload": {"x": t, "l": [t, (t, 1)], "n": 3}}
    host = host_record(rec)
    assert isinstance(host["payload"]["x"], np.ndarray)
    assert isinstance(host["payload"]["l"][1][0], np.ndarray)
    log = MutationLog(str(tmp_path / "h.log"))
    log.append(rec)
    (_, back), = list(log.replay(0))
    np.testing.assert_array_equal(back["payload"]["x"], t.numpy())
    assert isinstance(back["payload"]["l"][0], np.ndarray)
    log.close()
    # the reference reads it as plain numpy
    ref = _ref()(str(tmp_path / "h.log"))
    (_, rback), = list(ref.replay(0))
    np.testing.assert_array_equal(rback["payload"]["x"], t.numpy())
    ref.close()


def test_a_logged_function_replays_by_value(tmp_path):
    """A DAG's lambda (what a logged EXECUTE frame holds) pickles by
    value, so a replay runs it even though plain pickle could not have
    written it."""
    scale = 3.0
    fn = lambda x: x * scale  # noqa: E731 — the by-value case
    log = MutationLog(str(tmp_path / "f.log"))
    log.append({"op": "frame", "payload": {"fn": fn}})
    (_, back), = list(log.replay(0))
    assert back["payload"]["fn"](2.0) == 6.0
    log.close()
