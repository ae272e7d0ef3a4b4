"""The port's wire protocol against the reference's, on the CPU.

* ``serve/_msgpack.py`` gives the bytes ``msgpack.packb`` gives (the
  reference's codec 0) and decodes them, over a seeded set of nested
  payloads: ints at every width boundary, floats, str and bin, arrays in
  band and out of band;
* ``segment_checksum`` equals the reference's;
* ``serve/_fnpickle.py`` round-trips lambdas, closures, recursive
  closures, defaults, test-local functions and a whole FF DAG of the
  port, and refuses code from another interpreter;
* cross-talk: the reference's ``RemoteClient`` against the port's
  daemon, and the port's against the reference's, with codec-0 frames
  only (PING, DDL, SEND_MATRIX, GET_TENSOR, SET_EXISTS, LIST_SETS).

Every daemon listens on port 0 and is shut down in ``finally``; every
client has a socket timeout."""

import pickle
import socket

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from netsdb_tpu.serve import protocol as ref_protocol
from netsdb_tpu_torch.serve import _fnpickle, _msgpack
from netsdb_tpu_torch.serve import protocol

TIMEOUT = 60.0

_INT_EDGES = sorted({v + d for v in (0, 31, 32, 127, 128, 255, 256, 32767,
                                     32768, 65535, 65536, 2**31 - 1, 2**31,
                                     2**32 - 1, 2**32, 2**63 - 1)
                     for d in (-1, 0, 1)} | {-v for v in (
                         1, 31, 32, 33, 127, 128, 129, 32767, 32768, 32769,
                         2**31 - 1, 2**31, 2**31 + 1, 2**63 - 1, 2**63)}
                    | {2**64 - 1})

_scalars = (st.none() | st.booleans() | st.sampled_from(_INT_EDGES)
            | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False)
            | st.text(max_size=300)
            | st.binary(max_size=300))

_payloads = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=12), inner,
                                     max_size=20)),
    max_leaves=60)

_DTYPES = ("<f4", "<f8", "<i4", "<i8", "|u1", "|b1")


@st.composite
def _arrays(draw):
    dtype = np.dtype(draw(st.sampled_from(_DTYPES)))
    # both sides of the out-of-band threshold
    n = draw(st.sampled_from([0, 1, 7, 255, 256, 300, 2048]))
    seed = draw(st.integers(0, 2**16))
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 100).astype(dtype)


_with_arrays = st.recursive(
    _scalars | _arrays(),
    lambda inner: (st.lists(inner, max_size=6)
                   | st.dictionaries(st.text(max_size=8), inner,
                                     max_size=6)),
    max_leaves=20)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_payloads)
def test_msgpack_bytes_equal_the_reference_and_decode_it(payload):
    ours = _msgpack.packb(payload)
    theirs = msgpack.packb(payload, use_bin_type=True)
    assert ours == theirs
    back = msgpack.unpackb(theirs, raw=False, strict_map_key=False)
    assert _same(_msgpack.unpackb(theirs), back)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(_with_arrays)
def test_codec_bodies_equal_the_reference_in_and_out_of_band(payload):
    payload = {"p": payload, "n": np.int64(-5), "f": np.float32(1.5)}
    ours = protocol.encode_body(payload)
    assert ours == ref_protocol.encode_body(payload)
    assert _same(protocol.decode_body(ours, protocol.CODEC_MSGPACK, False),
                 ref_protocol.decode_body(ours, ref_protocol.CODEC_MSGPACK,
                                          False))
    body, segs = protocol.encode_body_oob(payload)
    rbody, rsegs = ref_protocol.encode_body_oob(payload)
    assert body == rbody
    assert [bytes(s) for s in segs] == [bytes(s) for s in rsegs]
    pairs = [(bytearray(s), ref_protocol.segment_checksum(s)) for s in rsegs]
    codec = (protocol.CODEC_MSGPACK_OOB if segs
             else protocol.CODEC_MSGPACK)
    assert _same(protocol.decode_body(rbody, codec, False, segments=pairs),
                 ref_protocol.decode_body(rbody, codec, False,
                                          segments=pairs))


def test_msgpack_default_and_nesting_limit_like_the_reference():
    calls = []

    def same(obj):
        calls.append("same")
        return obj

    def wrap(obj):
        calls.append("wrap")
        return {"wrapped": obj}

    for pack in (lambda o, d: _msgpack.packb(o, default=d),
                 lambda o, d: msgpack.packb(o, use_bin_type=True,
                                            default=d)):
        with pytest.raises(TypeError):
            pack({"x": object()}, same)
        with pytest.raises(ValueError, match="recursion limit"):
            pack({"x": object()}, wrap)
    assert calls.count("same") == 2
    assert calls.count("wrap") % 2 == 0 and calls.count("wrap") > 2
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1000, 4097, 1 << 16])
def test_segment_checksum_equals_the_reference(size):
    data = np.random.default_rng(size).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()
    assert protocol.segment_checksum(memoryview(data)) == \
        ref_protocol.segment_checksum(memoryview(data))
    assert protocol.segment_checksum(data) == \
        ref_protocol.segment_checksum(data)


def test_frame_header_and_types_are_the_reference_wire():
    assert (protocol.MAGIC, protocol.PROTO_VERSION) == \
        (ref_protocol.MAGIC, ref_protocol.PROTO_VERSION)
    assert {m.name: int(m) for m in protocol.MsgType} == \
        {m.name: int(m) for m in ref_protocol.MsgType}
    assert protocol.MUTATING_TYPES == frozenset(
        protocol.MsgType[m.name] for m in ref_protocol.MUTATING_TYPES)
    # the chaos hook is live: a scripted drop tears the frame down
    from netsdb_tpu_torch.serve.chaos import ChaosInjector

    a, b = socket.socketpair()
    try:
        chaos = ChaosInjector().arm("drop")
        with pytest.raises(ConnectionResetError, match="dropped"):
            protocol.send_frame(a, protocol.MsgType.PING, {}, chaos=chaos)
        assert chaos.faults == [("drop", "send", int(protocol.MsgType.PING))]
    finally:
        a.close()
        b.close()


# --- the function pickler ---------------------------------------------

def _roundtrip(obj):
    return pickle.loads(_fnpickle.dumps(obj))


def test_fnpickle_lambdas_defaults_and_closures():
    scale = 3.0
    f = _roundtrip(lambda x, y=2, *, z=4: x * scale + y + z)
    assert f(1.0) == 9.0 and f(1.0, 0, z=0) == 3.0

    def make_counter(start):
        state = [start]

        def bump(by=1):
            state[0] += by
            return state[0]
        return bump

    g = _roundtrip(make_counter(10))
    assert g() == 11 and g(5) == 16


def test_fnpickle_recursive_closures_and_test_local_functions():
    def outer(k):
        def fact(n):
            return 1 if n <= 1 else n * fact(n - 1) + k
        return fact

    assert _roundtrip(outer(0))(6) == 720

    def is_even(n):
        return True if n == 0 else is_odd(n - 1)

    def is_odd(n):
        return False if n == 0 else is_even(n - 1)

    assert _roundtrip(is_even)(10) is True
    # a function its module exports goes by reference
    assert _roundtrip(np.add) is np.add
    assert _roundtrip(_roundtrip) is _roundtrip


def test_fnpickle_keeps_tensors_and_refuses_another_interpreter(
        monkeypatch):
    import torch

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    fn = _roundtrip(lambda: t * 2)
    out = fn()
    assert out.device == t.device and torch.equal(out, t * 2)
    blob = _fnpickle.dumps(lambda: 1)
    monkeypatch.setattr(_fnpickle, "PY_TAG", "cpython-2.7")
    with pytest.raises(pickle.UnpicklingError, match="cpython-2.7"):
        pickle.loads(blob)


def test_fnpickle_ships_a_whole_ff_dag(tmp_path):
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel

    c = Client(Configuration(root_dir=str(tmp_path / "p")), device="cpu")
    m = FFModel(db="ff", block=(16, 16))
    m.setup(c)
    m.load_random_weights(c, features=32, hidden=48, labels=8, seed=1)
    m.load_inputs(c, np.random.default_rng(2).standard_normal(
        (24, 32)).astype(np.float32))
    sink = m.build_inference_dag()
    want = next(iter(c.execute_computations(sink, job_name="a").values()))
    shipped = _roundtrip(sink)
    got = next(iter(c.execute_computations(shipped,
                                           job_name="b").values()))
    assert got.to_dense().numpy().tobytes() == \
        want.to_dense().numpy().tobytes()


# --- daemons ------------------------------------------------------------

@pytest.fixture()
def port_daemon(tmp_path):
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.serve.server import ServeController

    ctl = ServeController(Configuration(root_dir=str(tmp_path / "port")),
                          port=0, device="cpu")
    ctl.start()
    try:
        yield ctl
    finally:
        ctl.shutdown()


@pytest.fixture()
def ref_daemon(tmp_path):
    from netsdb_tpu.config import Configuration
    from netsdb_tpu.serve.server import ServeController

    ctl = ServeController(Configuration(root_dir=str(tmp_path / "ref")),
                          port=0)
    ctl.start()
    try:
        yield ctl
    finally:
        ctl.shutdown()


def _codec0_session(client_cls, addr):
    """The codec-0 conversation of the cross-talk tests; returns what
    each frame answered."""
    c = client_cls(addr, timeout=TIMEOUT)
    try:
        out = {"ping": sorted(c.ping())}
        c.create_database("x")
        c.create_set("x", "m")
        a = np.arange(48, dtype=np.float32).reshape(6, 8)
        big = np.random.default_rng(0).standard_normal(
            (64, 40)).astype(np.float32)  # rides out of band
        c.send_matrix("x", "m", a, (4, 4))
        c.create_set("x", "big")
        c.send_matrix("x", "big", big, (32, 32))
        out["m"] = c.get_tensor("x", "m").to_dense()
        out["big"] = c.get_tensor("x", "big").to_dense()
        out["block"] = c.get_tensor("x", "m").block_shape
        out["exists"] = (c.set_exists("x", "m"), c.set_exists("x", "nope"))
        out["sets"] = sorted(tuple(s) for s in c.list_sets())
        c.remove_set("x", "big")
        out["sets_after"] = sorted(tuple(s) for s in c.list_sets())
        return out
    finally:
        c.close()


def _assert_same_session(got, want):
    assert got["ping"] == want["ping"]
    np.testing.assert_array_equal(got["m"], want["m"])
    np.testing.assert_array_equal(got["big"], want["big"])
    assert tuple(got["block"]) == tuple(want["block"])
    assert got["exists"] == want["exists"] == (True, False)
    assert got["sets"] == want["sets"]
    assert got["sets_after"] == want["sets_after"] == [("x", "m")]


def test_reference_client_against_the_port_daemon(port_daemon, ref_daemon):
    from netsdb_tpu.serve.client import RemoteClient as RefClient

    got = _codec0_session(RefClient, port_daemon.advertise_addr)
    want = _codec0_session(RefClient, ref_daemon.advertise_addr)
    _assert_same_session(got, want)
    # the reference's HELLO names no interpreter: the port's daemon
    # refuses it the pickle codec, typed and fatal
    c = RefClient(port_daemon.advertise_addr, timeout=TIMEOUT)
    try:
        c.create_database("o")
        c.create_set("o", "s", type_name="object")
        from netsdb_tpu.serve.client import RemoteError

        with pytest.raises(RemoteError, match="pickled frame refused") as e:
            c.send_data("o", "s", [1, 2, 3])
        assert not e.value.retryable
    finally:
        c.close()


def test_port_client_against_the_reference_daemon(port_daemon, ref_daemon):
    from netsdb_tpu_torch.serve.client import (ProtocolVersionError,
                                               RemoteClient)

    got = _codec0_session(RemoteClient, ref_daemon.advertise_addr)
    want = _codec0_session(RemoteClient, port_daemon.advertise_addr)
    _assert_same_session(got, want)
    c = RemoteClient(ref_daemon.advertise_addr, timeout=TIMEOUT)
    try:
        # the reference daemon named no interpreter: no pickle is sent
        assert c.pickle_ok is False
        with pytest.raises(ProtocolVersionError, match="did not name"):
            c.send_data("x", "m", [1])
    finally:
        c.close()


def test_daemon_refuses_pickle_from_another_interpreter(port_daemon):
    s = socket.create_connection(("127.0.0.1", port_daemon.port),
                                 timeout=TIMEOUT)
    try:
        protocol.send_frame(s, protocol.MsgType.HELLO,
                            {"token": None, "proto": protocol.PROTO_VERSION,
                             protocol.PY_KEY: "cpython-2.7"})
        typ, reply = protocol.recv_frame(s)
        assert typ == protocol.MsgType.OK
        assert reply[protocol.PY_KEY] == _fnpickle.PY_TAG
        protocol.send_frame(s, protocol.MsgType.LIST_SETS, [1],
                            codec=protocol.CODEC_PICKLE)
        typ, reply = protocol.recv_frame(s)
        assert typ == protocol.MsgType.ERR
        assert "cpython-2.7" in reply["message"]
        assert reply["retryable"] is False
        # the connection stays frame-synchronized
        protocol.send_frame(s, protocol.MsgType.PING, {})
        typ, reply = protocol.recv_frame(s)
        assert typ == protocol.MsgType.OK and reply["uptime"] >= 0
    finally:
        s.close()


def test_error_taxonomy_equals_the_reference():
    import inspect

    from netsdb_tpu.serve import errors as ref_errors
    from netsdb_tpu_torch.serve import errors

    def classes(mod):
        return {n: c for n, c in vars(mod).items()
                if inspect.isclass(c) and issubclass(c, Exception)}

    ours, theirs = classes(errors), classes(ref_errors)
    assert sorted(ours) == sorted(theirs)
    for name, cls in theirs.items():
        assert [b.__name__ for b in ours[name].__mro__] == \
            [b.__name__ for b in cls.__mro__], name
        assert getattr(ours[name], "retryable", None) == \
            getattr(cls, "retryable", None), name
    assert errors.BACKPRESSURE_FIELDS == ref_errors.BACKPRESSURE_FIELDS
    for kind in ("AdmissionFull", "LaneSaturated", "SessionMoved",
                 "NotLeader", "AuthError", "Unknown"):
        for retryable in (True, False):
            reply = {"error": kind, "message": "m", "retryable": retryable,
                     "retry_after_s": 0.5, "owner_addr": "h:1"}
            a, b = errors.classify_remote(reply), \
                ref_errors.classify_remote(reply)
            assert type(a).__name__ == type(b).__name__
            assert (a.retryable, a.retry_after_s, a.owner_addr) == \
                (b.retryable, b.retry_after_s, b.owner_addr)
    assert errors.AdmissionFull("x", retry_after_s=1.0, queue_depth=3,
                                lane="a").queue_depth == 3
