"""Model serving over the shard pool on the CPU: the port's counterparts of
``tests/test_model_serving.py``'s 7 tests (``tensor_chain``
scatter-gather, ``ModelServing`` deploy and score, routed matrix ingest,
one program per shard, sharded ANALYZE_SET), each pool in one process
with ``device="cpu"``. The oracle is the single-daemon engine on the same
bytes, as in the reference; with integer-valued f32 weights every
equality is a byte equality. The FF pool's output also equals the
reference's pool output on the same weights and batch, within the FF
parity limit of ``tests/test_torch_ff.py`` (rtol = atol = 1e-5: the
softmax's exp is XLA's on one side).

Every daemon listens on port 0 and is shut down in ``finally``; every
client has a socket timeout."""

import contextlib

import numpy as np
import pytest
import torch

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.models.ff import FFModel as JFF
from netsdb_tpu.models.serving import ff_serving as j_ff_serving
from netsdb_tpu.serve.server import ServeController as JServe
from netsdb_tpu_torch import obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.conv2d import Conv2DModel
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.models.serving import ModelServing, ff_serving
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.serve import placement as PL
from netsdb_tpu_torch.serve.client import RemoteClient
from netsdb_tpu_torch.serve.errors import RemoteError
from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType
from netsdb_tpu_torch.serve.server import ServeController
from netsdb_tpu_torch.storage.store import SetIdentifier

TIMEOUT = 60.0


def _counter(name: str) -> int:
    return obs.REGISTRY.counter(name).value


def _int_f32(rng, shape, lo=-4, hi=4):
    """Integer-valued f32: exact under any reassociation."""
    return rng.integers(lo, hi, size=shape).astype(np.float32)


@contextlib.contextmanager
def pool(tmp_path, n_workers=2):
    daemons = []
    try:
        workers = []
        for i in range(n_workers):
            w = ServeController(
                Configuration(root_dir=str(tmp_path / f"w{i}")), port=0,
                device="cpu")
            w.start()
            daemons.append(w)
            workers.append(w)
        leader = ServeController(
            Configuration(root_dir=str(tmp_path / "leader")), port=0,
            device="cpu", workers=[w.advertise_addr for w in workers])
        leader.start()
        daemons.append(leader)
        yield leader, workers, leader.advertise_addr
    finally:
        for d in daemons:
            d.shutdown()


@contextlib.contextmanager
def solo(tmp_path, name="solo"):
    ctl = ServeController(Configuration(root_dir=str(tmp_path / name)),
                          port=0, device="cpu")
    ctl.start()
    try:
        yield ctl, ctl.advertise_addr
    finally:
        ctl.shutdown()


def _remote(addr):
    return RemoteClient(addr, timeout=TIMEOUT)


def _ff_weights(rng, F, H, L):
    return (_int_f32(rng, (H, F)), _int_f32(rng, (H,)),
            _int_f32(rng, (L, H)), _int_f32(rng, (L,)))


def _ff_oracle(tmp_path, weights, batch, block=(4, 4)):
    """The single-daemon engine's answer for one FF batch."""
    w1, b1, wo, bo = weights
    with solo(tmp_path, "oracle") as (_ctl, addr):
        c = _remote(addr)
        m = FFModel(db="fforacle", block=block)
        m.setup(c)
        m.load_weights(c, w1, b1, wo, bo)
        m.load_inputs(c, batch)
        res = c.execute_computations(m.build_inference_dag(),
                                     job_name="fforacle")
        out = np.asarray(next(iter(res.values())).to_dense())
        c.close()
        return out


def _serve(model, addr, weights, **kw):
    def load(c):
        model.setup(c)
        model.load_weights(c, *weights)

    srv = ff_serving(model, addr, block=model.block, timeout=TIMEOUT, **kw)
    return srv, srv.deploy(load)


def test_ff_serving_byte_equal_cold_and_warm(tmp_path):
    """Scoring over a 5-slot pool equals the single daemon byte for byte,
    cold (the first frame builds each shard's program) and warm."""
    rng = np.random.default_rng(7)
    weights = _ff_weights(rng, 12, 8, 5)
    batch = _int_f32(rng, (32, 12))
    batch2 = _int_f32(rng, (24, 12))
    oracle = _ff_oracle(tmp_path, weights, batch)
    oracle2 = _ff_oracle(tmp_path, weights, batch2)
    with pool(tmp_path, n_workers=4) as (_leader, _workers, addr):
        srv, addrs = _serve(FFModel(db="ffsrv", block=(4, 4)), addr, weights)
        assert len(addrs) == 5
        before = _counter("shard.scatter_queries")
        out = srv.score(batch)
        assert np.array_equal(np.asarray(out.to_dense()), oracle)
        assert _counter("shard.scatter_queries") == before + 1
        assert np.array_equal(np.asarray(srv.score(batch2).to_dense()),
                              oracle2)
        assert np.array_equal(np.asarray(srv.score(batch).to_dense()),
                              oracle)
        got = [np.asarray(o.to_dense())
               for o in srv.score_batches([batch2, batch])]
        assert np.array_equal(got[0], oracle2)
        assert np.array_equal(got[1], oracle)
        srv.close()


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_output_layer_columns_do_not_depend_on_the_batch_width(threads):
    """The FF tail's softmax over labels gives a batch column the same
    bits whatever the batch's width and the thread count: what makes a
    shard's scores equal a whole batch's (a strided reduction on the CPU
    changed the last bit with the width at 1 and 2 threads)."""
    from netsdb_tpu_torch.core.blocked import BlockedTensor
    from netsdb_tpu_torch.ops import nn

    rng = np.random.default_rng(threads)
    y = _int_f32(rng, (5, 32), -60, 60)
    b = _int_f32(rng, (5, 1))
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        def out(cols):
            return nn.ff_output_layer(
                BlockedTensor.from_dense(y[:, cols], (4, 4), device="cpu"),
                BlockedTensor.from_dense(b, (4, 1), device="cpu")
            ).to_dense().numpy()

        whole = out(slice(0, 32))
        for lo, hi in PL.range_slices(32, 5) + [(3, 9), (0, 1)]:
            assert np.array_equal(out(slice(lo, hi)), whole[:, lo:hi])
    finally:
        torch.set_num_threads(old)


def test_ff_pool_equals_the_reference_pool(tmp_path):
    """The port's pool and the reference's pool, the same weights and
    batch: the same scores within the FF parity limit."""
    rng = np.random.default_rng(8)
    weights = _ff_weights(rng, 12, 8, 5)
    batch = _int_f32(rng, (30, 12))
    with pool(tmp_path) as (_leader, _workers, addr):
        srv, _ = _serve(FFModel(db="ffcmp", block=(4, 4)), addr, weights)
        got = np.asarray(srv.score(batch).to_dense())
        srv.close()
    daemons = []
    try:
        for i in range(2):
            w = JServe(JConfiguration(root_dir=str(tmp_path / f"rw{i}")),
                       port=0)
            w.start()
            daemons.append(w)
        lead = JServe(JConfiguration(root_dir=str(tmp_path / "rl")), port=0,
                      workers=[f"127.0.0.1:{w.port}" for w in daemons])
        lead.start()
        daemons.append(lead)
        jm = JFF(db="ffcmp", block=(4, 4))

        def load(c):
            jm.setup(c)
            jm.load_weights(c, *weights)

        jsrv = j_ff_serving(jm, f"127.0.0.1:{lead.port}", block=jm.block)
        jsrv.deploy(load)
        want = np.asarray(jsrv.score(batch).to_dense())
        jsrv.close()
    finally:
        for d in daemons:
            d.shutdown()
    assert got.shape == want.shape == (5, 30)
    # the softmax tail's exp differs from XLA's in the last bit, and XLA
    # flushes subnormal outputs to zero: the packages' FF parity limit
    # (tests/test_torch_ff.py), where the pool and the solo port daemon
    # above agree byte for byte
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ff_serving_per_shard_one_program_proof(tmp_path):
    """Every shard ran the whole layer chain as ONE program: its EXPLAIN
    tree has mode ``whole_plan_jit`` with every plan node fused."""
    rng = np.random.default_rng(11)
    weights = _ff_weights(rng, 12, 8, 5)
    batch = _int_f32(rng, (20, 12))
    with pool(tmp_path) as (_leader, _workers, addr):
        srv, addrs = _serve(FFModel(db="ffproof", block=(4, 4)), addr,
                            weights)
        _out, forest = srv.score(batch, explain=True)
        assert sorted(forest) == sorted(addrs)
        for daemon, tree in forest.items():
            assert tree["mode"] == "whole_plan_jit", daemon
            assert tree["shard"] == daemon
            plan_nodes = [n for n in tree["nodes"]
                          if n.get("kind") != "WholePlanJit"]
            assert plan_nodes and all(n.get("fused") for n in plan_nodes)
            kinds = sorted(n["kind"] for n in plan_nodes)
            assert kinds.count("Scan") == 5 and kinds.count("Join") == 4
        srv.close()


def test_ff_serving_staged_rows_bounded_per_shard(tmp_path):
    """Routed ingest leaves each slot only its contiguous row range: no
    daemon holds the whole batch."""
    rng = np.random.default_rng(13)
    weights = _ff_weights(rng, 12, 8, 5)
    B = 30
    batch = _int_f32(rng, (B, 12))
    with pool(tmp_path, n_workers=3) as (leader, workers, addr):
        srv, addrs = _serve(FFModel(db="ffrows", block=(4, 4)), addr,
                            weights)
        before = _counter("serve.client.routed_ingests")
        srv.score(batch)
        assert _counter("serve.client.routed_ingests") == before + 1
        bound = max(hi - lo for lo, hi in PL.range_slices(B, len(addrs)))
        assert bound < B
        total = 0
        for ctl in [leader] + workers:
            for it in ctl.library.store.get_items(
                    SetIdentifier("ffrows", "inputs")):
                rows = int(it.to_dense().shape[0])
                assert rows <= bound
                total += rows
        assert total == B
        srv.close()


def test_conv2d_items_chain_byte_equal(tmp_path):
    """The tensor_chain kind is a plan contract: a conv DAG over a
    range-placed item set, stamped ``mode="items"``, chains per-item
    outputs in slot order, byte-equal to the solo engine."""
    rng = np.random.default_rng(17)
    images = [_int_f32(rng, (1, 3, 8, 8)) for _ in range(6)]
    kernels = _int_f32(rng, (4, 3, 3, 3))
    bias = _int_f32(rng, (4,))

    def load_weights(c, db):
        c.create_set(db, "kernels", type_name="tensor4d")
        c.create_set(db, "bias", type_name="tensor4d")
        c.send_data(db, "kernels", [kernels])
        c.send_data(db, "bias", [bias])

    with solo(tmp_path, "convsolo") as (_ctl, saddr):
        sc = _remote(saddr)
        m = Conv2DModel(db="conv", activation="relu")
        m.setup(sc)
        sc.send_data("conv", "images", list(images))
        load_weights(sc, "conv")
        res = sc.execute_computations(m.build_inference_dag(),
                                      job_name="convsolo")
        oracle = [np.asarray(v) for v in next(iter(res.values()))]
        sc.close()

    with pool(tmp_path) as (_leader, _workers, addr):
        c = _remote(addr)
        m = Conv2DModel(db="conv", activation="relu")
        c.create_database("conv")
        c.create_set("conv", "images", type_name="tensor4d",
                     placement="range")
        entry = c._placement_entry("conv", "images", refresh=True)
        for sl in entry["slots"]:
            wc = _remote(sl["addr"])
            wc.create_database("conv")
            load_weights(wc, "conv")
            wc.close()
        c.send_data("conv", "images", list(images))
        sink = m.build_inference_dag()
        sink.scatter_gather = {"mode": "items"}
        reply = c._request(
            MsgType.EXECUTE_COMPUTATIONS,
            {"sinks": [sink], "job_name": "convpool", "materialize": True,
             "explain": False}, codec=CODEC_PICKLE)
        results = c._collect_results(reply["results"], True)
        got = [np.asarray(v) for v in next(iter(results.values()))]
        assert len(got) == len(oracle) == 6
        for g, o in zip(got, oracle):
            assert np.array_equal(g, o)
        c.close()


def test_undeclared_chain_refuses_typed(tmp_path):
    """Without the scatter_gather declaration a chain over a sharded
    tensor set refuses with the scatter refusal naming the supported
    shapes: the declaration is the opt-in, never inferred."""
    rng = np.random.default_rng(19)
    weights = _ff_weights(rng, 12, 8, 5)
    with pool(tmp_path) as (_leader, _workers, addr):
        model = FFModel(db="ffrefuse", block=(4, 4))

        def load(c):
            model.setup(c)
            model.load_weights(c, *weights)

        srv = ModelServing(model, addr, batch_axis=1, block=model.block,
                           timeout=TIMEOUT)
        srv.deploy(load)
        c = _remote(addr)
        c.send_matrix("ffrefuse", "inputs", _int_f32(rng, (12, 12)), (4, 4))
        with pytest.raises(RemoteError, match="scatter_gather"):
            c.execute_computations(model.build_inference_dag(),
                                   job_name="refused")
        # a hash-placed tensor set refuses routed matrix ingest
        c.create_set("ffrefuse", "hashed", placement="hash")
        with pytest.raises(ValueError, match="range"):
            c.send_matrix("ffrefuse", "hashed", _int_f32(rng, (4, 4)),
                          (4, 4))
        c.close()
        srv.close()


def test_analyze_set_sharded_merges(tmp_path):
    """ANALYZE_SET over a partitioned table merges the shards' summaries:
    rows sum, min/max envelope, dictionaries union in slot order — the
    solo daemon's answer on the same table."""
    rng = np.random.default_rng(23)
    n = 60
    t = ColumnTable.from_columns({
        "k": rng.integers(0, 9, n).astype(np.int32),
        "cat": np.array([("a", "b", "c")[i] for i in rng.integers(0, 3, n)],
                        dtype=object)}, device="cpu")
    with solo(tmp_path, "ansolo") as (_ctl, saddr):
        sc = _remote(saddr)
        sc.create_database("d")
        sc.create_set("d", "t", type_name="table")
        sc.send_table("d", "t", t)
        oracle = sc.analyze_set("d", "t")
        sc.close()
    with pool(tmp_path) as (_leader, _workers, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", t)
        before = _counter("shard.analyze_fanouts")
        info = c.analyze_set("d", "t")
        assert _counter("shard.analyze_fanouts") == before + 1
        assert info["num_rows"] == oracle["num_rows"] == n
        s, o = info["stats"]["k"], oracle["stats"]["k"]
        assert (s.n_rows, s.min_val, s.max_val) == \
            (o.n_rows, o.min_val, o.max_val)
        assert info["dicts"]["cat"] == oracle["dicts"]["cat"]
        c.close()


def test_analyze_set_local_only_stays_local(tmp_path):
    with pool(tmp_path) as (_leader, _workers, addr):
        c = _remote(addr)
        c.create_database("d")
        c.create_set("d", "t", type_name="table", placement="range")
        c.send_table("d", "t", ColumnTable.from_columns(
            {"k": np.arange(12, dtype=np.int32)}, device="cpu"))
        reply = c._request(MsgType.ANALYZE_SET,
                           {"db": "d", "set": "t", "local_only": True})
        assert reply["num_rows"] < 12
        c.close()
