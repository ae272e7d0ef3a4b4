"""The port's compiled-program cache (``netsdb_tpu_torch/plan/executor.py``
and ``plan/programs.py``) against the reference's (``_cached_jit``,
``netsdb_tpu/plan/executor.py:43-148``), on the CPU.

On the CPU a program is the composed eager callable and a trace is its
first build per input signature, so the keys and counters must follow
the reference's: the same keys for the same jobs, and the same deltas of
``hits``/``misses``/``traces``/``region_traces`` over the request
sequences of ``tests/test_fusion.py:151,167`` and
``tests/test_staging.py:202``. Results through programs equal the
reference's (FF, the transformer layer with B1's plain path, logreg, the
three LA tasks through ``compile_pdml``; f32 within 1e-5, the layer
1e-4). The stale-program cases are written for the port: the reference
keys on job name and plan shape alone, so it would reuse a program in
each of them (ROADMAP.md §C); the port must give each request its own
result. Where the port's key differs by design — a scanned set written
again is a new signature (a new trace), since a captured graph reads it
in place — the test says so.
"""

import contextlib
import dataclasses
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JClient
from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.core.blocked import BlockedTensor as JBlocked
from netsdb_tpu.core.blocked import BlockMeta as JMeta
from netsdb_tpu.models.ff import FFModel as JFF
from netsdb_tpu.models.logreg import LogRegModel as JLogReg
from netsdb_tpu.models.transformer import TransformerLayerModel as JLayer
from netsdb_tpu.plan import executor as jex
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu.relational.table import ColumnTable as JTable
from netsdb_tpu.workloads import la_tasks as jla
from netsdb_tpu_torch import Client, obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.models.logreg import LogRegModel
from netsdb_tpu_torch.models.transformer import TransformerLayerModel
from netsdb_tpu_torch.ops import common as ops_common
from netsdb_tpu_torch.ops.embedding import embedding_lookup
from netsdb_tpu_torch.plan import executor as pex
from netsdb_tpu_torch.plan import programs
from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet
from netsdb_tpu_torch.relational import dag as pdag
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.workloads import la_tasks

TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("hits", "misses", "traces")


@pytest.fixture(autouse=True)
def _clean():
    jex.clear_compiled_cache()
    pex.clear_compiled_cache()
    yield


def jclient(tmp_path, **cfg):
    return JClient(JConfiguration(root_dir=str(tmp_path / "ref"), **cfg))


def pclient(tmp_path, **cfg):
    return Client(Configuration(root_dir=str(tmp_path / "port"), **cfg),
                  device="cpu")


def delta(after, before):
    d = {k: after[k] - before[k] for k in COUNTERS}
    d["regions"] = {k: v - before["region_traces"].get(k, 0)
                    for k, v in after["region_traces"].items()
                    if v != before["region_traces"].get(k, 0)}
    return d


# --- the counters follow the reference's -------------------------------------

def _ingest_lineitem(c, n, ref, seed=2):
    rng = np.random.default_rng(seed)
    if c.set_exists("d", "lineitem"):
        c.remove_set("d", "lineitem")
    c.create_set("d", "lineitem", type_name="table", storage="paged")
    cols = {"l_shipdate": rng.integers(19940101, 19950101, n, dtype=np.int32),
            "l_discount": np.full(n, 0.06, np.float32),
            "l_quantity": np.full(n, 10.0, np.float32),
            "l_extendedprice": rng.uniform(1000, 2000, n).astype(np.float32)}
    c.send_table("d", "lineitem", JTable(cols, {}) if ref else
                 ColumnTable.from_columns(cols, device="cpu"))
    return cols


def _mixed(ref, spine=4):
    """tests/test_fusion.py's ``_mixed_sink`` in either package."""
    if ref:
        from netsdb_tpu.plan.computations import (Apply as A, Join as J,
                                                  ScanSet as S, WriteSet as W)
        T, dag, xsum = JTable, jdag, jnp.sum
    else:
        from netsdb_tpu_torch.plan.computations import (Apply as A, Join as J,
                                                        ScanSet as S,
                                                        WriteSet as W)
        T, dag, xsum = ColumnTable, pdag, torch.sum
    node = S("d", "dim")
    for i in range(spine):
        node = A(node, lambda t, _i=i: T({"x": t["x"] * (1.0 + 1e-6 * _i)},
                                         t.dicts, t.valid), label=f"sp{i}")
    z = A(node, lambda t: xsum(t["x"]) * 1e-9, label="zsum")
    q06 = dag.q06_sink("d")
    j = J(q06.inputs[0], z, fn=lambda rev, v: T(
        {"revenue": rev["revenue"] + v}, rev.dicts, rev.valid),
        label="combine")
    return W(j, "d", "out")


def _fusion_client(tmp_path, ref):
    c = (jclient if ref else pclient)(tmp_path, fusion_cost_source="static")
    c.create_database("d")
    rng = np.random.default_rng(0)
    c.create_set("d", "dim", type_name="table")
    cols = {"x": rng.standard_normal(512).astype(np.float32)}
    c.send_table("d", "dim", JTable(cols, {}) if ref else
                 ColumnTable.from_columns(cols, device="cpu"))
    return c


SEQUENCES = {
    # tests/test_fusion.py:151 — three sizes in one bucket (1536)
    "fused_ragged_tails": ("fz-ragged", (1100, 1300, 1233)),
    # tests/test_fusion.py:167 — a bucket transition and back
    "fused_bucket_transitions": ("fz-bucket", (1100, 3000, 2900, 1200)),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_fusion_counters_follow_the_reference(tmp_path, name):
    job, sizes = SEQUENCES[name]
    steps = {}
    for ref in (True, False):
        ex = jex if ref else pex
        c = _fusion_client(tmp_path / str(ref), ref)
        seen = []
        for n in sizes:
            _ingest_lineitem(c, n, ref)
            before = ex.compile_stats()
            out = c.execute_computations(_mixed(ref), job_name=job)
            seen.append((delta(ex.compile_stats(), before),
                         np.asarray(next(iter(out.values()))["revenue"])))
        steps[ref] = seen
    for (pd, pv), (jd, jv) in zip(steps[False], steps[True]):
        assert pd == jd
        np.testing.assert_allclose(pv, jv, rtol=1e-5)
    # the reference's own assertions hold for the port: flat after the
    # first request of each bucket
    assert steps[False][-1][0]["traces"] == 0


def test_staging_recompile_counter_follows_the_reference(tmp_path):
    """tests/test_staging.py:202: q06 over paged lineitems of three sizes
    in one bucket adds no trace after the first."""
    steps = {}
    for ref in (True, False):
        ex = jex if ref else pex
        c = (jclient if ref else pclient)(tmp_path / str(ref))
        c.create_database("d")
        seen = []
        for n in (1100, 1300, 1233):
            cols = _ingest_lineitem(c, n, ref)
            before = ex.compile_stats()
            out = (jdag if ref else pdag).run_query(
                c, (jdag if ref else pdag).q06_sink("d"))
            want = float((cols["l_extendedprice"] * cols["l_discount"]).sum(
                dtype=np.float64))
            np.testing.assert_allclose(float(np.asarray(out["revenue"])[0]),
                                       want, rtol=1e-4)
            seen.append(delta(ex.compile_stats(), before))
        steps[ref] = seen
    assert steps[False] == steps[True]
    assert [s["traces"] for s in steps[False][1:]] == [0, 0]


def test_keys_equal_the_reference_for_the_same_jobs(tmp_path):
    """The same job gives the same key strings in both packages: the
    whole-plan key of FF's DAG, and a fused paged plan's fold and region
    keys."""
    keys = {}
    for ref in (True, False):
        ex = jex if ref else pex
        c = _fusion_client(tmp_path / str(ref), ref)
        _ingest_lineitem(c, 900, ref)
        c.execute_computations(_mixed(ref), job_name="keys")
        m = (JFF if ref else FFModel)(block=(8, 8))
        m.setup(c)
        rng = np.random.default_rng(0)
        m.load_weights(c, rng.standard_normal((32, 16)).astype(np.float32),
                       np.zeros(32, np.float32),
                       rng.standard_normal((8, 32)).astype(np.float32),
                       np.zeros(8, np.float32))
        m.load_inputs(c, rng.standard_normal((16, 16)).astype(np.float32))
        m.inference(c)
        keys[ref] = sorted(ex.compiled_cache_keys())
    assert keys[False] == keys[True]
    assert any(k.startswith("ff-inference::") for k in keys[False])


def test_compile_stats_has_the_reference_shape():
    assert set(pex.compile_stats()) == set(jex.compile_stats()) == {
        "hits", "misses", "traces", "region_traces"}
    assert obs.REGISTRY.snapshot()["compile"] == pex.compile_stats()


def test_cache_is_an_lru_of_64_and_clears():
    noop = (lambda x: x)
    for i in range(pex._COMPILED_CACHE_CAP + 10):
        pex.run_program(f"lru-test::{i}", noop, torch.ones(1))
    keys = pex.compiled_cache_keys()
    assert len(keys) == pex._COMPILED_CACHE_CAP
    assert keys[0] == "lru-test::10" and keys[-1] == "lru-test::73"
    pex.clear_compiled_cache()
    assert pex.compiled_cache_keys() == []
    assert pex.compile_stats()["region_traces"] == {}


def test_region_trace_map_is_bounded():
    with pex._cache_lock:
        for i in range(pex._REGION_TRACES_CAP + 50):
            pex._region_traces[f"synthetic:{i}"] = 1
            while len(pex._region_traces) > pex._REGION_TRACES_CAP:
                pex._region_traces.pop(next(iter(pex._region_traces)))
    assert len(pex.compile_stats()["region_traces"]) == \
        pex._REGION_TRACES_CAP
    pex.clear_compiled_cache()
    assert pex.compile_stats()["region_traces"] == {}


# --- results through programs equal the reference's --------------------------

def _ff_pair(tmp_path, size=(16, 32, 8, 16), block=(8, 8), seed=0):
    f, h, l, b = size
    rng = np.random.default_rng(seed)
    w = dict(w1=rng.standard_normal((h, f)).astype(np.float32) * 0.3,
             b1=rng.standard_normal((h,)).astype(np.float32) * 0.1,
             wo=rng.standard_normal((l, h)).astype(np.float32) * 0.3,
             bo=rng.standard_normal((l,)).astype(np.float32) * 0.1)
    x = rng.standard_normal((b, f)).astype(np.float32)
    out = []
    for cls, c in ((JFF, jclient(tmp_path)), (FFModel, pclient(tmp_path))):
        m = cls(block=block)
        m.setup(c)
        m.load_weights(c, **w)
        m.load_inputs(c, x)
        out.append((m, c))
    return out, w, x


def _ff_numpy(w, x):
    z = np.maximum(w["w1"].astype(np.float64) @ x.T + w["b1"][:, None], 0)
    z = w["wo"] @ z + w["bo"][:, None]
    e = np.exp(z - z.max(0))
    return e / e.sum(0)


@pytest.mark.parametrize("size", [(16, 32, 8, 16), (13, 27, 5, 11)])
def test_ff_through_its_program_matches_the_reference(tmp_path, size):
    (jm, jc), (pm, pc) = _ff_pair(tmp_path, size)[0]
    before = pex.compile_stats()
    first = pm.inference(pc)
    second = pm.inference(pc)
    d = delta(pex.compile_stats(), before)
    assert (d["misses"], d["hits"], d["traces"]) == (1, 1, 1)
    ref = jm.inference(jc)
    for got in (first, second):
        np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data),
                                   **TOL)
    assert first.data is not second.data  # each request its own result


@pytest.mark.parametrize("causal", [True, False])
def test_layer_through_its_program_matches_the_reference(tmp_path, causal):
    x = np.random.default_rng(1).standard_normal((2, 64, 64)).astype(
        np.float32)
    outs = []
    for cls, c in ((JLayer, jclient(tmp_path)), (TransformerLayerModel,
                                                 pclient(tmp_path))):
        m = cls(num_heads=4)
        m.setup(c)
        m.load_random_weights(c, embed=64, seed=0)
        m.load_inputs(c, x)
        outs.append(np.asarray(m.serve_forward(c, causal=causal)))
        outs.append(np.asarray(m.serve_forward(c, causal=causal)))
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[2], outs[3])
    assert any(k.startswith("transformer-forward::")
               for k in pex.compiled_cache_keys())


def test_logreg_through_its_program_matches_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    w = rng.standard_normal(24).astype(np.float32) * 0.2
    x = rng.standard_normal((40, 24)).astype(np.float32)
    got = []
    for cls, c in ((JLogReg, jclient(tmp_path)), (LogRegModel,
                                                  pclient(tmp_path))):
        m = cls(block=(8, 8))
        m.setup(c)
        m.load_weights(c, w, 0.1)
        m.load_inputs(c, x)
        got.append([np.asarray(m.inference(c).to_dense()) for _ in range(2)])
    for out in got[1]:
        np.testing.assert_allclose(out, got[0][0], **TOL)


@pytest.mark.parametrize("task", la_tasks.TASKS)
def test_compile_pdml_is_one_program_and_matches_the_reference(task):
    env = la_tasks.make_inputs(task, 50, 12, 8, seed=4, device="cpu")
    jenv = {k: JBlocked(jnp.asarray(v.data.numpy()),
                        JMeta(v.shape, v.meta.block_shape))
            for k, v in env.items()}
    fn = la_tasks.compile_pdml(la_tasks.PROGRAMS[task])
    before = pex.compile_stats()
    ours = [fn(env), fn(env)]
    d = delta(pex.compile_stats(), before)
    assert (d["misses"], d["hits"], d["traces"]) == (1, 1, 1)
    assert f"pdml::{la_tasks.PROGRAMS[task]}" in pex.compiled_cache_keys()
    ref = jla.compile_pdml(jla.PROGRAMS[task])(jenv)
    for out in ours:
        for name, r in ref.items():
            np.testing.assert_allclose(out[name].data.numpy(),
                                       np.asarray(r.data), **TOL)


def test_lstm_sequence_is_one_program(tmp_path):
    from netsdb_tpu_torch.models.lstm_model import LSTMModel
    from netsdb_tpu_torch.ops.lstm import lstm_unroll

    c = pclient(tmp_path)
    rng = np.random.default_rng(5)
    m = LSTMModel(block=(8, 8))
    m.setup(c)
    w = {}
    for g in "ifco":
        w[f"w_{g}"] = rng.standard_normal((12, 10)).astype(np.float32) * 0.3
        w[f"u_{g}"] = rng.standard_normal((12, 12)).astype(np.float32) * 0.3
        w[f"b_{g}"] = rng.standard_normal(12).astype(np.float32) * 0.1
    m.load_weights(c, w)
    m.load_state(c, rng.standard_normal((12, 6)).astype(np.float32),
                 rng.standard_normal((12, 6)).astype(np.float32))
    xs = rng.standard_normal((4, 10, 6)).astype(np.float32)
    before = pex.compile_stats()
    a, b = m.run_sequence(c, xs), m.run_sequence(c, xs)
    d = delta(pex.compile_stats(), before)
    assert (d["misses"], d["traces"]) == (1, 1)
    xp = torch.stack([BlockedTensor.from_dense(x, (8, 8), device="cpu").data
                      for x in xs])
    h = c.get_tensor("lstm", "h")
    want = lstm_unroll(m.params_from_store(c), xp, h, c.get_tensor("lstm",
                                                                   "c"))
    for got in (a, b):
        np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())


# --- stale programs ----------------------------------------------------------

def _scale_sink(factor, label="scale"):
    return WriteSet(Apply(ScanSet("d", "m"), lambda t: t.with_data(
        t.data * factor), label=label), "d", "out")


def _matrix_client(tmp_path, values, **cfg):
    c = pclient(tmp_path, **cfg)
    c.create_database("d")
    c.create_set("d", "m")
    c.send_matrix("d", "m", values, (4, 4))
    return c


def _run(c, sink, job="stale"):
    return next(iter(c.execute_computations(sink, job_name=job).values()))


def test_two_ff_models_of_other_shapes_get_their_own_programs(tmp_path):
    """The reference's ``inference_fused`` of a second model with other
    shapes reuses the first compilation (job name + plan shape); here the
    closure's params and the inputs' shapes key the program."""
    c = pclient(tmp_path)
    for size in ((16, 32, 8, 16), (24, 40, 6, 10)):
        f, h, l, b = size
        rng = np.random.default_rng(sum(size))
        w = dict(w1=rng.standard_normal((h, f)).astype(np.float32) * 0.3,
                 b1=rng.standard_normal(h).astype(np.float32) * 0.1,
                 wo=rng.standard_normal((l, h)).astype(np.float32) * 0.3,
                 bo=rng.standard_normal(l).astype(np.float32) * 0.1)
        x = rng.standard_normal((b, f)).astype(np.float32)
        m = FFModel(block=(8, 8))  # the same db, the same job name
        m.setup(c)
        m.load_weights(c, **w)
        m.load_inputs(c, x)
        got = m.inference_fused(c).to_dense().numpy()
        np.testing.assert_allclose(got, _ff_numpy(w, x), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("path", ["whole_plan", "region"])
def test_same_labels_other_constants_get_their_own_programs(tmp_path, path):
    """Two DAGs, the same labels and job, other closure constants: the
    reference would replay the first DAG's constants."""
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    c = _matrix_client(tmp_path, x, fusion_cost_source="static")
    if path == "region":
        _ingest_lineitem(c, 300, ref=False)
    for factor in (2.0, 3.0, 2.0):
        sink = _scale_sink(factor)
        if path == "region":
            # a two-node spine beside a paged fold: one region program
            spine = Apply(sink.inputs[0], lambda t: t.with_data(t.data + 0),
                          label="plus0")
            sink = WriteSet(spine, "d", "out")
            q06 = pdag.q06_sink("d")
            got = c.execute_computations(sink, q06, job_name="stale-r")
            got = got[SetIdentifier("d", "out")]
        else:
            got = _run(c, sink)
        np.testing.assert_array_equal(got.to_dense().numpy(), x * factor)


@pytest.mark.parametrize("in_place", [False, True])
def test_a_set_written_again_with_the_same_shape_is_read_anew(
        tmp_path, in_place):
    """Written again with the same shape: by ``send_matrix`` (new
    tensors) or by ``update_set`` rewriting the set's tensor in place
    (the same object at the same address). A program reads a scanned set
    in place, keyed by its write version, so either write drops its
    variant and the request is a new trace — by design (the reference's
    jit reads its argument anew and traces nothing)."""
    x = np.ones((8, 8), np.float32)
    c = _matrix_client(tmp_path, x)
    np.testing.assert_array_equal(_run(c, _scale_sink(2.0)).to_dense(),
                                  2 * x)
    before = pex.compile_stats()
    if in_place:
        def rewrite(items):
            items[0].data.mul_(5)
            return items
        c.store.update_set(SetIdentifier("d", "m"), rewrite)
    else:
        c.send_matrix("d", "m", 5 * x, (4, 4))
    np.testing.assert_array_equal(_run(c, _scale_sink(2.0)).to_dense(),
                                  10 * x)
    d = delta(pex.compile_stats(), before)
    assert (d["hits"], d["misses"], d["traces"]) == (1, 0, 1)


def test_a_set_evicted_and_reloaded_between_requests(tmp_path):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    c = _matrix_client(tmp_path, x)
    c.store.max_host_bytes = 300  # one 8 x 8 f32 matrix
    np.testing.assert_array_equal(_run(c, _scale_sink(2.0)).to_dense(),
                                  2 * x)
    c.create_set("d", "other")
    c.send_matrix("d", "other", np.zeros((8, 8), np.float32), (4, 4))
    assert c.store.stats.evictions >= 1
    assert not c.store.set_stats(SetIdentifier("d", "m"))["in_memory"]
    np.testing.assert_array_equal(_run(c, _scale_sink(2.0)).to_dense(),
                                  2 * x)


def test_a_write_drops_the_variants_that_read_the_set(tmp_path):
    """A variant reading a set in place is dropped by a write to the set
    or its removal, which releases the set's old tensors."""
    x = np.ones((8, 8), np.float32)
    c = _matrix_client(tmp_path, x)
    _run(c, _scale_sink(2.0))
    prog = next(p for p in pex.cached_programs()
                if p.key.startswith("stale::"))
    assert prog.variants() == 1
    c.send_matrix("d", "m", x, (4, 4))
    assert prog.variants() == 0
    _run(c, _scale_sink(2.0))
    c.remove_set("d", "m")
    assert prog.variants() == 0


class _FakeCard:
    """What ``Program._build`` reads of a card tensor and a stream."""

    is_cuda = True
    device = "cuda:0"

    def wait_stream(self, other):
        pass


def test_builds_run_one_at_a_time_and_restore_the_process_state(
        monkeypatch):
    """Two threads building programs at once. A build watches its first
    run with the process's sync debug mode and warning hook, so builds
    are serialised, and after both the mode and the hook are what they
    were. The CPU build of torch has no sync debug mode and no streams:
    they are replaced by stand-ins here, and the capture fails (a counted
    fallback); ``chip_smoke.py`` phase 14 builds from two threads on the
    card."""
    mode = {"v": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["v"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("v", m))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeCard())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(programs, "_capture_stream",
                        lambda device: _FakeCard())
    monkeypatch.setattr(programs, "_uncapturable", lambda trees, leaves: "")

    def no_capture(self, *a):
        raise RuntimeError("no card")

    monkeypatch.setattr(programs.Program, "_capture", no_capture)
    show0 = warnings.showwarning
    count_lock = threading.Lock()
    inside, peak, modes = [0], [0], []

    def fn(x):
        with count_lock:
            inside[0] += 1
            peak[0] = max(peak[0], inside[0])
            modes.append(mode["v"])
        time.sleep(0.05)
        with count_lock:
            inside[0] -= 1
        return x + 1

    prog = programs.Program("two-threads", lambda: None)
    barrier = threading.Barrier(2)
    outs, errs = {}, []

    def build(i):
        try:
            barrier.wait()
            outs[i] = prog._build(("sig", i), fn, (torch.full((2,), i),),
                                  ("T",), [_FakeCard()], ["copy"], [],
                                  set())
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=build, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert peak[0] == 1
    assert modes == ["warn", "warn"]
    assert mode["v"] == 0 and warnings.showwarning is show0
    for i in (1, 2):
        np.testing.assert_array_equal(outs[i].numpy(), [i + 1, i + 1])
    assert [f["reason"] for f in programs.fallback_log()
            if f["key"] == "two-threads"] == [
                "capture failed: RuntimeError: no card"]


def test_outputs_are_copies(tmp_path):
    """A later request never rewrites an earlier result."""
    c = _matrix_client(tmp_path, np.ones((8, 8), np.float32))
    first = _run(c, _scale_sink(2.0))
    c.send_matrix("d", "m", 3 * np.ones((8, 8), np.float32), (4, 4))
    second = _run(c, _scale_sink(2.0))
    np.testing.assert_array_equal(first.to_dense(), 2 * np.ones((8, 8)))
    np.testing.assert_array_equal(second.to_dense(), 6 * np.ones((8, 8)))


# --- EXPLAIN -----------------------------------------------------------------

def _explain(c, sink, job):
    _, tree = c.execute_computations(sink, job_name=job, explain=True)
    return tree


def _shape(tree):
    return [(n["id"], n["kind"], n["label"], n["inputs"], n.get("region"),
             bool(n.get("fused"))) for n in tree["nodes"]]


def test_explain_regions_cold_warm_and_the_reference(tmp_path):
    from netsdb_tpu import obs as jobs

    trees = {}
    for ref in (True, False):
        c = _fusion_client(tmp_path / str(ref), ref)
        _ingest_lineitem(c, 900, ref)
        if ref:
            with jobs.operators.explain_capture() as holder:
                c.execute_computations(_mixed(ref), job_name="fz-explain")
            trees[ref] = [holder["operators"]]
            with jobs.operators.explain_capture() as holder:
                c.execute_computations(_mixed(ref), job_name="fz-explain")
            trees[ref].append(holder["operators"])
        else:
            trees[ref] = [_explain(c, _mixed(ref), "fz-explain")
                          for _ in range(2)]
    cold, warm = trees[False]
    assert _shape(cold) == _shape(warm) == _shape(trees[True][0])
    regions = {n.get("region") for n in cold["nodes"]} - {None}
    assert len(regions) == 1
    assert "region=r" in obs.operators.render_tree(cold)


def test_plan_fusion_off_explain_has_no_regions(tmp_path):
    c = _fusion_client(tmp_path, False)
    _ingest_lineitem(c, 900, False)
    c.store.config.plan_fusion = False
    tree = _explain(c, _mixed(False), "fz-off")
    assert all(n.get("region") is None for n in tree["nodes"])
    assert tree["mode"] in ("streamed", "mixed")


def test_explain_of_a_whole_plan_is_marked_fused(tmp_path):
    c = _matrix_client(tmp_path, np.ones((8, 8), np.float32))
    res, tree = c.execute_computations(_scale_sink(2.0), job_name="ex-whole",
                                       explain=True)
    assert set(res) == {SetIdentifier("d", "out")}
    assert tree["mode"] == "whole_plan_jit"
    assert all(n.get("fused") for n in tree["nodes"][:-1])
    assert tree["nodes"][-1]["kind"] == "WholePlanJit"


# --- programs on the CPU -----------------------------------------------------

@dataclasses.dataclass
class _Params:
    a: BlockedTensor
    n: int


@pytest.mark.parametrize("value", [
    torch.ones(3),
    (torch.ones(2), [torch.zeros(1), 3, None], {"k": 1.5}),
    _Params(BlockedTensor.from_dense(torch.ones(5, 3), (2, 2),
                                     device="cpu"), 7),
    ColumnTable({"c": torch.arange(4)}, {"c": ["a", "b", "c", "d"]},
                torch.tensor([True, False, True, True]))])
def test_flatten_round_trips(value):
    leaves = []
    tree = programs._flatten(value, leaves)
    hash(tree)
    back = programs._unflatten(tree, iter(leaves))
    assert type(back) is type(value)
    assert [id(t) for t in programs.tensor_leaves(back)] == \
        [id(t) for t in leaves]


def test_closure_tokens_follow_values_not_identities():
    def make(c):
        return lambda t: t * c

    keep = []
    assert programs.closure_token([make(2.0)], keep) == \
        programs.closure_token([make(2.0)], keep)
    assert programs.closure_token([make(2.0)], keep) != \
        programs.closure_token([make(3.0)], keep)
    t1, t2 = torch.ones(2), torch.ones(2)
    assert programs.closure_token([make(t1)], keep) != \
        programs.closure_token([make(t2)], keep)
    assert t1 in keep  # held, so its identity is not reused


def test_tuning_thresholds_are_part_of_the_signature():
    from netsdb_tpu_torch.relational import tuning

    keep = []
    tok = programs.closure_token([], keep)
    tuning.set_override("join_lut_factor", 7.0, "cpu")
    try:
        assert programs.closure_token([], keep) != tok
    finally:
        tuning.clear_overrides()


def test_variants_are_bounded():
    prog = pex._cached_program("variants-test")
    for n in range(programs.VARIANTS_PER_PROGRAM + 5):
        prog(lambda t: t + 1, torch.ones(n + 1))
    assert prog.variants() == programs.VARIANTS_PER_PROGRAM


def test_no_capture_on_the_cpu():
    before = programs.program_stats()
    pex.run_program("cpu-test", lambda t: t * 2, torch.ones(3))
    pex.run_program("cpu-test", lambda t: t * 2, torch.ones(3))
    after = programs.program_stats()
    assert after["captures"] == before["captures"]
    assert after["replays"] == before["replays"]


def test_deferred_checks_run_after_the_program():
    table = torch.arange(12.0).reshape(6, 2)
    with pytest.raises(IndexError, match=r"\[0, 6\)"):
        embedding_lookup(table, torch.tensor([0, 9]))
    with ops_common.deferring() as checks:
        out = embedding_lookup(table, torch.tensor([0, 9]))
    assert len(checks) == 1 and out.shape == (2, 2)  # clamped, in bounds
    with pytest.raises(IndexError):
        checks[0]()
    assert not ops_common.defer_check(lambda: None)


def test_singular_inverse_raises_through_its_deferred_check():
    from netsdb_tpu_torch.ops.linalg import inverse

    sing = BlockedTensor.from_dense(torch.zeros(3, 3), (3, 3), device="cpu")
    with pytest.raises(torch.linalg.LinAlgError, match="singular"):
        inverse(sing)
    with ops_common.deferring() as checks:
        inverse(sing)
    with pytest.raises(torch.linalg.LinAlgError):
        checks[0]()


def test_graph_pools_stay_under_their_budget(monkeypatch):
    """Past ``GRAPH_POOL_BUDGET_BYTES`` the least recently replayed graphs
    are dropped (their programs capture again when next called). There is
    no graph on the CPU, so the accounting is driven directly."""
    monkeypatch.setattr(programs, "GRAPH_POOL_BUDGET_BYTES", 250)
    progs = [pex._cached_program(f"pool-test::{i}") for i in range(3)]
    for i, prog in enumerate(progs):
        prog._variants[("sig", i)] = object()
        programs._pool_add(prog, ("sig", i), 100)
    assert programs.graph_pool_bytes() == 200
    assert ("sig", 0) not in progs[0]._variants  # the oldest was dropped
    programs._pool_touch(progs[1], ("sig", 1))  # now the newest
    progs[0]._variants[("sig", 3)] = object()
    programs._pool_add(progs[0], ("sig", 3), 100)
    assert ("sig", 2) not in progs[2]._variants
    assert ("sig", 1) in progs[1]._variants
    progs[1].drop(("sig", 1))
    assert programs.graph_pool_bytes() == 100


def test_a_replay_hands_each_caller_its_own_outputs():
    """A graph's replay clones its outputs under the graph's lock, so a
    later replay never rewrites an earlier caller's result: two handler
    threads folding through one stream program each keep their own
    carried state."""
    import threading

    static, buf = torch.zeros(4), torch.zeros(4)

    class _AddOne:  # stands for the captured graph: out = state + 1
        def replay(self):
            buf.copy_(static + 1)

    outs: list = []
    tree = programs._flatten(buf, outs)
    graph = programs._Graph(_AddOne(), ["copy"], [static], tree, outs, [],
                            {}, [], 0)
    first = graph.replay([torch.ones(4)])
    second = graph.replay([torch.full((4,), 5.0)])
    assert torch.equal(first, torch.full((4,), 2.0))
    assert torch.equal(second, torch.full((4,), 6.0))
    assert first.data_ptr() != buf.data_ptr()

    finals, steps = {}, 300

    def fold(seed):
        state = torch.full((4,), 1000.0 * seed)
        for _ in range(steps):
            state = graph.replay([state])
        finals[seed] = state

    threads = [threading.Thread(target=fold, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    for seed in range(4):
        assert torch.equal(finals[seed],
                           torch.full((4,), 1000.0 * seed + steps))


SHIPPED_OFFSET = 1.0  # a module global a shipped function names


def test_a_function_shipped_by_value_keys_like_its_earlier_copies():
    """A daemon unpickles a shipped DAG's functions anew with every
    request: equal code, closure and named globals give one token (the
    request finds its earlier variants), another closure value or global
    another token."""
    from netsdb_tpu_torch.serve import _fnpickle

    def step_for(scale):
        def step(t):
            return t * scale + SHIPPED_OFFSET
        return step

    a, b = (_fnpickle.loads(_fnpickle.dumps(step_for(3.0)))
            for _ in range(2))
    assert a.__code__ is not b.__code__
    assert programs.closure_token([a], []) == programs.closure_token([b], [])
    other = _fnpickle.loads(_fnpickle.dumps(step_for(4.0)))
    assert programs.closure_token([other], []) != \
        programs.closure_token([a], [])
    b.__globals__["SHIPPED_OFFSET"] = 2.0
    assert programs.closure_token([b], []) != programs.closure_token([a], [])
