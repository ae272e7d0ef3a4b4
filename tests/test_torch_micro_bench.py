"""``netsdb_tpu_torch/workloads/micro_bench.py`` against the reference's
``netsdb_tpu/workloads/micro_bench.py`` on the CPU, at the reference
tests' tiny sizes (``tests/test_micro_bench.py``, ``test_obs.py``,
``test_staging.py``, ``test_devcache.py``): both run at the same sizes
and seeds, the payloads have the same keys, and every field that does
not depend on the clock is equal — op counts, chunks, fold sizes, trace
counts, pad waste, staged bytes, reshard steps. The segment-sum and
shuffle results are held to the reference's outputs on the same inputs.

Where the reference counts jit traces the port counts new signatures of
one ``plan.programs.Program`` (a CUDA graph captured per signature on the
card, a first build on the CPU): the same event — one build per distinct
input shape — so the counts are held equal. The shuffle and SUMMA benches
run over 8 (4) virtual CPU positions, the reference over conftest's 8 CPU
devices (4 of them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from netsdb_tpu.workloads import micro_bench as ref_mb
from netsdb_tpu_torch.parallel.mesh import virtual_devices
from netsdb_tpu_torch.workloads import micro_bench as mb


def test_arena_alloc_runs_on_the_native_arena():
    info = {}
    ops, secs, rate = mb.bench_arena_alloc(n=500, size=1024, pool_mb=8,
                                           info=info)
    ref_ops, _, _ = ref_mb.bench_arena_alloc(n=500, size=1024, pool_mb=8)
    assert ops == ref_ops == 500 and secs > 0 and rate > 0
    assert info == {"backend": "native"} and mb.arena_backend() == "native"


@pytest.mark.parametrize("name", ["int_groupby", "string_groupby"])
def test_groupbys(name):
    ops, secs, rate = getattr(mb, f"bench_{name}")(n=5000, keys=100)
    ref_ops, _, _ = getattr(ref_mb, f"bench_{name}")(n=5000, keys=100)
    assert ops == ref_ops == 5000 and secs > 0 and rate > 0


def test_segment_sum_equals_the_reference():
    n, keys = 10_000, 64
    ops, _, rate = mb.bench_segment_sum(n=n, keys=keys, device="cpu")
    ref_ops, _, _ = ref_mb.bench_segment_sum(n=n, keys=keys)
    assert ops == ref_ops == n and rate > 0
    seg, val = mb.segment_sum_inputs(n, keys, "cpu")
    got = mb.segment_sum(seg, val, keys).numpy()
    # the reference bench's own inputs and call
    rng = np.random.default_rng(2)
    rseg = jnp.asarray(rng.integers(0, keys, n))
    rval = jnp.asarray(rng.standard_normal(n), jnp.float32)
    want = np.asarray(jax.ops.segment_sum(rval, rseg, num_segments=keys))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(rseg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_shuffle_on_mesh_equals_the_reference():
    from netsdb_tpu.parallel.collectives import all_to_all_resharding
    from netsdb_tpu.parallel.mesh import make_mesh

    elems = 1 << 10
    with virtual_devices(8, "cpu"):
        ops, _, rate = mb.bench_shuffle(elems_per_dev=elems, device="cpu")
        mesh = mb.shuffle_mesh("cpu")
        x = mb.shuffle_inputs(mesh, elems)
        got = mb.shuffle(x, mesh)
        dense = got.to_dense().numpy()
        assert got.spec == (None, "data")
    ref_ops, _, _ = ref_mb.bench_shuffle(elems_per_dev=elems)
    assert ops == ref_ops == 8 * elems and rate > 0
    rmesh = make_mesh((8,), ("data",))
    rx = jnp.arange(8 * elems, dtype=jnp.float32).reshape(8, elems)
    want = np.asarray(jax.jit(lambda v: all_to_all_resharding(
        v, rmesh, "data", from_dim=0, to_dim=1))(rx))
    np.testing.assert_array_equal(dense, want)  # integer-valued: exact


def test_run_all_smoke():
    lines, ref_lines = [], []
    res = mb.run_all(names=["int_groupby", "arena_alloc"], out=lines.append,
                     device="cpu")
    ref = ref_mb.run_all(names=["int_groupby", "arena_alloc"],
                         out=ref_lines.append)
    assert set(res) == set(ref) and set(mb.BENCHMARKS) == set(
        ref_mb.BENCHMARKS)
    assert [r[0] for r in res.values()] == [r[0] for r in ref.values()]
    assert len(lines) == 2 and all("ops/s" in ln for ln in lines)
    assert lines[1].endswith("(native arena)")


def test_planner_bench_runs():
    ops, secs, rate = mb.bench_planner(n=50)
    assert ops == ref_mb.bench_planner(n=50)[0] == 50 and rate > 0


def test_lint_overhead_bench_matches_the_reference():
    kw = dict(rows=20_000, page_rows=4096, repeats=3)
    out = mb.bench_lint_overhead(device="cpu", **kw)
    ref = ref_mb.bench_lint_overhead(**kw)
    assert set(out) == set(ref)
    for k in ("rows", "page_rows", "repeats", "chunks",
              "acquisitions_per_run", "rank_edges"):
        assert out[k] == ref[k], k
    assert out["enabled_us_per_acquire"] > 0
    # the witness budget the reference's acceptance pins: the
    # deterministic bound far inside 2%, the off path ~0
    assert out["accounting_overhead_pct"] < 2.0
    assert out["off_path_overhead_pct"] < 0.1
    assert out["witness_off_s"] > 0 and out["witness_on_s"] > 0


def test_obs_overhead_bench_matches_the_reference():
    kw = dict(rows=30_000, page_rows=4096, repeats=2)
    out = mb.bench_obs_overhead(device="cpu", **kw)
    ref = ref_mb.bench_obs_overhead(**kw)
    assert set(out) == set(ref) and set(out["sampled"]) == set(
        ref["sampled"])
    assert out["chunks"] == ref["chunks"] >= 2
    assert out["untraced_s"] > 0
    tc, rtc = out["trace_counters"], ref["trace_counters"]
    assert tc["stage.chunks"] == rtc["stage.chunks"] == out["chunks"]
    assert tc["stage.bytes"] == rtc["stage.bytes"] > 0
    assert out["sampled"]["sample"] == ref["sampled"]["sample"]
    assert out["accounting_overhead_pct"] < 3.0


def test_explain_overhead_bench_matches_the_reference():
    kw = dict(rows=30_000, page_rows=4096, repeats=2)
    out = mb.bench_explain_overhead(device="cpu", **kw)
    ref = ref_mb.bench_explain_overhead(**kw)
    assert set(out) == set(ref)
    assert out["chunks"] == ref["chunks"] >= 2
    assert out["accounting_overhead_pct"] < 1.0
    assert out["off_path_overhead_pct"] < 0.1


def test_staging_bench_matches_the_reference():
    kw = dict(rows=2048, cols=64, rhs_cols=16, page_rows=256, pool_mb=4,
              fold_rows=20_000, repeats=1)
    out = mb.bench_staging(device="cpu", **kw)
    ref = ref_mb.bench_staging(**kw)
    assert set(out) == set(ref)
    for k in ("rows", "cols", "rhs_cols", "fold_rows", "matrix_mb",
              "pool_mb", "fold_sizes", "fold_sync_traces",
              "fold_staged_traces", "native"):
        assert out[k] == ref[k], k
    # buckets absorb the per-size shape churn the baseline pays
    assert out["fold_staged_traces"] == 1 < out["fold_sync_traces"]
    # the arena's counters are the reference's; the port's store adds
    # page_reads and page_read_s
    assert set(ref["store_stats"]) <= set(out["store_stats"])
    for k in ("bytes_allocated", "bytes_in_use", "spills", "evictions"):
        assert out["store_stats"][k] == ref["store_stats"][k], k


def test_bucket_sweep_equals_the_reference():
    kw = dict(base=400, spread=0.5, samples=10)
    out = mb.bench_bucket_sweep(device="cpu", **kw)
    assert out == ref_mb.bench_bucket_sweep(**kw)  # no clock in it
    for d in (2, 4):
        r = out[f"density{d}"]
        assert r["traces"] == r["buckets"]  # one build per bucket
    assert (out["density4"]["pad_waste_pct"]
            <= out["density2"]["pad_waste_pct"])
    assert out["density4"]["buckets"] >= out["density2"]["buckets"]


def test_fusion_bench_matches_the_reference():
    from netsdb_tpu.plan.executor import clear_compiled_cache
    from netsdb_tpu_torch.plan import executor

    # the cold builds are counted: both program caches are process-wide
    executor.clear_compiled_cache()
    kw = dict(spine=4, dim_rows=4096, fact_rows=2000, fold_rows=50_000,
              repeats=3, inner=1)
    out = mb.bench_fusion(device="cpu", **kw)
    clear_compiled_cache()
    ref = ref_mb.bench_fusion(**kw)
    assert set(out) == set(ref)
    for part in ("spine", "fold_stream"):
        assert set(out[part]) == set(ref[part])
        for k in ("fused_traces", "fused_programs", "per_node_traces",
                  "per_node_programs"):
            assert out[part][k] == ref[part][k], (part, k)
    # fused: one region program where per node builds each node's
    assert out["spine"]["fused_traces"] < out["spine"]["per_node_traces"]


def test_summa_bench_matches_the_reference():
    kw = dict(rows=4096, k=64, cols=32, row_block=512, table_rows=20_000,
              repeats=2)
    with virtual_devices(4, "cpu"):
        out = mb.bench_summa(device="cpu", **kw)
    ref = ref_mb.bench_summa(**kw)
    assert set(out) == set(ref)
    for k in ("participants", "rows", "k", "cols", "byte_equal",
              "replicated_per_host_staged_bytes",
              "summa_per_host_staged_bytes", "per_host_staged_frac",
              "summa_staging_reduction_x", "table_rows",
              "reshard_blocks_moved", "reshard_steps",
              "reshard_zero_arena_reads"):
        assert out[k] == ref[k], k
    assert out["byte_equal"] and out["reshard_zero_arena_reads"]


def test_summa_bench_needs_two_positions():
    out = mb.bench_summa(rows=64, k=8, cols=8, row_block=16, device="cpu")
    assert out["participants"] == 1 and "virtual_devices" in out["error"]
