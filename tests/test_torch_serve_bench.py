"""The serving benches of ``netsdb_tpu_torch/workloads/serve_bench.py``
whose daemons run in this process, against the reference's
``netsdb_tpu/workloads/serve_bench.py`` on the CPU (the reference's
``test_devcache.py`` and ``test_devcache_partial.py`` bench smokes, and
every other in-process bench): both run at the same tiny sizes and
seeds, the payloads have the same keys at every level, and every field
that does not depend on the clock is equal — rows, bytes, executions,
installs, coalesce hits, cache counters, slots, EXPLAIN layers, exact
totals and byte-equality flags. The benches that spawn daemon processes
are in ``test_torch_serve_bench_procs.py``.

Where a count means something else in the port it is named: the decode
``traces`` are CUDA-graph captures on the card and first builds on the
CPU (the reference's jit traces), so the sessions gate holds the delta
after warm-up at 0 on both; the per-batch coalescing counts (``batches``,
``steps``, ``pad_rows``) depend on thread timing and are not compared."""

import numpy as np
import pytest

from netsdb_tpu.workloads import serve_bench as ref_sb
from netsdb_tpu_torch.workloads import serve_bench as sb


def same_keys(a, b, path="out"):
    """Equal key sets at every level of two payloads (below the maps
    keyed by daemon address, whose ports differ run to run)."""
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if k == "member_slots":
            continue
        if isinstance(a[k], dict) and isinstance(b[k], dict):
            same_keys(a[k], b[k], f"{path}.{k}")


def test_stream_bench_matches_the_reference():
    kw = dict(rows=2000, row_bytes=100, tensor_mb=1)
    out = sb.run_stream_bench(device="cpu", **kw)
    ref = ref_sb.run_stream_bench(**kw)
    same_keys(out, ref)
    for part, keys in (("scan", ("payload_mb", "single_peak_frame_mb",
                                 "streamed_peak_frame_mb")),
                       ("tensor", ("payload_mb", "chunked_peak_frame_mb"))):
        for k in keys:
            assert out[part][k] == ref[part][k], (part, k)


def test_device_cache_bench_matches_the_reference():
    kw = dict(rows=20_000, page_rows=2048, pool_mb=1, repeats=1,
              cache_mb=64)
    out = sb.run_device_cache_bench(device="cpu", **kw)
    ref = ref_sb.run_device_cache_bench(**kw)
    same_keys(out, ref)
    for k in ("rows", "pool_mb", "cache_mb", "table_mb",
              "warm_misses_flat", "cache_stats"):
        assert out[k] == ref[k], k
    assert out["warm_misses_flat"] is True
    assert out["cache_stats"]["hits"] > 0


def test_partial_cache_bench_matches_the_reference():
    kw = dict(rows=20_000, page_rows=2048, pool_mb=1, cache_mb=64,
              append_frac=0.05, cycles=1)
    out = sb.run_partial_cache_bench(device="cpu", **kw)
    ref = ref_sb.run_partial_cache_bench(**kw)
    same_keys(out, ref)
    for k in ("append_rows", "partial_zero_evictions",
              "partial_hits_positive"):
        assert out[k] == ref[k], k
    for arm in ("whole_run", "partial"):
        for k in ("blocks_before_appends", "cache_stats"):
            assert out[arm][k] == ref[arm][k], (arm, k)
    assert out["partial"]["pre_append_evictions"] == 0
    assert out["partial"]["partial_hits"] == ref["partial"]["partial_hits"]
    # the structural proof holds at any scale (the speedup is only
    # meaningful at bench scale — not asserted)
    assert out["partial_zero_evictions"] is True
    assert out["partial_hits_positive"] is True
    assert out["partial"]["blocks_before_appends"] > 1


def test_scheduler_bench_matches_the_reference():
    kw = dict(clients=3, rows=20_000, page_rows=2048, pool_mb=1,
              cache_mb=64)
    out = sb.run_scheduler_bench(device="cpu", **kw)
    ref = ref_sb.run_scheduler_bench(**kw)
    same_keys(out, ref)
    for arm in ("scheduler_off", "scheduler_on"):
        for k in ("clients", "executions_run", "devcache_installs",
                  "coalesce_hits"):
            assert out[arm][k] == ref[arm][k], (arm, k)
    on = out["scheduler_on"]
    assert (on["executions_run"], on["devcache_installs"],
            on["coalesce_hits"]) == (1, 1, 2)


def test_serving_bench_matches_the_reference():
    kw = dict(daemons=3, batch=64, features=16, hidden=32, labels=8,
              frames=2, block=(16, 16))
    out = sb.run_serving_bench(device="cpu", **kw)
    ref = ref_sb.run_serving_bench(**kw)
    same_keys(out, ref)
    for k in ("daemons", "batch", "frames", "shape", "slots", "byte_equal",
              "one_program_per_shard", "explain_shard", "rows_bound_ok",
              "per_shard_max_row_frac", "gates_ok"):
        assert out[k] == ref[k], k
    assert out["gates_ok"] is True


def test_failover_bench_matches_the_reference():
    kw = dict(batches=6, rows_each=100, kill_after=3)
    out = sb.run_failover_bench(device="cpu", **kw)
    ref = ref_sb.run_failover_bench(**kw)
    same_keys(out, ref)
    for k in ("batches", "rows_each", "election_s", "promoted",
              "exact_totals"):
        assert out[k] == ref[k], k
    assert out["promoted"] is True and out["exact_totals"] is True


def test_fusion_distributed_bench_matches_the_reference():
    from netsdb_tpu.plan.executor import clear_compiled_cache as ref_clear
    from netsdb_tpu_torch.plan.executor import clear_compiled_cache

    # the cold round counts the program keys it mints: both caches are
    # process-wide, so an earlier run of these job names must not be in
    # them
    clear_compiled_cache()
    ref_clear()
    kw = dict(rows=20_000, daemons=3, queries=2)
    out = sb.run_fusion_distributed_bench(device="cpu", **kw)
    ref = ref_sb.run_fusion_distributed_bench(**kw)
    same_keys(out, ref)
    counts = ("q01_fold_keys", "q01_merge_keys", "q01_other_keys",
              "q01_subplans", "fan_scatter_queries", "fan_subplans",
              "q01_scatter_queries")
    for arm in ("optimal", "greedy", "off"):
        for k in counts:
            assert out[arm][k] == ref[arm][k], (arm, k)
    for k in ("byte_equal", "one_program_per_shard_plus_merge",
              "fan_one_subplan_per_shard", "rollback_no_region_keys",
              "gates_ok"):
        assert out[k] == ref[k] is True, k


@pytest.mark.parametrize("kind", ["lstm", "transformer_layer"])
def test_sessions_bench_matches_the_reference(kind):
    kw = dict(sessions=3, steps=4, hidden=16, workers=2, kind=kind)
    out = sb.run_sessions_bench(device="cpu", **kw)
    ref = ref_sb.run_sessions_bench(**kw)
    same_keys(out, ref)
    for k in ("errors", "traces_delta", "arena_reads_delta", "byte_equal",
              "one_program", "zero_warm_arena_reads"):
        assert out[k] == ref[k], k
    assert out["errors"] == [] and out["byte_equal"] is True
    assert out["traces_delta"] == 0 and out["arena_reads_delta"] == 0


def test_benches_need_a_card_or_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for fn in (sb.run_stream_bench, sb.run_device_cache_bench,
               sb.run_sessions_bench):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sb.main(["--failover"])


def test_scale_rows_probe_is_canonical():
    from netsdb_tpu_torch.relational.table import ColumnTable

    class _C:
        def get_table(self, db, name):
            import torch

            return ColumnTable({"b": torch.tensor([3, 1, 2]),
                                "a": torch.tensor([9, 8, 7])}, {},
                               torch.tensor([True, False, True]))

    assert sb._scale_rows(_C(), "d", "t") == [(7, 2), (9, 3)]
    assert np.array_equal(sb._host([1, 2]), np.array([1, 2]))


_MAIN_TINY = {
    "stream": ("run_stream_bench", dict(rows=2000, row_bytes=100,
                                        tensor_mb=1), "tensor"),
    "serving": ("run_serving_bench", dict(batch=64, features=16, hidden=32,
                                          labels=8, frames=2,
                                          block=(16, 16)), "gates_ok"),
    "failover": ("run_failover_bench", dict(batches=6, rows_each=100,
                                            kill_after=3), "exact_totals"),
    "sessions": ("run_sessions_bench", dict(sessions=3, steps=4, hidden=16),
                 "byte_equal"),
}


@pytest.mark.parametrize("mode", sorted(_MAIN_TINY))
def test_module_main_modes_print_json(mode, monkeypatch, capsys):
    """``python -m netsdb_tpu_torch.workloads.serve_bench --<mode>`` with
    the reference's ``--platform cpu`` (the modes the CLI does not
    name)."""
    import functools
    import json

    fn, kw, key = _MAIN_TINY[mode]
    monkeypatch.setattr(sb, fn, functools.partial(getattr(sb, fn), **kw))
    argv = [f"--{mode}", "--platform", "cpu"]
    if mode == "serving":
        argv += ["--daemons", "3"]
    assert sb.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out[key] is not False and out[key] is not None
