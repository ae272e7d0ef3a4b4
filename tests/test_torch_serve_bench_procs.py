"""The serving benches of ``netsdb_tpu_torch/workloads/serve_bench.py``
whose daemons are processes (``python -m netsdb_tpu_torch --device cpu
serve --port 0``, address read from its ``serving on`` line), against
the reference's benches on the CPU (``test_serve.py``'s two-process
integration, the scale-out, data-plane and rebalance benches): the same
tiny sizes and seeds, the same keys at every level, and every field that
does not depend on the clock equal — jobs done, store counters, payload
sizes, byte-equality, zero failed requests, exact totals, moved slots and
placement epochs. The reference's daemons run as its own processes on the
CPU. Both benches of a test run at once (two threads of this process that
mostly wait on their daemon processes), which halves the file's time."""

from concurrent.futures import ThreadPoolExecutor

from netsdb_tpu.workloads import serve_bench as ref_sb
from netsdb_tpu_torch.workloads import serve_bench as sb
from tests.test_torch_serve_bench import same_keys


def both(name, port_kw, **kw):
    """``(port payload, reference payload)`` of bench ``name``, run
    side by side."""
    with ThreadPoolExecutor(2) as ex:
        mine = ex.submit(getattr(sb, name), **port_kw, **kw)
        ref = ex.submit(getattr(ref_sb, name), **kw)
        return mine.result(), ref.result()


def test_two_process_serve_bench_matches_the_reference():
    """A real daemon process and two real client processes running
    inference against weights loaded once."""
    kw = dict(clients=2, jobs_per_client=2, batch=128)
    out, ref = both("run_serve_bench", {}, platform="cpu", **kw)
    same_keys(out, ref)
    assert out["server_jobs_done"] == ref["server_jobs_done"] >= 4
    assert out["cache_stats"] == ref["cache_stats"]
    assert out["aggregate_rows_per_sec"] > 0
    assert len(out["per_client"]) == 2
    for r, w in zip(out["per_client"], ref["per_client"]):
        assert set(r) == set(w)
        assert (r["jobs"], r["batch"]) == (w["jobs"], w["batch"]) == (2, 128)


def test_data_plane_bench_matches_the_reference():
    kw = dict(table_mb=1, chunk_mb=1, window=2, hedge_reads=6)
    out, ref = both("run_data_plane_bench", {"device": "cpu"}, **kw)
    same_keys(out, ref)
    for k in ("table_mb", "chunk_mb", "window"):
        assert out[k] == ref[k], k
    assert out["ingest"]["payload_mb"] == ref["ingest"]["payload_mb"]
    assert out["tensor"]["payload_mb"] == ref["tensor"]["payload_mb"]
    for k in ("injected_stall_ms", "stall_rate"):
        assert out["hedged_reads"][k] == ref["hedged_reads"][k]


def test_scaleout_bench_matches_the_reference():
    kw = dict(rows=20_000, daemons=2, queries=1, page_rows=2048,
              join_orders=64, join_rows=2000)
    out, ref = both("run_scaleout_bench", {"device": "cpu"}, **kw)
    same_keys(out, ref)
    for k in ("rows", "payload_mb", "daemons", "queries", "q01_byte_equal",
              "join_byte_equal"):
        assert out[k] == ref[k], k
    assert out["q01_byte_equal"] is True and out["join_byte_equal"] is True


def test_rebalance_bench_matches_the_reference():
    kw = dict(rows=4000, daemons=2, clients=2, measure_s=0.5, settle_s=0.3)
    out, ref = both("run_rebalance_bench", {"device": "cpu"}, **kw)
    same_keys(out, ref)
    for k in ("moved_slots", "zero_failed_requests", "totals_exact",
              "byte_equal"):
        assert out[k] == ref[k], k
    for arm in ("frozen", "on"):
        for k in ("failed_requests", "totals", "totals_exact",
                  "placement_epoch"):
            assert out[arm][k] == ref[arm][k], (arm, k)
        assert sorted(out[arm]["member_slots"].values()) == sorted(
            ref[arm]["member_slots"].values())
        assert [{k: m[k] for k in ("db", "set", "slot", "ok")}
                for m in out[arm]["moves"]] == [
            {k: m[k] for k in ("db", "set", "slot", "ok")}
            for m in ref[arm]["moves"]]
    assert out["zero_failed_requests"] is True and out["totals_exact"]
