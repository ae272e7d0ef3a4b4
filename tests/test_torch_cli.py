"""``python -m netsdb_tpu_torch`` against the reference's CLI
(``netsdb_tpu/cli.py``) on the CPU: ``info``, ``demo-ff``, ``tpch`` and
``pdml`` print what the reference prints where both print the same
fields; ``obs`` renders an in-process daemon's readouts with the
reference's renderers' exact text; ``selftest`` passes all 20 steps;
``micro-bench`` and ``serve-bench`` run each mode on the CPU at tiny
sizes and print their JSON; ``lint`` lists the reference's rule ids and
reports in JSON without a device; the commands of later ROADMAP.md items
exit non-zero naming them; and without a card a command fails unless
``--device cpu`` is given.

The reference's commands are called through their ``_cmd_*`` functions
(not ``main``, which points jax's compile cache at the default root)
with ``NETSDB_TPU_HOME`` and the port's temporary directory under
``tmp_path``."""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from netsdb_tpu import cli as ref_cli
from netsdb_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_CARD = not torch.cuda.is_available()


@pytest.fixture(autouse=True)
def _roots(tmp_path, monkeypatch):
    monkeypatch.setenv("NETSDB_TPU_HOME", str(tmp_path / "ref_home"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _port(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", "cpu", *argv])
    return rc, buf.getvalue()


def _ref(cmd, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = getattr(ref_cli, cmd)(argparse.Namespace(**kw))
    return rc, buf.getvalue()


def test_info_prints_the_reference_fields():
    rc, text = _port("info")
    got = json.loads(text)
    _, ref_text = _ref("_cmd_info")
    want = json.loads(ref_text)
    assert rc == 0 and set(got) == set(want)
    assert (got["process_index"], got["process_count"]) == (0, 1)
    assert got["device_kind"] == got["backend"] == "cpu"
    assert want["backend"] == "cpu"


def test_demo_ff_equals_the_reference():
    kw = dict(batch=64, features=40, hidden=48, labels=10, block=16)
    rc, text = _port("demo-ff", *[f"--{k}={v}" for k, v in kw.items()])
    got = json.loads(text)
    _, ref_text = _ref("_cmd_demo_ff", **kw)
    want = json.loads(ref_text)
    assert rc == 0
    for d in (got, want):
        assert d.pop("elapsed_s") >= 0
    assert got == want and got["cols_sum_to_one"] is True


@pytest.mark.parametrize("query", ["q01", "q06", "q13"])
def test_tpch_prints_the_reference_row_counts(query):
    rc, text = _port("tpch", "--query", query, "--print-values")
    _, ref_text = _ref("_cmd_tpch", query=query, scale=1,
                       print_values=False)
    assert rc == 0
    head = text.splitlines()[0]
    assert head.split(" in ")[0] == ref_text.splitlines()[0].split(" in ")[0]
    assert head.startswith(f"{query}: ")


def test_pdml_prints_the_reference_shapes(tmp_path):
    prog = tmp_path / "p.pdml"
    prog.write_text("A = ones(4,4,2,2)\nB = identity(4,2)\n"
                    "C = (A + B) %*% B\nD = rowSum(C)\n")
    rc, text = _port("pdml", str(prog))
    _, ref_text = _ref("_cmd_pdml", file=str(prog), print_values=False)
    assert rc == 0 and text == ref_text
    assert "D: shape=(8, 1)" in text


def test_selftest_passes_all_twenty_steps():
    rc, text = _port("selftest")
    lines = text.splitlines()
    assert rc == 0, text
    assert lines[-1] == "20/20 passed"
    assert sum(ln.startswith("[ok]") for ln in lines) == 20
    assert any(ln.startswith("[ok]   placement-arm") for ln in lines)


@pytest.mark.parametrize("cmd,item", [("bench", "A9")])
def test_later_commands_exit_nonzero_naming_their_item(cmd, item, capsys):
    assert cli.main(["--device", "cpu", cmd]) != 0
    assert f"ROADMAP.md {item}" in capsys.readouterr().err


def test_lint_list_rules_prints_the_reference_ids(capsys):
    # no --device: lint touches no device, with or without a card
    assert cli.main(["lint", "--list-rules"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert ref_cli._cmd_lint(argparse.Namespace(list_rules=True)) == 0
    ref = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in port] == [ln.split()[0] for ln in ref]
    assert len(port) == 18


def test_lint_json_reports_a_fixture_cycle_and_exits_one(capsys):
    fixture = os.path.join(REPO, "tests", "fixtures", "analysis",
                           "bad_lock_cycle.py")
    rc = cli.main(["lint", "--json", "--rule", "lock-order", fixture])
    diags = json.loads(capsys.readouterr().out)
    assert rc == 1 and [d["rule"] for d in diags] == ["lock-order"]
    assert set(diags[0]) == {"rule", "path", "line", "col", "message"}
    assert diags[0]["path"] == "tests/fixtures/analysis/bad_lock_cycle.py"
    assert cli.main(["lint", "--json", "--rule", "no-such-rule"]) == 2


# the benches' tiny sizes for the command-line tests (the benches at these
# sizes are held to the reference in tests/test_torch_micro_bench.py and
# tests/test_torch_serve_bench*.py; here the command's wiring is)
_MICRO_TINY = {
    "staging": ("bench_staging", dict(rows=2048, cols=64, rhs_cols=16,
                                      page_rows=256, pool_mb=4,
                                      fold_rows=20_000, repeats=1),
                "fold_staged_traces"),
    "bucket-sweep": ("bench_bucket_sweep", dict(base=400, spread=0.5,
                                                samples=10), "density4"),
    "obs-overhead": ("bench_obs_overhead", dict(rows=30_000, page_rows=4096,
                                                repeats=2),
                     "accounting_overhead_pct"),
    "explain-overhead": ("bench_explain_overhead",
                         dict(rows=30_000, page_rows=4096, repeats=2),
                         "off_path_overhead_pct"),
    "lint-overhead": ("bench_lint_overhead", dict(rows=20_000,
                                                  page_rows=4096, repeats=3),
                      "acquisitions_per_run"),
    "fusion": ("bench_fusion", dict(spine=4, dim_rows=4096, fact_rows=2000,
                                    fold_rows=50_000, repeats=3, inner=1),
               "plan_fusion_speedup"),
    "summa": ("bench_summa", dict(rows=4096, k=64, cols=32, row_block=512,
                                  table_rows=20_000, repeats=2),
              "byte_equal"),
}


@pytest.mark.parametrize("mode", sorted(_MICRO_TINY))
def test_micro_bench_mode_on_the_cpu(mode, monkeypatch):
    import functools

    from netsdb_tpu_torch.workloads import micro_bench

    fn, kw, key = _MICRO_TINY[mode]
    monkeypatch.setattr(micro_bench, fn, functools.partial(
        getattr(micro_bench, fn), **kw))
    rc, text = _port("micro-bench", f"--{mode}")
    out = json.loads(text)
    assert rc == 0 and key in out
    if mode == "summa":  # 4 virtual CPU positions, as the reference's 4
        assert out["participants"] == 4 and out["byte_equal"] is True


def test_micro_bench_only_on_the_cpu(capsys):
    rc, text = _port("micro-bench", "--only",
                     "int_groupby,arena_alloc,segment_sum,shuffle")
    lines = text.splitlines()
    assert rc == 0 and len(lines) == 4
    assert all("ops/s" in ln for ln in lines)
    assert lines[1].endswith("(native arena)")
    assert lines[3].startswith(f"shuffle: {4 * (1 << 16)} ops")
    assert cli.main(["--device", "cpu", "micro-bench", "--only",
                     "nosuch"]) == 2
    assert "unknown benchmark" in capsys.readouterr().err


_SERVE_TINY = {
    "device-cache": ("run_device_cache_bench",
                     dict(rows=20_000, page_rows=2048, pool_mb=1, repeats=1,
                          cache_mb=64), [], "warm_misses_flat"),
    "partial-cache": ("run_partial_cache_bench",
                      dict(rows=20_000, page_rows=2048, pool_mb=1,
                           cache_mb=64, append_frac=0.05, cycles=1), [],
                      "partial_zero_evictions"),
    "scheduler": ("run_scheduler_bench", dict(rows=20_000, page_rows=2048,
                                              pool_mb=1, cache_mb=64),
                  ["--clients", "3"], "scheduler_on"),
    "fusion-distributed": ("run_fusion_distributed_bench",
                           dict(rows=20_000, queries=2), ["--daemons", "3"],
                           "gates_ok"),
    "data-plane": ("run_data_plane_bench", dict(chunk_mb=1, window=2,
                                                hedge_reads=6),
                   ["--table-mb", "1"], "hedged_reads"),
    "scale": ("run_scaleout_bench", dict(rows=20_000, queries=1,
                                         page_rows=2048, join_orders=64,
                                         join_rows=2000),
              ["--daemons", "2"], "q01_byte_equal"),
    "rebalance": ("run_rebalance_bench", dict(rows=4000, clients=2,
                                              measure_s=0.3, settle_s=0.2),
                  ["--daemons", "2"], "totals_exact"),
}


@pytest.mark.parametrize("mode", sorted(_SERVE_TINY))
def test_serve_bench_mode_on_the_cpu(mode, monkeypatch):
    import functools

    from netsdb_tpu_torch.workloads import serve_bench

    fn, kw, flags, key = _SERVE_TINY[mode]
    monkeypatch.setattr(serve_bench, fn, functools.partial(
        getattr(serve_bench, fn), **kw))
    rc, text = _port("serve-bench", f"--{mode}", *flags)
    out = json.loads(text)
    assert rc == 0 and out[key] not in (False, None)


def test_serve_bench_default_mode_on_the_cpu():
    """A spawned daemon process (``--platform cpu``, the reference's
    flag) and two client processes."""
    rc, text = _port("serve-bench", "--clients", "2", "--jobs", "2",
                     "--batch", "128", "--platform", "cpu")
    out = json.loads(text)
    assert rc == 0 and out["server_jobs_done"] >= 4
    assert [r["jobs"] for r in out["per_client"]] == [2, 2]


@pytest.mark.parametrize("argv", [["info"], ["demo-ff", "--batch", "8"],
                                  ["tpch", "--query", "q06"], ["selftest"],
                                  ["attention-bench", "--seqs", "64"],
                                  ["serve", "--port", "0"],
                                  ["micro-bench", "--only", "int_groupby"],
                                  ["serve-bench", "--device-cache"]])
def test_without_a_card_a_command_fails(argv):
    if not NO_CARD:
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


def test_module_entry_point_exit_codes():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    ok = subprocess.run([sys.executable, "-m", "netsdb_tpu_torch",
                         "--device", "cpu", "info"], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout)["device_kind"] == "cpu"
    if NO_CARD:
        bad = subprocess.run([sys.executable, "-m", "netsdb_tpu_torch",
                              "info"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and "device='cpu'" in bad.stderr


@pytest.fixture
def daemon(tmp_path):
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.serve.server import ServeController

    d = ServeController(Configuration(root_dir=str(tmp_path / "d"),
                                      obs_history_interval_s=0.05),
                        port=0, device="cpu")
    d.start()
    c = RemoteClient(d.advertise_addr, timeout=60.0)
    try:
        m = FFModel(db="ff", block=(16, 16))
        m.setup(c)
        m.load_random_weights(c, 32, 32, 8)
        import numpy as np

        m.load_inputs(c, np.ones((16, 32), np.float32))
        m.inference(c)
        yield d
    finally:
        c.close()
        d.shutdown()


def test_obs_readouts_render_as_the_reference(daemon):
    addr = daemon.advertise_addr
    from netsdb_tpu_torch.serve.client import RemoteClient

    c = RemoteClient(addr, timeout=60.0)
    try:
        stats = c.collect_stats()
        health = c.health()
        metrics = c.get_metrics(window_s=1.0)
        traces = c.get_trace(last=5)
    finally:
        c.close()
    # the pure extractors and renderers: byte-equal text on one payload
    assert cli._sched_view(stats) == ref_cli._sched_view(stats)
    assert cli._sessions_view(stats) == ref_cli._sessions_view(stats)
    assert cli._render_top(metrics) == ref_cli._render_top(metrics)
    for name, arg in (("_print_health", (health,)),
                      ("_print_sched", (cli._sched_view(stats),)),
                      ("_print_sessions", (cli._sessions_view(stats),)),
                      ("_print_obs", (stats, traces))):
        outs = []
        for mod in (cli, ref_cli):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                getattr(mod, name)(*arg)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], name


@pytest.mark.parametrize("flags", [["--health", "--json"],
                                   ["--sched", "--json"],
                                   ["--sessions", "--json"],
                                   ["--placement", "--json"],
                                   ["--slowlog", "--json"],
                                   ["--json"], ["--openmetrics"],
                                   ["--top", "--iterations", "1"],
                                   ["--health"], ["--sched"]])
def test_obs_commands_against_a_daemon(daemon, flags):
    rc, text = _port("obs", "--addr", daemon.advertise_addr, *flags)
    assert rc == 0 and text
    if "--json" in flags:
        out = json.loads(text)
        if "--health" in flags:
            assert {o["name"] for o in out["objectives"]} >= {
                "availability", "request_p99_s"}
        if flags == ["--json"]:
            assert "flash_attention" in out["stats"]["metrics"]["kernels"]
    if "--top" in flags:
        assert text.startswith("== top (history:") and "qps" in text
    if "--openmetrics" in flags:
        assert "# TYPE" in text


def test_obs_explain_unknown_qid_fails(daemon, capsys):
    rc = cli.main(["--device", "cpu", "obs", "--addr",
                   daemon.advertise_addr, "--explain", "no-such-qid"])
    assert rc == 1 and "no profile" in capsys.readouterr().err
