"""``python -m netsdb_tpu_torch`` against the reference's CLI
(``netsdb_tpu/cli.py``) on the CPU: ``info``, ``demo-ff``, ``tpch`` and
``pdml`` print what the reference prints where both print the same
fields; ``obs`` renders an in-process daemon's readouts with the
reference's renderers' exact text; ``selftest`` passes all 20 steps;
the commands of later ROADMAP.md items exit non-zero naming them; and
without a card a command fails unless ``--device cpu`` is given.

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


@pytest.mark.parametrize("cmd,item", [("bench", "A9"),
                                      ("micro-bench", "A8 item 4"),
                                      ("serve-bench", "A8 item 4"),
                                      ("lint", "A8 item 6")])
def test_later_commands_exit_nonzero_naming_their_item(cmd, item, capsys):
    assert cli.main(["--device", "cpu", cmd]) != 0
    assert f"ROADMAP.md {item}" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["info"], ["demo-ff", "--batch", "8"],
                                  ["tpch", "--query", "q06"], ["selftest"],
                                  ["attention-bench", "--seqs", "64"],
                                  ["serve", "--port", "0"]])
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
