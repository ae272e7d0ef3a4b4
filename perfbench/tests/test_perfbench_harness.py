"""The harness at tiny sizes on the CPU: a whole run's result, the
faults and the control that ``correct`` has to catch, and the command
itself without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import run
from perfbench.kinds import ff, transformer_layer
from perfbench.manifest import PKG_DIR

CELLS = ("ff.tiny", "layer.tiny")
KINDS = {"ff.tiny": ff, "layer.tiny": transformer_layer}
SEED = 2 ** 31 + 12345  # seeds may pass 32 signed bits


def _measure(man, cell, trace=False, wrap=None, seed=SEED):
    return run.measure(man, cell, seed, 0.2, trace, "cpu", wrap=wrap)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_its_result_has_the_schema(tiny, cell):
    r = _measure(tiny, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "setup_phases_s", "program_counters", "request_ms",
                       "checks"]
    assert set(r["setup_phases_s"]) == {"start", "device", "data", "store",
                                        "warm"}
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    unit = "rows_per_s" if cell == "ff.tiny" else "tokens_per_s"
    assert set(r["metrics"]) == {m["name"] for m in tiny.end_to_end(cell)}
    assert {"setup_s", unit} <= set(r["metrics"])
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"}
        assert m["value"] > 0, name
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}
    checks = r["checks"]
    assert set(checks) == {"max_abs_err", "failed"}
    assert checks["max_abs_err"]["value"] <= checks["max_abs_err"]["limit"]
    json.loads(json.dumps(r))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics_only(tiny, cell):
    r = _measure(tiny, cell, trace=True)
    assert r["correct"] is True
    # on the CPU the program cache counts nothing and there is no card
    # peak or device trace: every reader finds nothing and is left out
    assert r["metrics"] == {}
    assert list(r)[-1] == "checks"


class _Wrapped:
    """The program under test with a fault planted in its outputs."""

    def __init__(self, inner, alter):
        self.inner, self.alter = inner, alter

    def request(self, i):
        return self.alter(i, self.inner.request(i))

    def dense(self, out):
        return self.inner.dense(out)


def _on_data(out, fn):
    """``fn`` applied to an output's tensor, in the output's own form."""
    if hasattr(out, "with_data"):
        return out.with_data(fn(out.data.clone()))
    return fn(out.clone())


def _altered(t):
    t.view(-1)[7] += 1e-3  # one answer altered where it is produced
    return t


def _half_left_out(t):
    if t.dim() == 2:  # FF: (labels × rows): rows are columns
        t[:, t.shape[1] // 2:] = 0
    else:             # the layer: (batch, seq, embed)
        t[t.shape[0] // 2:] = 0
    return t


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half_left_out])
def test_a_fault_in_the_timed_path_is_not_correct(tiny, cell, fault):
    r = _measure(tiny, cell, wrap=lambda sut: _Wrapped(
        sut, lambda i, out: _on_data(out, fault)))
    assert r["correct"] is False
    assert r["checks"]["max_abs_err"]["value"] > \
        r["checks"]["max_abs_err"]["limit"]


def test_an_answer_altered_inside_the_program_is_not_correct(tiny,
                                                             monkeypatch):
    from netsdb_tpu_torch.ops import nn as nn_ops

    real = nn_ops.ff_output_layer

    def wrong(y, b, axis=0):
        out = real(y, b, axis=axis)
        return out.with_data(out.data * (1 + 1e-3))

    monkeypatch.setattr(nn_ops, "ff_output_layer", wrong)
    assert _measure(tiny, "ff.tiny")["correct"] is False


class _Control:
    """The plain reference in the program's place, with TF32 on (on the
    CPU: operands rounded to TF32)."""

    def __init__(self, man, cell):
        c = man.cell(cell)
        self.config = man.config(c["config"])
        self.mix = man.traffic(c["traffic"])
        self.kind = KINDS[cell]
        self.data = self.kind.make_data(self.config, self.mix["shape"],
                                        self.mix["input_sets"], SEED,
                                        torch.device("cpu"))

    def request(self, i):
        return self.kind.reference(self.config, self.data["weights"],
                                   self.data["inputs"][i], "tf32")

    @staticmethod
    def dense(out):
        return out


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    control = _Control(tiny, cell)
    r = _measure(tiny, cell, wrap=lambda sut: control)
    assert r["correct"] is False
    assert r["checks"]["max_abs_err"]["value"] > \
        3 * r["checks"]["max_abs_err"]["limit"]


def test_a_failed_request_is_counted_and_not_correct(tiny):
    class Failing(_Wrapped):
        n = 0

        def request(self, i):
            Failing.n += 1
            if Failing.n == 6:  # one request of the window
                raise RuntimeError("planted")
            return self.inner.request(i)

    r = _measure(tiny, "ff.tiny", wrap=lambda sut: Failing(sut, None))
    assert r["failed"] == 1 and r["correct"] is False
    assert r["checks"]["failed"] == {"value": 1, "limit": 0}


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", "ff.score16k",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_the_command_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is available here")
    proc = _command(PKG_DIR.parent)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_the_benchmark_alone_cannot_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure: the program's adapters do not import."""
    shutil.copy(PKG_DIR.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", "import perfbench.systems.ff"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "netsdb_tpu_torch" in proc.stderr
    proc = _command(tmp_path, env)
    assert proc.returncode != 0 and proc.stdout == ""


def test_percentiles_are_the_nearest_rank():
    assert run.percentile([float(i) for i in range(1, 101)], 95) == 95.0
    assert run.percentile([3.0], 95) == 3.0
    assert run.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert run.percentile([1.0] * 18 + [9.0, 9.0], 95) == 9.0
    assert run.percentile([2.0, 1.0, 3.0], 100) == 3.0
