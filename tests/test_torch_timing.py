"""The port's timing loops (``utils/timing.py``) and ``structurally_close``
(``utils/compare.py``) against the reference's, on the CPU.

``time.perf_counter`` is patched to one fake clock that ``run(n)``
advances by a fixed cost plus ``n`` times a planted per-iteration cost,
so both packages' ``scan_slope_seconds`` see the same timings and must
return the same dict: the slope, the per-repeat slopes, ``lo``/``hi``
after escalation, and ``below_noise`` with ``seconds_per_iter`` None
when the signal never clears ``min_delta_seconds``. No test reads the
real clock."""

import time

import pytest

from netsdb_tpu.utils import compare as ref_compare
from netsdb_tpu.utils import timing as ref_timing
from netsdb_tpu_torch.utils import compare, timing


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = _FakeClock()
    monkeypatch.setattr(time, "perf_counter", c)
    return c


def _runner(clock, fixed_s, per_iter_s, calls):
    def run(n):
        calls.append(n)
        clock.t += fixed_s + n * per_iter_s
    return run


def _both(clock, fn, fixed_s, per_iter_s, **kw):
    """``fn`` of each package over the same planted costs; equal results
    and the same sequence of loop lengths."""
    out = {}
    for name, mod in (("ref", ref_timing), ("port", timing)):
        calls = []
        extra = {"device": "cpu"} if mod is timing else {}
        out[name] = (getattr(mod, fn)(_runner(clock, fixed_s, per_iter_s,
                                               calls), **kw, **extra),
                     calls)
    assert out["port"] == out["ref"]
    return out["port"]


def test_scan_slope_recovers_the_planted_cost(clock):
    res, calls = _both(clock, "scan_slope_seconds", 0.05, 0.02, lo=4, hi=20)
    assert res["below_noise"] is False and (res["lo"], res["hi"]) == (4, 20)
    assert res["seconds_per_iter"] == pytest.approx(0.02)
    assert res["slopes"] == [pytest.approx(0.02)] * 3
    assert calls == [4, 20] + [4, 20] * 3  # warm pair, then the repeats


def test_scan_slope_escalates_hi_until_the_delta_clears(clock):
    # 16 iterations of 2 ms = 32 ms < 200 ms: hi grows 4x until it clears
    res, calls = _both(clock, "scan_slope_seconds", 0.05, 0.002, lo=4,
                       hi=20)
    assert res["below_noise"] is False
    assert (res["lo"], res["hi"]) == (4, 320)
    assert res["seconds_per_iter"] == pytest.approx(0.002)
    assert sorted(set(calls)) == [4, 20, 80, 320]


def test_scan_slope_below_noise_reports_none(clock):
    res, _ = _both(clock, "scan_slope_seconds", 0.05, 1e-9, lo=4, hi=20,
                   max_escalations=2)
    assert res["below_noise"] is True and res["seconds_per_iter"] is None
    assert (res["lo"], res["hi"]) == (4, 320)
    assert len(res["slopes"]) == 3


def test_device_seconds_follows_the_slope(clock):
    (sec, _), (none, _) = (
        _both(clock, "device_seconds", 0.1, 0.05),
        _both(clock, "device_seconds", 0.1, 1e-12, max_escalations=1))
    assert sec == pytest.approx(0.05)
    assert none is None


def test_device_seconds_default_clock_is_the_card():
    """Without ``device="cpu"`` the loops time with CUDA events, which
    need a card; here the event constructor is what fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        timing.device_seconds(lambda n: None)


@pytest.mark.parametrize("a,b,kw", [
    ({"x": [1.0, 2.0], "y": (3, "s")}, {"x": [1.0, 2.0001], "y": (3, "s")},
     {}),
    ({"x": [1.0, 2.0]}, {"x": [1.0, 2.1]}, {}),
    ({"x": 1}, {"x": 1, "z": 2}, {}),
    ([1.0, [2.0, {"k": 3.0}]], [1.0, [2.0, {"k": 3.0005}]], {}),
    ([1.0, 2.0], [1.0], {}),
    (1.0, 1.0 + 1e-3, {"rtol": 0.0, "atol": 1e-4}),
    ("a", "a", {}),
    (5, 5.0005, {}),
])
def test_structurally_close_agrees_with_the_reference(a, b, kw):
    assert compare.structurally_close(a, b, **kw) == \
        ref_compare.structurally_close(a, b, **kw)
