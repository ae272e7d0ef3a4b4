"""Reading a traced window: busy time, operations and idle gaps."""

import pytest

from perfbench import devtrace


def test_union_merges_overlaps():
    assert devtrace.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == \
        [[0, 2.5], [3, 4]]


def test_summarize_busy_ops_and_idle_gaps():
    device = [(1.0, 2.0, "gemm"), (1.5, 2.5, "gemm"), (4.0, 5.0, "softmax"),
              (9.0, 12.0, "gemm"), (0.0, 10.0, "Activity Buffer Request")]
    host = [(0.0, 10.0, devtrace.SPAN_REQUEST),
            (2.5, 4.0, "aten::copy_"), (5.0, 9.5, devtrace.SPAN_SYNC)]
    s = devtrace.summarize(device, host, (0.0, 10.0))
    # busy: [1, 2.5] and [4, 5] and [9, 10] (clipped)
    assert s["busy_s"] == pytest.approx(3.5)
    assert s["window_s"] == 10.0
    assert s["device_ops_count"] == 4
    # summed by name, overlaps counted in each operation: 1 + 1 + 1
    assert s["device_ops"] == [["gemm", 3.0], ["softmax", 1.0]]
    # gaps: [0, 1] request, [2.5, 4] copy, [5, 9] sync
    assert dict(s["idle_gaps"]) == {
        devtrace.SPAN_REQUEST: pytest.approx(1.0),
        "aten::copy_": pytest.approx(1.5),
        devtrace.SPAN_SYNC: pytest.approx(4.0)}
    assert s["idle_gaps"][0][0] == devtrace.SPAN_SYNC
    # every operation's launches and seconds, inside the window
    assert s["op_totals"] == {"gemm": [3, pytest.approx(3.0)],
                              "softmax": [1, pytest.approx(1.0)]}


def test_no_device_operation_reads_no_busy_time():
    s = devtrace.summarize([], [], (0.0, 1.0))
    assert s["busy_s"] == 0 and s["device_ops"] == []
    assert s["idle_gaps"] == [["host (no span)", 1.0]]


def test_span_range():
    host = [(1.0, 2.0, "a"), (3.0, 5.0, "a"), (0.0, 9.0, "b")]
    assert devtrace.span_range(host, "a") == (1.0, 5.0)
    assert devtrace.span_range(host, "c") is None


def test_b1_roofline_is_read_from_the_traced_window():
    """B1's time a launch is its fold's and K/V split's device time over
    the fold's launches; B2's fold (which carries a state) is not B1."""
    from types import SimpleNamespace

    from perfbench import arithmetic
    from perfbench.manifest import Manifest

    reader = Manifest().reader("flash_attention_roofline")
    cfg = {"n_embd": 1024, "n_head": 16, "causal": True,
           "dtype": "float32"}
    totals = {
        "void netsdb_fold::fold_kernel<float, 64, false>"
        "(netsdb_fold::FoldParams)": [100, 0.5],
        "netsdb_fold::split_kv_kernel(float const*, float const*, float*, "
        "float*, float*, float*, int, int, int, int, int)": [100, 0.1],
        "void netsdb_fold::fold_kernel<float, 64, true>"
        "(netsdb_fold::FoldParams)": [7, 9.0],
        "sgemm": [300, 2.0]}
    ctx = SimpleNamespace(config=cfg, mix={"shape": {"batch": 1,
                                                     "seq": 16384}},
                          peaks=arithmetic.H100_SXM,
                          trace={"op_totals": totals})
    bound = arithmetic.attention_bound_ms(1, 16, 16384, 64, True,
                                          "float32", arithmetic.H100_SXM)[0]
    # 0.6 s over 100 launches: 6 ms a launch
    assert reader.read(ctx) == pytest.approx(100 * bound / 6.0)
    ctx.trace = {"op_totals": {"sgemm": [300, 2.0]}}
    assert reader.read(ctx) is None
    ctx.trace = None
    assert reader.read(ctx) is None
