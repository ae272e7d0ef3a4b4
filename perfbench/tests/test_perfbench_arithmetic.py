"""The yardstick's counts and bounds at the cells' shapes, by hand."""

import pytest

from perfbench import arithmetic
from perfbench.kinds import ff, transformer_layer

FF = {"features": 1024, "hidden": 4096, "labels": 1024}
LAYER = {"n_embd": 1024, "n_head": 16, "n_inner": None, "causal": True}


def test_ff_flops_at_the_cell():
    # w1·xᵀ: 2·16384·1024·4096; wo·y: 2·16384·4096·1024
    assert ff.flops_per_request(FF, {"rows": 16384}) == 274877906944.0
    assert ff.units_per_request({"rows": 16384}) == 16384


def test_layer_flops_at_the_cell():
    attn = 2 * 2 * 16 * 16384 * 16384 * 64 // 2     # 549755813888
    proj = 2 * 16384 * 1024 * (3 * 1024 + 1024)        # 137438953472
    mlp = 2 * 2 * 16384 * 1024 * 4 * 1024              # 274877906944
    assert attn + proj + mlp == 962072674304
    assert transformer_layer.flops_per_request(
        LAYER, {"batch": 1, "seq": 16384}) == 962072674304.0
    assert transformer_layer.units_per_request(
        {"batch": 1, "seq": 16384}) == 16384
    # not causal: the whole score matrix
    assert arithmetic.layer_flops(1, 16384, 1024, 16, causal=False) == \
        2 * attn + proj + mlp
    # an MLP of another width
    assert arithmetic.layer_flops(1, 16384, 1024, 16, inner=2048) == \
        attn + proj + mlp // 2


def test_b1_bound_at_the_cell():
    pk = arithmetic.H100_SXM
    # causal pairs 16384·16385/2 = 134225920, 4 FLOP a pair and dim
    flops = 4 * 16 * 134225920 * 64
    assert arithmetic.attention_flops(1, 16, 16384, 64, True) == flops
    ms, by, route, cuda_cores = arithmetic.attention_bound_ms(
        1, 16, 16384, 64, True, "float32", pk)
    assert ms == pytest.approx(3 * flops / 495e12 * 1e3)   # 3.332 ms
    assert ms == pytest.approx(3.3320568, rel=1e-6)
    assert by == "operations"
    assert route == "three-pass tf32 tensor cores"
    assert cuda_cores == pytest.approx(flops / 67e12 * 1e3)
    # bytes: q, k, v read once and o written once, f32
    t_bytes = 4 * 16 * 16384 * 64 * 4 / 3.35e12 * 1e3
    assert arithmetic.bounds_ms(0, 4 * 16 * 16384 * 64 * 4, "tf32", pk) == \
        (pytest.approx(t_bytes), "bytes")
    bf16, by16, route16, none = arithmetic.attention_bound_ms(
        1, 16, 16384, 64, True, "bfloat16", pk)
    assert bf16 == pytest.approx(flops / 989e12 * 1e3)
    assert (by16, route16, none) == ("operations", "bfloat16 tensor cores",
                                     None)


def test_peaks():
    assert arithmetic.f32_accurate_peak(arithmetic.H100_SXM) == 165e12
    assert arithmetic.H100_SXM == {"float32": 67e12, "tf32": 495e12,
                                   "bfloat16": 989e12, "bytes": 3.35e12}
