"""The plain references against float64, against the port's CPU path
(which they do not import) and the control's precision."""

import numpy as np
import pytest
import torch

from perfbench.kinds import ff, precision, transformer_layer

FF = {"features": 64, "hidden": 128, "labels": 32, "block": [32, 32]}
LAYER = {"n_embd": 64, "n_head": 4, "n_inner": None,
         "layer_norm_epsilon": 1e-5, "causal": True}
CPU = torch.device("cpu")


def _ff_f64_by_hand(w, x):
    w1, b1, wo, bo = (w[k].double() for k in ("w1", "b1", "wo", "bo"))
    y = wo @ torch.relu(w1 @ x.double().t() + b1[:, None]) + bo[:, None]
    return torch.softmax(y, dim=0)


def test_ff_reference_blocks_match_one_pass():
    d = ff.make_data(FF, {"rows": 100}, 1, 3, CPU)
    got = ff.reference(FF, d["weights"], d["inputs"][0], "f64",
                       block_rows=7)
    assert got.dtype == torch.float64 and got.shape == (32, 100)
    torch.testing.assert_close(got, _ff_f64_by_hand(d["weights"],
                                                    d["inputs"][0]),
                               rtol=1e-12, atol=1e-14)


def test_ff_reference_against_the_port_on_the_cpu():
    from perfbench.run import open_client
    from perfbench.systems import ff as ff_system

    d = ff.make_data(FF, {"rows": 100}, 2, 5, CPU)
    client = open_client(CPU)
    sut = ff_system.open(client, FF, d)
    for i in range(2):
        out = sut.dense(sut.request(i))
        ref = ff.reference(FF, d["weights"], d["inputs"][i], "f64")
        assert (out.double() - ref).abs().max() < 1e-6
        f32 = ff.reference(FF, d["weights"], d["inputs"][i], "f32")
        assert f32.dtype == torch.float32
        assert (f32.double() - ref).abs().max() < 1e-6


def _layer_f64_by_hand(w, x, heads):
    import torch.nn.functional as F

    w = {k: v.double() for k, v in w.items()}
    x = x.double()
    b, s, e = x.shape
    d = e // heads

    def ln(t):
        return (t - t.mean(-1, keepdim=True)) / torch.sqrt(
            t.var(-1, keepdim=True, unbiased=False) + 1e-5)

    q, k, v = (ln(x) @ w["w_qkv"]).chunk(3, dim=-1)
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
    scores = q @ k.transpose(-1, -2) / np.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    o = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(b, s, e)
    x1 = x + o @ w["w_out"]
    return x1 + F.gelu(ln(x1) @ w["w_up"], approximate="tanh") @ w["w_down"]


def test_layer_reference_blocks_match_one_pass():
    d = transformer_layer.make_data(LAYER, {"batch": 2, "seq": 48}, 1, 3,
                                    CPU)
    got = transformer_layer.reference(LAYER, d["weights"], d["inputs"][0],
                                      "f64", block_rows=5)
    torch.testing.assert_close(
        got, _layer_f64_by_hand(d["weights"], d["inputs"][0], 4),
        rtol=1e-12, atol=1e-12)


def test_layer_reference_against_the_port_on_the_cpu():
    from netsdb_tpu_torch.models.transformer import (TransformerLayerModel,
                                                     TransformerLayerParams)

    d = transformer_layer.make_data(LAYER, {"batch": 2, "seq": 48}, 1, 9,
                                    CPU)
    x = d["inputs"][0]
    model = TransformerLayerModel(num_heads=4)
    with torch.no_grad():
        port = model.forward(TransformerLayerParams(**d["weights"]), x)
    ref = transformer_layer.reference(LAYER, d["weights"], x, "f64")
    assert (port.double() - ref).abs().max() < 1e-5


@pytest.mark.parametrize("kind,cfg,shape", [
    (ff, FF, {"rows": 100}),
    (transformer_layer, LAYER, {"batch": 2, "seq": 48})])
def test_control_precision_reads_far_above_f32(kind, cfg, shape):
    """TF32 (emulated on the CPU) reads at least a hundred times f32's
    error against float64: the gap the limits sit in."""
    d = kind.make_data(cfg, shape, 1, 21, CPU)
    x = d["inputs"][0]
    ref = kind.reference(cfg, d["weights"], x, "f64")
    f32 = (kind.reference(cfg, d["weights"], x, "f32").double() - ref)
    tf32 = (kind.reference(cfg, d["weights"], x, "tf32").double() - ref)
    assert tf32.abs().max() > 100 * f32.abs().max()


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), 3.0], dtype=torch.float32)
    got = precision.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -(1.0 + 2 ** -9), 3.0]


def test_data_is_the_seeds():
    a = ff.make_data(FF, {"rows": 10}, 2, 2 ** 33 + 1, CPU)
    b = ff.make_data(FF, {"rows": 10}, 2, 2 ** 33 + 1, CPU)
    c = ff.make_data(FF, {"rows": 10}, 2, 2 ** 33 + 2, CPU)
    for k in ff.WEIGHTS:
        assert torch.equal(a["weights"][k], b["weights"][k])
    assert torch.equal(a["inputs"][1], b["inputs"][1])
    assert not torch.equal(a["inputs"][0], a["inputs"][1])
    assert not torch.equal(a["inputs"][0], c["inputs"][0])
    assert a["inputs"][0].dtype == torch.float32
