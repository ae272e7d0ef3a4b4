"""``models/decode.py`` of the port against the reference's on the CPU:
the step functions from the same numpy weights (the LSTM cell, and the
transformer layer's ring-buffer KV cache across wraps) within 1e-5, the
deployed weights bit for bit, the bucket ladder, the ``decode_stats``
counters after the same sequence of batches, and the residency
accounting of two fine-tuned variants under ``model_dedup``."""

import numpy as np
import pytest
import torch

from netsdb_tpu.models import decode as ref_decode
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models import decode

HID = 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def port_client(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def _x(i, step, hidden=HID):
    return np.random.default_rng(1000 * i + step).standard_normal(
        hidden).astype(np.float32)


def _runtimes(client, port_client, db, kind, seed, kv_max=64, **kw):
    ref_decode.deploy_decode_model(client, db, kind=kind, hidden=HID,
                                   seed=seed, **kw)
    decode.deploy_decode_model(port_client, db, kind=kind, hidden=HID,
                               seed=seed, **kw)
    ref = ref_decode.DecodeRuntime(client, kv_max=kv_max)
    port = decode.DecodeRuntime(port_client, kv_max=kv_max)
    ref.register_model(db, kind)
    port.register_model(db, kind)
    return ref, port


def test_deployed_weights_equal_the_reference(client, port_client):
    for kind, base in (("lstm", None), ("transformer_layer", 7)):
        db = f"w_{kind}"
        ref_decode.deploy_decode_model(client, db, kind=kind, hidden=HID,
                                       seed=3, base_seed=base)
        decode.deploy_decode_model(port_client, db, kind=kind, hidden=HID,
                                   seed=3, base_seed=base)
        names = (decode.LSTM_WEIGHTS if kind == "lstm"
                 else decode.TRANSFORMER_WEIGHTS)
        assert names == (ref_decode.LSTM_WEIGHTS if kind == "lstm"
                         else ref_decode.TRANSFORMER_WEIGHTS)
        for n in names:
            ours = port_client.get_tensor(db, n)
            theirs = client.get_tensor(db, n)
            assert ours.meta.block_shape == tuple(theirs.meta.block_shape)
            assert ours.to_dense().numpy().tobytes() == \
                np.asarray(theirs.to_dense()).tobytes()


@pytest.mark.parametrize("kind,kv_max,steps", [
    ("lstm", 64, 12), ("transformer_layer", 8, 20),
    ("transformer_layer", 64, 6)])
def test_step_batches_match_the_reference(client, port_client, kind,
                                          kv_max, steps):
    """Three sessions stepped together (the layer's ring wrapping 2.5
    times at kv_max 8): outputs within 1e-5, states on the device."""
    ref, port = _runtimes(client, port_client, "m", kind, seed=5,
                          kv_max=kv_max)
    rs = [ref.init_state("m") for _ in range(3)]
    ps = [port.init_state("m") for _ in range(3)]
    assert set(ps[0]) == set(rs[0])
    for step in range(steps):
        xs = [_x(i, step) for i in range(3)]
        rs, ry = ref.step_batch("m", rs, xs)
        ps, py = port.step_batch("m", ps, xs)
        for a, b in zip(py, ry):
            assert isinstance(a, np.ndarray)
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for layer in ps[0]:
        assert isinstance(ps[0][layer], torch.Tensor)
        np.testing.assert_allclose(ps[0][layer].numpy(),
                                   np.asarray(rs[0][layer]), **TOL)
    if kind == "transformer_layer":
        assert int(ps[0]["pos"]) == steps


def test_first_step_of_a_fresh_layer_session_is_finite(port_client):
    """One live cache entry: the dead slots weigh exactly 0 (no NaN)."""
    decode.deploy_decode_model(port_client, "t", kind="transformer_layer",
                               hidden=HID, seed=2)
    rt = decode.DecodeRuntime(port_client, kv_max=16)
    rt.register_model("t", "transformer_layer")
    new, ys = rt.step_batch("t", [rt.init_state("t")], [_x(0, 0)])
    assert np.isfinite(ys[0]).all()
    assert torch.isfinite(new[0]["k"]).all()
    assert int(new[0]["pos"]) == 1


def test_solo_and_batched_rows_are_bit_equal(port_client):
    """A session alone and the same session inside a batch of 8 land on
    the same bucket and program: bit-equal outputs."""
    decode.deploy_decode_model(port_client, "m", kind="transformer_layer",
                               hidden=HID, seed=4)
    rt = decode.DecodeRuntime(port_client, kv_max=8)
    rt.register_model("m", "transformer_layer")
    solo = [rt.init_state("m")]
    batch = [rt.init_state("m") for _ in range(8)]
    for step in range(12):
        solo, ys = rt.step_batch("m", solo, [_x(0, step)])
        batch, yb = rt.step_batch("m", batch,
                                  [_x(i, step) for i in range(8)])
        assert ys[0].tobytes() == yb[0].tobytes()


def test_buckets_and_stats_equal_the_reference(client, port_client):
    assert [decode.decode_bucket(n) for n in range(1, 41)] == \
        [ref_decode.decode_bucket(n) for n in range(1, 41)]
    ref_decode.clear_decode_programs()
    decode.clear_decode_programs()
    ref, port = _runtimes(client, port_client, "m", "lstm", seed=6)
    for n in (1, 3, 8, 2, 9, 12, 1, 16):
        ref.step_batch("m", [ref.init_state("m")] * n,
                       [_x(i, 0) for i in range(n)])
        port.step_batch("m", [port.init_state("m")] * n,
                        [_x(i, 0) for i in range(n)])
    ours, theirs = decode.decode_stats(), ref_decode.decode_stats()
    assert ours == theirs
    assert ours["traces"] == ours["programs"] == 3  # buckets 8, 12, 16
    from netsdb_tpu_torch import obs

    assert obs.REGISTRY.snapshot()["decode"] == ours
    decode.clear_decode_programs()
    assert decode.decode_stats()["traces"] == 0


def test_state_layers_and_sizes_equal_the_reference(client, port_client):
    for kind in ("lstm", "transformer_layer"):
        ref, port = _runtimes(client, port_client, kind, kind, seed=1)
        assert port.state_layers(kind) == ref.state_layers(kind)
        assert port.state_nbytes(kind) == ref.state_nbytes(kind)
        assert port.spec(kind) == ref.spec(kind)
        with pytest.raises(KeyError):
            port.step_batch("absent", [], [])


def test_residency_of_two_finetuned_variants_equals_the_reference(
        client, port_client):
    ref = ref_decode.DecodeRuntime(client, model_dedup=True)
    port = decode.DecodeRuntime(port_client, model_dedup=True)
    for db, seed in (("ma", 21), ("mb", 22)):
        ref_decode.deploy_decode_model(client, db, kind="lstm",
                                       hidden=HID, seed=seed, base_seed=77)
        decode.deploy_decode_model(port_client, db, kind="lstm",
                                   hidden=HID, seed=seed, base_seed=77)
        ref.register_model(db, "lstm")
        port.register_model(db, "lstm")
    ours, theirs = port.residency_report(), ref.residency_report()
    for key in ("models", "unique_page_bytes", "total_page_bytes",
                "charged_bytes", "charged_by_model", "model_dedup"):
        assert ours[key] == theirs[key], key
    assert ours["unique_page_bytes"] < 0.8 * ours["total_page_bytes"]
    assert abs(sum(ours["charged_by_model"].values())
               - ours["unique_page_bytes"]) <= 2
    assert ours["pool"]["unique_blocks"] == theirs["pool"]["unique_blocks"]
