"""The port's attention, ring, layer, conv and model benches on the CPU
at the reference tests' tiny sizes (``tests/test_attention_bench.py``,
``test_conv_bench.py``, ``test_model_bench.py``): structure, the honesty
of the below-noise marker, the reference's pinned constants and FLOP
counts, the ring fold against plain attention, and the direct conv
against ATen and the reference's conv. On the CPU there is no
yardstick (the library's flash kernel) and no ceiling guard."""

import numpy as np
import pytest
import torch

from netsdb_tpu_torch.workloads import (attention_bench, conv_bench,
                                        model_bench, transformer_bench)

FAST = dict(min_delta_seconds=0.01, max_escalations=2)


def _measured_or_marked(r):
    # a real measurement, an honest below-noise marker, or a captured
    # error string — never a fabricated number
    assert ("ms" in r) or r.get("below_device_noise") or ("error" in r)
    if "ms" in r:
        assert r["ms"] > 0 and r["tokens_per_sec"] > 0


def test_attention_bench_smoke():
    res = attention_bench.bench_attention(seq_lens=(128,), batch=1,
                                          heads=2, head_dim=32,
                                          device="cpu", **FAST)
    entry = res["seq_128"]
    assert entry["batch"] == 1 and entry["heads"] == 2
    for mode in ("naive", "flash"):
        _measured_or_marked(entry[mode])
        assert entry[mode]["calls"] > 0
    assert "sdpa_flash" not in entry and "flash_vs_sdpa" not in entry


def test_attention_bench_constants_equal_the_reference():
    from netsdb_tpu.workloads import attention_bench as ref

    assert (attention_bench.CEILING_RATIO, attention_bench.CEILING_SEQ) \
        == (ref.CEILING_RATIO, ref.CEILING_SEQ) == (0.92, 8192)


def test_ring_fold_equals_attention_of_the_last_chunk():
    """The fold of 4 chunks for the causal worst-case position (q last)
    equals plain causal attention of that q block over every key."""
    from netsdb_tpu_torch.ops.attention import attention

    rng = np.random.default_rng(0)
    bh, s, d, n = 2, 16, 8, 4
    q = torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32))
    kv = [torch.from_numpy(rng.standard_normal((bh, n * s, d)).astype(
        np.float32)) for _ in range(2)]
    out = attention_bench.ring_fold(
        q, [c.contiguous() for c in kv[0].split(s, 1)],
        [c.contiguous() for c in kv[1].split(s, 1)], n)
    full_q = torch.zeros((1, bh, n * s, d))
    full_q[0, :, (n - 1) * s:] = q
    want = attention(full_q, kv[0][None], kv[1][None], causal=True)
    np.testing.assert_allclose(out.numpy(), want[0, :, (n - 1) * s:].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_ring_fold_bench_smoke():
    res = attention_bench.bench_ring_fold(n_chunks=2, s_local=64, batch=1,
                                          heads=2, head_dim=32,
                                          device="cpu", **FAST)
    assert res["n_chunks"] == 2 and res["calls"] % 2 == 0
    assert ("ms" in res and res["ms"] > 0) or res.get("below_device_noise")


def test_layer_flops_equal_the_reference():
    from netsdb_tpu.workloads import transformer_bench as ref

    for args in ((2, 4096, 1024, 8), (1, 64, 32, 2), (2, 8192, 1024, 8)):
        for causal in (True, False):
            assert transformer_bench.layer_flops(*args, causal=causal) == \
                ref.layer_flops(*args, causal=causal)


def test_transformer_bench_smoke():
    res = transformer_bench.bench_transformer_layer(
        seq_lens=(64,), batch=1, embed=32, heads=2, device="cpu", **FAST)
    r = res["seq_64"]
    assert r["calls"] > 0
    assert ("ms" in r and r["tflops"] >= 0) or r.get("below_device_noise")
    with pytest.raises(ValueError, match="divisible"):
        transformer_bench.bench_transformer_layer(embed=30, heads=4,
                                                  device="cpu")


def test_conv_bench_smoke():
    res = conv_bench.run_conv_bench(batch=2, hw=16, cin=3, cout=4, k=3,
                                    iters=2, device="cpu")
    assert res["backend"] == "cpu"
    for mode in ("direct", "im2col"):
        assert res[mode]["p50_ms"] > 0
        assert res[mode]["p90_ms"] >= res[mode]["p50_ms"]
        assert res[mode]["speedup_vs_torch_cpu_p50"] > 0
    assert res["torch_cpu_reference"]["p50_ms"] > 0


def test_direct_matches_torch_and_the_reference():
    import jax.numpy as jnp

    from netsdb_tpu.ops.conv import conv2d_direct as jconv
    from netsdb_tpu_torch.ops.conv import conv2d_direct

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 12, 12)).astype(np.float32)
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    ours = conv2d_direct(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    with torch.no_grad():
        ref = torch.conv2d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(jconv(jnp.asarray(x),
                                                      jnp.asarray(w))),
                               rtol=1e-4, atol=1e-4)


def test_model_bench_smoke():
    res = model_bench.run_model_bench(scale=0.01, device="cpu")
    assert set(res) == {"word2vec", "lstm", "text_classifier"}
    for name, r in res.items():
        cpu_key = [k for k in r if k.startswith("cpu_")]
        assert cpu_key and r[cpu_key[0]] > 0, (name, r)
        if not r.get("below_device_noise"):
            dev_key = [k for k in r if k.startswith("tpu_")]
            assert dev_key and r[dev_key[0]] > 0, (name, r)
            assert r["speedup"] >= 0, (name, r)


@pytest.mark.parametrize("bench,kw", [
    (attention_bench.bench_attention, dict(seq_lens=(64,))),
    (attention_bench.bench_ring_fold, dict()),
    (transformer_bench.bench_transformer_layer, dict(seq_lens=(64,))),
    (conv_bench.run_conv_bench, dict()),
    (model_bench.run_model_bench, dict())])
def test_benches_run_on_the_card_unless_asked(bench, kw):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench(**kw)
