"""Model-family inference benchmarks — the port's
``netsdb_tpu/workloads/model_bench.py``: word2vec, the LSTM and the text
classifier.

The reference ships these workloads (``src/word2vec/source/Word2Vec.cc``,
``src/LSTM`` + ``src/tests/source/LSTMTest.cc``,
``src/word2vec/source/TestSemanticClassifier.cc``) but publishes NO
performance numbers for them (BASELINE.md), so this module measures
both sides itself: the path through this package on the client's device
and the netsDB-equivalent CPU path (numpy f64 block GEMMs — the
per-worker Eigen compute model) on this host.

Timing: the device via ``utils.timing.device_seconds`` (the slope
between two loop lengths, CUDA events on a card); the CPU baselines by
median wall time. The device keys keep the reference's names
(``tpu_*``): they hold this package's device path, whatever the device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.lstm import LSTMParams, lstm_cell
from netsdb_tpu_torch.utils.timing import device_seconds


def _device_seconds(step, device) -> Optional[float]:
    def run(n: int) -> None:
        with torch.inference_mode():
            for _ in range(n):
                step()
    return device_seconds(run, device=device)


def _cpu_median_seconds(fn, repeats: int = 3) -> float:
    """Median wall time of ``fn()`` — same median-of-repeats discipline
    as the device side, so one cold run (BLAS pool spin-up, scheduler
    hiccup) cannot inflate the published speedup."""
    fn()  # warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def bench_word2vec(vocab: int = 100_000, dim: int = 512,
                   batch: int = 65536, seed: int = 0,
                   device=None) -> Dict[str, float]:
    """Embedding serving. Device path = gather; CPU baseline = the
    reference's one-hot x table blocked matmul (Word2Vec.cc:19-80)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table_np = rng.standard_normal((vocab, dim)).astype(np.float32)
    table = torch.from_numpy(table_np).to(dev)
    ids = torch.from_numpy(rng.integers(0, vocab, batch).astype(
        np.int64)).to(dev)

    dev_s = _device_seconds(lambda: torch.index_select(table, 0, ids), dev)

    # CPU equivalent at reduced batch, linear in batch: one-hot matmul.
    # One (chunk, vocab) one-hot is built OUTSIDE the timed region and
    # reused for cpu_batch/chunk GEMMs — identical timed FLOPs to the
    # single (cpu_batch, vocab) matmul at a fraction of the memory
    cpu_batch = 2048
    chunk = 256
    onehot = np.zeros((chunk, vocab))
    onehot[np.arange(chunk), rng.integers(0, vocab, chunk)] = 1.0
    tbl64 = table_np.astype(np.float64)

    def onehot_matmul():
        for _ in range(cpu_batch // chunk):
            onehot @ tbl64

    cpu = _cpu_median_seconds(onehot_matmul) / cpu_batch
    out = {"vocab": vocab, "dim": dim, "batch": batch,
           "cpu_onehot_matmul_ids_per_sec": round(1.0 / cpu, 1)}
    if dev_s is not None:
        out["tpu_lookup_ids_per_sec"] = round(batch / dev_s, 1)
        out["speedup"] = round((batch / dev_s) * cpu, 1)
    else:
        out["below_device_noise"] = True
    return out


def bench_lstm(hidden: int = 1024, inp: int = 1024, batch: int = 1024,
               block: int = 512, seed: int = 0,
               device=None) -> Dict[str, float]:
    """One LSTM cell step (8 matmuls + gates — the reference's
    LSTMTest DAG) in cells/s of (hidden x batch) state updates."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def bt(r, c):
        return BlockedTensor.from_dense(
            rng.standard_normal((r, c)).astype(np.float32), (block, block),
            device=dev)

    def bias(r):
        return BlockedTensor.from_dense(
            rng.standard_normal((r, 1)).astype(np.float32) * 0.1,
            (block, 1), device=dev)

    params = LSTMParams(
        w_i=bt(hidden, inp), w_f=bt(hidden, inp), w_c=bt(hidden, inp),
        w_o=bt(hidden, inp),
        u_i=bt(hidden, hidden), u_f=bt(hidden, hidden),
        u_c=bt(hidden, hidden), u_o=bt(hidden, hidden),
        b_i=bias(hidden), b_f=bias(hidden), b_c=bias(hidden),
        b_o=bias(hidden),
    )
    x = bt(inp, batch)
    h0 = bt(hidden, batch)
    c0 = bt(hidden, batch)

    dev_s = _device_seconds(
        lambda: lstm_cell(params, x, h0, c0, "bfloat16"), dev)

    # CPU equivalent: same 8 GEMMs + gates in f64 numpy at reduced batch
    cpu_batch = 128
    w = {k: getattr(params, k).to_dense().double().cpu().numpy()
         for k in ("w_i", "w_f", "w_c", "w_o", "u_i", "u_f", "u_c", "u_o")}
    xs = rng.standard_normal((inp, cpu_batch))
    hs = rng.standard_normal((hidden, cpu_batch))

    def cpu_cell():
        for gate_w, gate_u in (("w_i", "u_i"), ("w_f", "u_f"),
                               ("w_c", "u_c"), ("w_o", "u_o")):
            z = w[gate_w] @ xs + w[gate_u] @ hs
            _ = 1.0 / (1.0 + np.exp(-z))

    cpu = _cpu_median_seconds(cpu_cell) / cpu_batch
    out = {"hidden": hidden, "input": inp, "batch": batch,
           "cpu_cell_rows_per_sec": round(1.0 / cpu, 1)}
    if dev_s is not None:
        out["tpu_cell_rows_per_sec"] = round(batch / dev_s, 1)
        out["speedup"] = round((batch / dev_s) * cpu, 1)
    else:
        out["below_device_noise"] = True
    return out


def bench_text_classifier(vocab: int = 50_000, dim: int = 512,
                          labels: int = 16, batch: int = 16384,
                          seed: int = 0, device=None) -> Dict[str, float]:
    """word2vec layer + SemanticClassifier FC layer
    (``TestSemanticClassifier.cc`` / ``SemanticClassifier.h``): docs/s."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table_np = rng.standard_normal((vocab, dim)).astype(np.float32)
    w_np = rng.standard_normal((labels, dim)).astype(np.float32)
    b_np = rng.standard_normal((labels,)).astype(np.float32)
    table, w, b = (torch.from_numpy(a).to(dev)
                   for a in (table_np, w_np, b_np))
    ids = torch.from_numpy(rng.integers(0, vocab, batch).astype(
        np.int64)).to(dev)

    def step():
        feats = torch.index_select(table, 0, ids)  # (batch, dim)
        return torch.softmax(feats @ w.T + b, dim=1)

    dev_s = _device_seconds(step, dev)

    cpu_batch = 4096
    t64 = table_np.astype(np.float64)
    w64 = w_np.astype(np.float64)
    b64 = b_np.astype(np.float64)
    cids = rng.integers(0, vocab, cpu_batch)

    def cpu_cls():
        feats = t64[cids]
        logits = feats @ w64.T + b64
        e = np.exp(logits - logits.max(1, keepdims=True))
        _ = e / e.sum(1, keepdims=True)

    cpu = _cpu_median_seconds(cpu_cls) / cpu_batch
    out = {"vocab": vocab, "dim": dim, "labels": labels, "batch": batch,
           "cpu_docs_per_sec": round(1.0 / cpu, 1)}
    if dev_s is not None:
        out["tpu_docs_per_sec"] = round(batch / dev_s, 1)
        out["speedup"] = round((batch / dev_s) * cpu, 1)
    else:
        out["below_device_noise"] = True
    return out


def run_model_bench(scale: float = 1.0, seed: int = 0,
                    device=None) -> Dict[str, Dict]:
    s = lambda v: max(int(v * scale), 1)  # noqa: E731
    return {
        "word2vec": bench_word2vec(vocab=s(100_000), dim=s(512),
                                   batch=s(65536), seed=seed,
                                   device=device),
        "lstm": bench_lstm(hidden=s(1024), inp=s(1024), batch=s(1024),
                           block=min(s(512), 512), seed=seed,
                           device=device),
        "text_classifier": bench_text_classifier(
            vocab=s(50_000), dim=s(512), labels=max(s(16), 2),
            batch=s(16384), seed=seed, device=device),
    }
