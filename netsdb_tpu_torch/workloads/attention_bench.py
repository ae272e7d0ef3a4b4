"""Long-context attention benchmark — the port's
``netsdb_tpu/workloads/attention_bench.py``: the hand-written flash
kernel (B1, ``ops.cuda_kernels.flash_attention``) against the naive
softmax (materializes the (S, S) score matrix in device memory,
``ops.attention.attention``), both causal bf16, and the ring step (B2,
``ops.cuda_kernels.flash_attention_step``) chained over k/v chunks.

The reference's yardstick is jax's own TPU flash kernel. The port's is
the library's flash kernel on the card: ``scaled_dot_product_attention``
under the flash backend, reported as ``flash_vs_sdpa`` (> 1 means B1 is
faster). It is timed beside B1 and never computes a result the bench
returns. On the CPU there is no yardstick and no guard, as in the
reference off its TPU.

Timing via ``utils.timing.scan_slope_seconds`` (CUDA events on the
card); reports tokens/s and TFLOP/s (4*S^2*D*B*H matmul FLOPs per
forward, causal-halved). Each kernel entry carries ``calls``: the
wrapper calls its timing loops made, so a caller can hold the kernels'
launch counts against them.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.ops.attention import attention
from netsdb_tpu_torch.ops.cuda_kernels import (NEG_INF, flash_attention,
                                               flash_attention_step)
from netsdb_tpu_torch.utils.timing import scan_slope_seconds


def _sdpa_flash() -> Callable:
    """The library's flash kernel (SDPA restricted to its flash
    backend) — the yardstick only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def run(q, k, v, causal):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    return run


# the guarded claim: B1 must stay within this fraction of the yardstick's
# time at the headline shape (the reference's BASELINE.md ceiling guard)
CEILING_RATIO = 0.92
CEILING_SEQ = 8192


def _time(fn: Callable[[], object], device, lo: int, hi: int,
          **kw) -> Dict[str, object]:
    """Slope timing of ``fn`` with the number of calls made."""
    calls = [0]

    def run(n: int) -> None:
        for _ in range(n):
            fn()
        calls[0] += n

    res = scan_slope_seconds(run, lo=lo, hi=hi, device=device, **kw)
    res["calls"] = calls[0]
    return res


def attention_inputs(seq_lens: Sequence[int], batch: int, heads: int,
                     head_dim: int, seed: int, device
                     ) -> Iterator[Tuple[int, Tuple[torch.Tensor, ...]]]:
    """The bench's causal bf16 q, k, v at each length, in order, drawn
    from one generator seeded with ``seed``: (seq, (q, k, v))."""
    rng = np.random.default_rng(seed)
    for s in seq_lens:
        yield s, tuple(torch.from_numpy(rng.standard_normal(
            (batch, heads, s, head_dim)).astype(np.float32)).to(
                device, torch.bfloat16) for _ in range(3))


def bench_attention(seq_lens: Sequence[int] = (1024, 2048, 4096, 8192),
                    batch: int = 2, heads: int = 8, head_dim: int = 128,
                    seed: int = 0, assert_ceiling: bool = True,
                    device=None, **timing) -> Dict[str, Dict]:
    """Naive against B1 (and the yardstick on the card) at each length.
    Only the naive path may report an error (it cannot hold the (S, S)
    scores at long lengths); a failing B1 raises. ``timing`` passes to
    ``scan_slope_seconds`` (e.g. ``min_delta_seconds``)."""
    dev = resolve_device(device)
    yardstick = _sdpa_flash() if dev.type == "cuda" else None
    out: Dict[str, Dict] = {}
    for s, (q, k, v) in attention_inputs(seq_lens, batch, heads, head_dim,
                                         seed, dev):
        entry: Dict[str, object] = {"batch": batch, "heads": heads,
                                    "head_dim": head_dim}
        # causal: half the S^2 logits are live; 2 matmuls (QK^T, PV)
        flops = 2 * 2 * batch * heads * s * s * head_dim / 2

        kernels = [("naive", attention), ("flash", flash_attention)]
        if yardstick is not None:
            kernels.append(("sdpa_flash", yardstick))
        for name, fn in kernels:
            try:
                res = _time(lambda fn=fn: fn(q, k, v, True), dev, 4, 16,
                            **timing)
            except Exception as e:  # noqa: BLE001 — naive OOMs at long seq
                if name != "naive":
                    raise
                entry[name] = {"error": str(e)[:200]}
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                continue
            if res["below_noise"]:
                entry[name] = {"below_device_noise": True,
                               "calls": res["calls"]}
                continue
            dt = res["seconds_per_iter"]
            entry[name] = {
                "ms": round(dt * 1e3, 3),
                "tokens_per_sec": round(batch * s / dt, 1),
                "tflops": round(flops / dt / 1e12, 1),
                "calls": res["calls"],
            }
        n_ms = entry.get("naive", {}).get("ms")
        f_ms = entry.get("flash", {}).get("ms")
        if n_ms and f_ms:
            entry["flash_speedup"] = round(n_ms / f_ms, 2)
        r_ms = entry.get("sdpa_flash", {}).get("ms")
        if r_ms and f_ms:
            # > 1 means B1 is FASTER than the library's flash kernel
            entry["flash_vs_sdpa"] = round(r_ms / f_ms, 3)
        out[f"seq_{s}"] = entry

    # the ceiling guard: if B1 falls below CEILING_RATIO of the
    # yardstick at the headline shape, the claim is not earned — fail
    # loudly instead of silently re-printing it
    if assert_ceiling and yardstick is not None:
        ratio = out.get(f"seq_{CEILING_SEQ}", {}).get("flash_vs_sdpa")
        if ratio is not None and ratio < CEILING_RATIO:
            raise AssertionError(
                f"flash kernel at seq={CEILING_SEQ} runs at {ratio:.3f}x "
                f"of the library's flash kernel (< {CEILING_RATIO}); the "
                f"attention-ceiling claim must be re-validated")
    return out


def ring_fold(q: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
              n_chunks: int) -> torch.Tensor:
    """The causal worst-case position's ring work: ``n_chunks`` B2 folds
    of ``s_local``-key chunks into one f32 carry, then the finish."""
    bh, s_local, _ = q.shape
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s_local, 1), dtype=torch.float32, device=q.device)
    m = torch.full((bh, s_local, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    for i in range(n_chunks):
        acc, l, m = flash_attention_step(
            q, ks[i], vs[i], acc, l, m,
            q_offset=(n_chunks - 1) * s_local, k_offset=i * s_local)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_inputs(n_chunks: int, s_local: int, batch: int, heads: int,
                head_dim: int, seed: int, device
                ) -> Tuple[torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor]]:
    """The ring-fold bench's bf16 q (batch * heads, s_local, head_dim)
    and its ``n_chunks`` k and v chunks, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    bh = batch * heads

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, torch.bfloat16)

    q = draw((bh, s_local, head_dim))
    ks = [t.contiguous() for t in draw(
        (bh, n_chunks * s_local, head_dim)).split(s_local, dim=1)]
    vs = [t.contiguous() for t in draw(
        (bh, n_chunks * s_local, head_dim)).split(s_local, dim=1)]
    return q, ks, vs


def bench_ring_fold(n_chunks: int = 8, s_local: int = 1024,
                    batch: int = 2, heads: int = 8, head_dim: int = 128,
                    seed: int = 0, device=None,
                    **timing) -> Dict[str, object]:
    """Per-position ring-attention compute: chain ``n_chunks`` B2 folds
    — the causal worst-case position's work at S = n_chunks * s_local
    over n_chunks shards, minus the rotation (one card). Reports the
    actual (un-halved) FLOP throughput; ``calls`` counts B2 calls."""
    dev = resolve_device(device)
    bh = batch * heads
    q, ks, vs = ring_inputs(n_chunks, s_local, batch, heads, head_dim,
                            seed, dev)
    res = _time(lambda: ring_fold(q, ks, vs, n_chunks), dev, 4, 16,
                **timing)
    out: Dict[str, object] = {"n_chunks": n_chunks, "s_local": s_local,
                              "calls": res["calls"] * n_chunks}
    dt: Optional[float] = res["seconds_per_iter"]
    if dt is None:
        out["below_device_noise"] = True
        return out
    flops = n_chunks * 2 * 2 * bh * s_local * s_local * head_dim
    out.update(ms=round(dt * 1e3, 3),
               tflops_actual=round(flops / dt / 1e12, 1))
    return out
