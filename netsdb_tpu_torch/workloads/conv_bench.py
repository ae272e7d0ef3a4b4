"""Conv2D batch-latency benchmark — the port's
``netsdb_tpu/workloads/conv_bench.py`` (BASELINE.md: "conv2d batch
latency p50").

Shapes default to the reference conv2d workload's documented inputs
(112x112x3 images, 64 7x7x3 filters — reference
``model-inference/convolutional-neural-network/README.md:8-16``). The
reference executes this by calling ATen ``at::conv2d`` on the CPU per
image inside a Selection UDF (``src/conv2d_proj/headers/
Conv2DSelect.h:13-216``); the baseline is that op measured on this host,
batched (generous to the reference, whose per-object calls cannot batch).

Both modes of ``ops.conv`` are measured on the client's device: direct
(one convolution) and im2col (patch matrix + blocked product — the
reference's conv2d_memory_fusion rewrite). Device time is the slope
between two loop lengths (``utils.timing.scan_slope_seconds``); p50/p90
are over the slope estimates. Wall p50 of one synchronised call is also
reported, the honest interactive-latency upper bound.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.ops.conv import conv2d_direct, conv2d_im2col
from netsdb_tpu_torch.utils.timing import scan_slope_seconds


def _percentiles(times: Sequence[float]) -> Dict[str, float]:
    arr = np.asarray(sorted(times))
    return {"p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 4),
            "p90_ms": round(float(np.percentile(arr, 90)) * 1e3, 4)}


def torch_cpu_baseline(images: np.ndarray, kernels: np.ndarray,
                       iters: int = 10) -> Dict[str, float]:
    """The reference-equivalent path: ATen conv2d on the host CPU."""
    x = torch.from_numpy(images)
    w = torch.from_numpy(kernels)
    with torch.no_grad():
        torch.conv2d(x, w)  # warm
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            torch.conv2d(x, w)
            times.append(time.perf_counter() - t0)
    return _percentiles(times)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_conv_bench(batch: int = 64, hw: int = 112, cin: int = 3,
                   cout: int = 64, k: int = 7, iters: int = 20,
                   compute_dtype: Optional[str] = None,
                   seed: int = 0, device=None) -> Dict[str, object]:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, cin, hw, hw)).astype(np.float32)
    kernels = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
    xd = torch.from_numpy(images).to(dev)
    wd = torch.from_numpy(kernels).to(dev)

    modes = {
        "direct": lambda a, b: conv2d_direct(
            a, b, compute_dtype=compute_dtype),
        "im2col": lambda a, b: conv2d_im2col(
            a, b, compute_dtype=compute_dtype),
    }
    out: Dict[str, object] = {
        "batch": batch, "hw": hw, "cin": cin, "cout": cout, "k": k,
        "backend": dev.type,
    }
    cpu = torch_cpu_baseline(images, kernels, iters=max(iters // 2, 3))
    out["torch_cpu_reference"] = cpu
    repeats = max(min(iters // 4, 5), 3)
    with torch.inference_mode():
        for name, conv_fn in modes.items():
            def run(n: int, conv_fn=conv_fn) -> None:
                for _ in range(n):
                    conv_fn(xd, wd)

            res = scan_slope_seconds(run, lo=2, hi=8, repeats=repeats,
                                     device=dev)
            conv_fn(xd, wd)  # warm the single-call form
            _sync(dev)
            wall = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                conv_fn(xd, wd)
                _sync(dev)
                wall.append(time.perf_counter() - t0)
            p50_wall = float(np.percentile(np.asarray(sorted(wall)), 50))

            if res["below_noise"]:
                # device time unresolvable even after escalating loop
                # lengths: the wall time is the honest upper bound
                stats = {"p50_ms": round(p50_wall * 1e3, 4),
                         "p90_ms": round(max(wall) * 1e3, 4),
                         "below_device_noise": True}
                p50_dev_ms = p50_wall * 1e3
            else:
                stats = _percentiles([max(s, 0.0) for s in res["slopes"]])
                p50_dev_ms = res["seconds_per_iter"] * 1e3
            stats["p50_wall_ms"] = round(p50_wall * 1e3, 3)
            stats["speedup_vs_torch_cpu_p50"] = round(
                cpu["p50_ms"] / p50_dev_ms, 3)
            out[name] = stats
    return out
