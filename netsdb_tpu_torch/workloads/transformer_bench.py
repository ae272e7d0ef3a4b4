"""Long-context transformer-layer benchmark — the port's
``netsdb_tpu/workloads/transformer_bench.py``: the in-database modern
model, end to end.

Weights live in database sets (``models.transformer.
TransformerLayerModel``), the attention core is the hand-written flash
kernel (B1), and the whole layer (LN → QKV → flash attention →
out-proj → MLP) runs in bf16. Reports tokens/s and the layer's achieved
TFLOP/s at long sequences, and ``calls``: the layer forwards its timing
loops ran (one B1 launch each on the card).
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


def layer_flops(batch: int, seq: int, embed: int, heads: int,
                causal: bool = True) -> float:
    """Matmul FLOPs of one layer forward: QKV (2*B*S*E*3E) + attention
    (2*2*B*H*S*S*D, halved causal) + out (2*B*S*E*E) + MLP
    (2*2*B*S*E*4E)."""
    d = embed // heads
    attn = 2 * 2 * batch * heads * seq * seq * d * (0.5 if causal else 1)
    proj = 2 * batch * seq * embed * (3 * embed + embed)
    mlp = 2 * 2 * batch * seq * embed * 4 * embed
    return attn + proj + mlp


def layer_model(embed: int = 1024, heads: int = 8, seed: int = 0,
                device=None) -> Tuple[object, object, torch.device]:
    """The bench's layer: random weights from ``seed`` written to a
    database set and read back, cast to bf16. Returns (model, params,
    device)."""
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    if embed % heads:
        raise ValueError(f"embed {embed} not divisible by heads {heads}")
    root = tempfile.mkdtemp(prefix="tfb_")
    try:
        client = Client(Configuration(root_dir=root), device=device)
        model = TransformerLayerModel(db="tfb", num_heads=heads)
        model.setup(client)
        model.load_random_weights(client, embed=embed, seed=seed)
        params = model.params_from_store(client)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dev = client.device
    params = type(params)(**{f.name: getattr(params, f.name).to(
        torch.bfloat16) for f in dataclasses.fields(params)})
    return model, params, dev


def layer_inputs(seq_lens: Sequence[int], batch: int, embed: int,
                 seed: int, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """The bench's bf16 layer inputs (batch, seq, embed) at each length,
    in order, drawn from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    for s in seq_lens:
        yield s, torch.from_numpy(rng.standard_normal(
            (batch, s, embed)).astype(np.float32)).to(device, torch.bfloat16)


def bench_transformer_layer(seq_lens: Sequence[int] = (4096, 8192),
                            batch: int = 2, embed: int = 1024,
                            heads: int = 8, seed: int = 0, device=None,
                            **timing) -> Dict[str, Dict]:
    """Set-backed layer forward at long sequences, bf16 compute, timed
    by the slope protocol (``timing`` passes to ``scan_slope_seconds``)."""
    from netsdb_tpu_torch.utils.timing import scan_slope_seconds

    model, params, dev = layer_model(embed, heads, seed, device)
    out: Dict[str, Dict] = {}
    for s, x in layer_inputs(seq_lens, batch, embed, seed, dev):
        calls = [0]

        def run(n: int, x=x) -> None:
            with torch.inference_mode():
                for _ in range(n):
                    model.forward(params, x)
            calls[0] += n

        res = scan_slope_seconds(run, lo=2, hi=8, device=dev, **timing)
        dt = res["seconds_per_iter"]
        if dt is None:
            out[f"seq_{s}"] = {"below_device_noise": True,
                               "calls": calls[0]}
            continue
        fl = layer_flops(batch, s, embed, heads)
        out[f"seq_{s}"] = {
            "ms": round(dt * 1e3, 3),
            "tokens_per_sec": round(batch * s / dt, 1),
            "tflops": round(fl / dt / 1e12, 1),
            "calls": calls[0],
        }
    return out
