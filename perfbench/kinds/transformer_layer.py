"""The pre-LN transformer layer the database serves, as GPT-2's block.

x (batch, seq, E) → x1 = x + MHA(LN(x)), out = x1 + MLP(LN(x1)), with
E = ``n_embd``. LN has no affine terms (eps ``layer_norm_epsilon``,
population variance); MHA projects with w_qkv (E × 3E) split into q, k,
v thirds, each (B, S, H, D) with H = ``n_head``, runs causal softmax
attention scaled by D^-1/2 and projects with w_out (E × E); the MLP is
w_up (E × I), tanh-approximated GELU (GPT-2's ``gelu_new``), w_down
(I × E), where I = ``n_inner``, or 4E where that is null. No biases.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench import arithmetic
from perfbench.kinds import precision

UNIT = "tokens"
WEIGHTS = ("w_qkv", "w_out", "w_up", "w_down")


def inner(config: dict) -> int:
    """The MLP's width: ``n_inner``, or 4 × ``n_embd`` where it is null."""
    return config.get("n_inner") or 4 * config["n_embd"]


def make_data(config: dict, shape: dict, input_sets: int, seed: int,
              device) -> Dict[str, object]:
    """Weights scaled by E^-1/2 and ``input_sets`` activation batches
    (batch, seq, E) of standard normals, drawn on ``device`` from one
    generator seeded with ``seed``, in a fixed order, in float32."""
    e, i = config["n_embd"], inner(config)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=g, device=device,
                           dtype=torch.float32)

    weights = {name: randn(*dims) * e ** -0.5 for name, dims in
               (("w_qkv", (e, 3 * e)), ("w_out", (e, e)),
                ("w_up", (e, i)), ("w_down", (i, e)))}
    inputs = [randn(shape["batch"], shape["seq"], e)
              for _ in range(input_sets)]
    return {"weights": weights, "inputs": inputs}


def units_per_request(shape: dict) -> int:
    return int(shape["batch"]) * int(shape["seq"])


def flops_per_request(config: dict, shape: dict) -> float:
    return arithmetic.layer_flops(shape["batch"], shape["seq"],
                                  config["n_embd"], config["n_head"],
                                  config["causal"], inner(config))


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def reference(config: dict, weights: Dict[str, torch.Tensor],
              x: torch.Tensor, mode: str = "f64",
              block_rows: int = 2048) -> torch.Tensor:
    """The layer over ``x`` in ``mode``, a block of query rows at a time
    (keys and values of the whole sequence first): (batch, seq, E),
    float64 for ``"f64"`` and float32 otherwise."""
    heads, causal = config["n_head"], config["causal"]
    eps = config["layer_norm_epsilon"]
    dt = precision.dtype_of(mode)
    w_qkv, w_out, w_up, w_down = (weights[k].to(dt) for k in WEIGHTS)
    b, s, e = x.shape
    d = e // heads
    scale = d ** -0.5
    out = torch.empty((b, s, e), dtype=dt, device=x.device)
    with precision.products(mode), torch.no_grad():
        for bi in range(b):
            xb = x[bi].to(dt)
            # keys and values of every position: (H, S, D) each
            kv = precision.mm(_ln(xb, eps), w_qkv[:, e:], mode)
            k = kv[:, :e].reshape(s, heads, d).transpose(0, 1)
            v = kv[:, e:].reshape(s, heads, d).transpose(0, 1)
            for start in range(0, s, block_rows):
                stop = min(start + block_rows, s)
                xr = xb[start:stop]
                q = precision.mm(_ln(xr, eps), w_qkv[:, :e], mode)
                q = q.reshape(stop - start, heads, d).transpose(0, 1)
                keys = stop if causal else s
                scores = torch.stack(
                    [precision.mm(q[h], k[h, :keys].t(), mode)
                     for h in range(heads)]) * scale
                if causal:
                    qpos = torch.arange(start, stop, device=x.device)
                    kpos = torch.arange(keys, device=x.device)
                    scores = scores.masked_fill(
                        kpos[None, None, :] > qpos[None, :, None],
                        float("-inf"))
                p = torch.softmax(scores, dim=-1)
                del scores
                o = torch.stack([precision.mm(p[h], v[h, :keys], mode)
                                 for h in range(heads)])
                del p
                o = o.transpose(0, 1).reshape(stop - start, e)
                x1 = xr + precision.mm(o, w_out, mode)
                hid = F.gelu(precision.mm(_ln(x1, eps), w_up, mode),
                             approximate="tanh")
                out[bi, start:stop] = x1 + precision.mm(hid, w_down, mode)
    return out
