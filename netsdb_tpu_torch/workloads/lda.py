"""Latent Dirichlet Allocation — counterpart of
``netsdb_tpu/workloads/lda.py`` (reference ``LDA*`` UDFs,
``TestLDA.cc``): batch EM over a dense (docs x vocab) count matrix, the
E and M steps fused so the (docs, k, vocab) responsibility cube is never
formed.

The initial θ and φ are Dirichlet(1) rows: Exp(1) = Gamma(1) draws from
a ``torch.Generator`` seeded by ``seed`` on the counts' device,
normalised; the reference's ``jax.random.dirichlet`` cannot be
reproduced. Pass ``init=`` for an exact start.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from netsdb_tpu_torch.parallel.placement import refuse_placed
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.storage.store import SetIdentifier


class LDAState(NamedTuple):
    doc_topic: torch.Tensor   # (docs, k) θ
    topic_word: torch.Tensor  # (k, vocab) φ


def _dirichlet_rows(rows: int, cols: int, g: torch.Generator, dtype,
                    device) -> torch.Tensor:
    x = torch.empty((rows, cols), dtype=dtype, device=device)
    x.exponential_(1.0, generator=g)
    return x / x.sum(1, keepdim=True)


def lda_init(counts: torch.Tensor, k: int, seed: int = 0) -> LDAState:
    """θ (docs x k) and φ (k x vocab), Dirichlet(1) rows drawn from one
    generator on the counts' device (θ first)."""
    docs, vocab = counts.shape
    g = torch.Generator(device=counts.device).manual_seed(seed)
    theta = _dirichlet_rows(docs, k, g, counts.dtype, counts.device)
    phi = _dirichlet_rows(k, vocab, g, counts.dtype, counts.device)
    return LDAState(theta, phi)


def lda_step(counts: torch.Tensor, state: LDAState, alpha: float = 0.1,
             beta: float = 0.01) -> LDAState:
    """One fused E+M round: with resp[d,t,w] = θ[d,t]φ[t,w]/norm[d,w],
    the doc-topic counts are θ ⊙ (counts/norm @ φᵀ) and the topic-word
    counts φ ⊙ (θᵀ @ counts/norm)."""
    theta, phi = state
    full_f32_precision()
    ratio = counts / (theta @ phi).clamp_min_(1e-12)
    dt = theta * (ratio @ phi.T) + alpha
    tw = phi * (theta.T @ ratio) + beta
    return LDAState(dt / dt.sum(1, keepdim=True),
                    tw / tw.sum(1, keepdim=True))


def lda_em(counts: torch.Tensor, k: int, iters: int = 50,
           alpha: float = 0.1, beta: float = 0.01, seed: int = 0,
           init: Optional[LDAState] = None) -> LDAState:
    """``counts``: (docs x vocab) word counts → fitted θ, φ."""
    state = init if init is not None else lda_init(counts, k, seed)
    state = LDAState(*(t.to(device=counts.device, dtype=counts.dtype)
                       for t in state))
    for _ in range(iters):
        state = lda_step(counts, state, alpha, beta)
    return state


def lda_perplexity(counts: torch.Tensor, state: LDAState) -> torch.Tensor:
    full_f32_precision()
    # in place: at full size each (docs x vocab) temporary is GBs
    ll = torch.sum((state.doc_topic @ state.topic_word).clamp_min_(1e-12)
                   .log_().mul_(counts))
    return torch.exp(-ll / counts.sum().clamp_min(1.0))


def lda_on_set(client, db: str, set_name: str, k: int, iters: int = 50,
               alpha: float = 0.1, beta: float = 0.01,
               out_set: str = "lda_topics", seed: int = 0) -> LDAState:
    """Set driver: the count matrix from a tensor set; φ (topic-word)
    written back as a tensor set of the same block shape."""
    refuse_placed(client, db, set_name, "lda_on_set")
    counts = client.get_tensor(db, set_name)
    state = lda_em(counts.to_dense(), k, iters, alpha, beta, seed=seed)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set)
    client.store.put_tensor(SetIdentifier(db, out_set),
                            BlockedTensor.from_dense(
                                state.topic_word, counts.meta.block_shape))
    return state
