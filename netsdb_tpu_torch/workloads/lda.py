"""Latent Dirichlet Allocation — counterpart of
``netsdb_tpu/workloads/lda.py`` (reference ``LDA*`` UDFs,
``TestLDA.cc``): batch EM over a dense (docs x vocab) count matrix, the
E and M steps fused so the (docs, k, vocab) responsibility cube is never
formed.

The initial θ and φ are Dirichlet(1) rows: Exp(1) = Gamma(1) draws from
a ``torch.Generator`` seeded by ``seed`` on the counts' device,
normalised; the reference's ``jax.random.dirichlet`` cannot be
reproduced. Pass ``init=`` for an exact start.

EM runs over row blocks of the counts (:func:`lda_em_blocks`): one block
on one device, or a row-sharded placed set's blocks (documents), one a
position, each with its documents' rows of θ. The doc-topic update is
per block; the topic-word counts are partial sums, summed in position
order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.common import full_f32_precision
from netsdb_tpu_torch.parallel import placed_ops
from netsdb_tpu_torch.parallel.mesh import move, position_sum
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
    return _draw_init(*counts.shape, k, seed, counts.dtype, counts.device)


def _draw_init(docs: int, vocab: int, k: int, seed: int, dtype,
               device) -> LDAState:
    g = torch.Generator(device=device).manual_seed(seed)
    theta = _dirichlet_rows(docs, k, g, dtype, device)
    phi = _dirichlet_rows(k, vocab, g, dtype, device)
    return LDAState(theta, phi)


def _step_blocks(blocks: Sequence[torch.Tensor],
                 thetas: Sequence[torch.Tensor], phi: torch.Tensor,
                 alpha: float, beta: float
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One fused E+M round over row blocks of the counts and their rows
    of θ: with resp[d,t,w] = θ[d,t]φ[t,w]/norm[d,w], the doc-topic counts
    are θ ⊙ (counts/norm @ φᵀ) (per block) and the topic-word counts
    φ ⊙ (θᵀ @ counts/norm) (partials summed in block order)."""
    full_f32_precision()
    new_thetas, partial = [], []
    for counts, theta in zip(blocks, thetas):
        ph = move(phi, counts.device)
        ratio = counts / (theta @ ph).clamp_min_(1e-12)
        dt = theta * (ratio @ ph.T) + alpha
        new_thetas.append(dt / dt.sum(1, keepdim=True))
        partial.append(theta.T @ ratio)
    tw = phi * position_sum(partial, phi.device) + beta
    return new_thetas, tw / tw.sum(1, keepdim=True)


def lda_step(counts: torch.Tensor, state: LDAState, alpha: float = 0.1,
             beta: float = 0.01) -> LDAState:
    """One fused E+M round (see :func:`_step_blocks`)."""
    thetas, phi = _step_blocks([counts], [state.doc_topic],
                               state.topic_word, alpha, beta)
    return LDAState(thetas[0], phi)


def lda_em(counts: torch.Tensor, k: int, iters: int = 50,
           alpha: float = 0.1, beta: float = 0.01, seed: int = 0,
           init: Optional[LDAState] = None) -> LDAState:
    """``counts``: (docs x vocab) word counts → fitted θ, φ."""
    return lda_em_blocks([counts], k, iters, alpha, beta, seed, init)


def lda_em_blocks(blocks: Sequence[torch.Tensor], k: int, iters: int = 50,
                  alpha: float = 0.1, beta: float = 0.01, seed: int = 0,
                  init: Optional[LDAState] = None) -> LDAState:
    """:func:`lda_em` over row blocks of the counts (documents), each on
    its own device: the initial θ is drawn whole on the first block's
    device (the same draws however the counts are split) and its rows
    go with their block's; the fitted θ comes back in block order on
    that device, with φ."""
    blocks = list(blocks)
    dev, dtype = blocks[0].device, blocks[0].dtype
    if init is None:
        init = _draw_init(sum(b.shape[0] for b in blocks),
                          blocks[0].shape[1], k, seed, dtype, dev)
    theta = init.doc_topic.to(device=dev, dtype=dtype)
    phi = init.topic_word.to(device=dev, dtype=dtype)
    sizes = [b.shape[0] for b in blocks]
    thetas = [move(t, b.device) for t, b in zip(
        torch.split(theta, sizes), blocks)] if len(blocks) > 1 else [theta]
    for _ in range(iters):
        thetas, phi = _step_blocks(blocks, thetas, phi, alpha, beta)
    theta = thetas[0] if len(thetas) == 1 else torch.cat(
        [move(t, dev) for t in thetas])
    return LDAState(theta, phi)


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
    written back as a tensor set of the same block shape. A row-sharded
    placed set runs EM over its positions' documents."""
    counts = client.get_tensor(db, set_name)
    state = lda_em_blocks(placed_ops.row_blocks(counts, "lda_on_set"), k,
                          iters, alpha, beta, seed)
    if not client.set_exists(db, out_set):
        client.create_set(db, out_set)
    client.store.put_tensor(SetIdentifier(db, out_set),
                            BlockedTensor.from_dense(
                                state.topic_word, counts.meta.block_shape))
    return state
