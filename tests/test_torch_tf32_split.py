"""The numerics that the CUDA fold's float32 route rests on.

``netsdb_tpu_torch/csrc/flash_fold_mma.cuh`` runs float32 attention on
the tensor cores as three-pass TF32: x = hi + lo with hi = x rounded to
tf32 and lo = x - hi (read as tf32), a·b ≈ lo·hi + hi·lo + hi·hi summed in
float32. This module emulates that fold on the CPU, with tf32 rounding
done by masking the mantissa, and holds it against a float64 oracle: the
three-pass fold must be about as accurate as a plain float32 fold (the
reference asks for ``Precision.HIGHEST``), while a one-pass TF32 fold is
not. The kernel's own check against float64 runs on the card
(``chip_smoke.py`` phase 2).
"""

import numpy as np
import pytest

LOG2E = 1.4426950408889634
NEG_INF = -1e30
TILE = 64           # the kernel's key tile
THREE_PASS_RATIO = 4.0   # three-pass error over plain f32 error, at most
ONE_PASS_FLOOR = 1e-4    # one pass misses chip_smoke.py's F32_TOL


def tf32_round(x: np.ndarray) -> np.ndarray:
    """Round float32 to tf32 (10 mantissa bits), to nearest with ties
    away from zero: the kernel's split and ``cvt.rna.tf32.f32``."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_truncate(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads from a float32 register given as tf32:
    the low 13 mantissa bits dropped."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def product(a: np.ndarray, b: np.ndarray, mode: str) -> np.ndarray:
    """a @ b in float32, with the operands as the chosen route reads them."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    if mode == "f32":
        return a @ b
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if mode == "tf32x1":
        return a_hi @ b_hi
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def fold(q, k, v, causal: bool, mode: str) -> np.ndarray:
    """The kernel's fold: q pre-scaled by scale·log2 e, 64-key tiles, an
    f32 online-softmax carry (m, l, acc) in the exp2 domain."""
    bh, s, d = q.shape
    qs = (q * np.float32(d ** -0.5 * LOG2E)).astype(np.float32)
    m = np.full((bh, s, 1), NEG_INF, np.float32)
    l = np.zeros((bh, s, 1), np.float32)
    acc = np.zeros((bh, s, d), np.float32)
    rows = np.arange(s)[:, None]
    for k0 in range(0, s, TILE):
        logits = np.stack([product(qs[i], k[i, k0:k0 + TILE].T, mode)
                           for i in range(bh)])
        live = rows >= k0 + np.arange(TILE)[None, :] if causal else None
        if causal:
            logits = np.where(live, logits, np.float32(NEG_INF))
        m_new = np.maximum(m, logits.max(-1, keepdims=True))
        p = np.exp2(logits - m_new).astype(np.float32)
        if causal:
            p = np.where(live, p, np.float32(0))
        corr = np.exp2(m - m_new).astype(np.float32)
        l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
        pv = np.stack([product(p[i], v[i, k0:k0 + TILE], mode)
                       for i in range(bh)])
        acc = (acc * corr + pv).astype(np.float32)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))


def oracle(q, k, v, causal: bool) -> np.ndarray:
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    logits = q @ k.transpose(0, 2, 1) * q.shape[-1] ** -0.5
    if causal:
        s = q.shape[1]
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)) @ v


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((2, 512, 128), dtype=np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("causal", [True, False])
def test_three_pass_tf32_is_as_accurate_as_f32(qkv, causal):
    exact = oracle(*qkv, causal)
    err = {mode: np.abs(fold(*qkv, causal, mode) - exact).max()
           for mode in ("f32", "tf32x3", "tf32x1")}
    assert err["tf32x3"] <= THREE_PASS_RATIO * err["f32"], err
    assert err["tf32x1"] > ONE_PASS_FLOOR, err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_is_exact_and_tf32(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    hi = tf32_round(x)
    lo = x - hi
    assert np.array_equal(hi + lo, x)  # the split loses nothing
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    # hi is the nearest tf32 value: |lo| is at most half a tf32 ulp
    ulp = np.spacing(np.abs(hi)) * 2.0 ** 13
    assert (np.abs(lo) <= ulp / 2).all()
    # lo read as tf32 keeps x to 2^-22 of its size
    err = np.abs(hi + tf32_truncate(lo) - x)
    assert (err <= np.abs(x) * 2.0 ** -21).all()
