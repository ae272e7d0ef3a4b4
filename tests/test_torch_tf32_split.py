"""The numerics that the CUDA fold's float32 route rests on.

``netsdb_tpu_torch/csrc/flash_fold_wgmma.cuh`` runs float32 attention on
the tensor cores as three-pass TF32: x = hi + lo with hi = x rounded to
tf32 and lo = x - hi (read as tf32), a·b ≈ lo·hi + hi·lo + hi·hi summed in
float32. This module emulates that fold on the CPU, with tf32 rounding
done by masking the mantissa, and holds it against a float64 oracle: the
three-pass fold must be about as accurate as a plain float32 fold (the
reference asks for ``Precision.HIGHEST``), while a one-pass TF32 fold is
not. It also emulates the wgmma route's accumulation (chains of 8-deep
steps summed toward zero, as the tensor core rounds, then added in
float32) at the chain depths around the kernel's, and its V^T split,
whose keys the pre-pass permutes into the A layout P takes from S's
registers. The kernel's own check against float64 runs on the card
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


# ---- the wgmma route: chains rounded toward zero, V^T permuted

TILE_F32 = 32   # the wgmma fold's float32 key tile
KERNEL_CHAIN = 2  # netsdb_fold::kTf32Chain


def rz32(x: np.ndarray) -> np.ndarray:
    """float64 to float32 rounded toward zero, as the tensor core rounds
    the sums it accumulates."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def split(x: np.ndarray):
    """(hi, lo) as the tensor core reads them."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x.astype(np.float32) - hi)


def chained(a, b, chain: int) -> np.ndarray:
    """a (m, K) · b (K, n) from their splits as the wgmma fold forms it:
    three passes per 8-deep step (lo·hi, hi·lo, hi·hi), each adding its
    8 products to the chain's accumulator rounded toward zero; a chain
    of ``chain`` steps starts from zero and is added to the result in
    float32, to nearest. Returns the chains' float32 partial sums."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    steps = a_hi.shape[-1] // 8
    parts = []
    for c0 in range(0, steps, chain):
        acc = np.zeros((a_hi.shape[0], b_hi.shape[1]), np.float32)
        for ks in range(c0, min(c0 + chain, steps)):
            sl = slice(8 * ks, 8 * ks + 8)
            for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                acc = rz32(acc.astype(np.float64)
                           + x[:, sl].astype(np.float64)
                           @ y[sl].astype(np.float64))
        parts.append(acc)
    return parts


def a_layout_keys() -> np.ndarray:
    """Which of S's 8 key columns each of the tf32 A fragment's 8 columns
    holds: a lane holds S's columns 2t, 2t+1 (wgmma's accumulator) and
    gives them as the A fragment's columns t and t+4."""
    keys = np.empty(8, int)
    for t in range(4):
        keys[t], keys[t + 4] = 2 * t, 2 * t + 1
    return keys


def prepass_keys() -> np.ndarray:
    """The key that split_kv_kernel writes at each position of a group of
    8 in V^T: position L < 4 holds key 2L, L >= 4 key 2(L - 4) + 1."""
    pos = np.arange(8)
    return np.where(pos < 4, 2 * pos, 2 * (pos - 4) + 1)


def fold_wgmma(q, k, v, causal: bool, chain: int,
               v_keys: np.ndarray) -> np.ndarray:
    """The wgmma fold's float32 route: 32-key tiles, S's chains added in
    float32, P taken in the A layout's key order and V^T's rows in
    ``v_keys`` order (the pre-pass's), each tile's P·V chains folded in
    as acc = acc·corr + P·V (the first, one rounding) and acc + P·V."""
    bh, s, d = q.shape
    qs = (q * np.float32(d ** -0.5 * LOG2E)).astype(np.float32)
    m = np.full((bh, s, 1), NEG_INF, np.float32)
    l = np.zeros((bh, s, 1), np.float32)
    acc = np.zeros((bh, s, d), np.float32)
    rows = np.arange(s)[:, None]
    group = np.arange(TILE_F32) // 8 * 8
    a_order = group + a_layout_keys()[np.arange(TILE_F32) % 8]
    v_order = group + v_keys[np.arange(TILE_F32) % 8]
    for k0 in range(0, s, TILE_F32):
        logits = np.empty((bh, s, TILE_F32), np.float32)
        for i in range(bh):
            parts = chained(split(qs[i]), split(k[i, k0:k0 + TILE_F32].T),
                            chain)
            logits[i] = parts[0]
            for part in parts[1:]:
                logits[i] = (logits[i] + part).astype(np.float32)
        live = rows >= k0 + np.arange(TILE_F32)[None, :] if causal else None
        if causal:
            logits = np.where(live, logits, np.float32(NEG_INF))
        m_new = np.maximum(m, logits.max(-1, keepdims=True))
        p = np.exp2(logits - m_new).astype(np.float32)
        if causal:
            p = np.where(live, p, np.float32(0))
        corr = np.exp2(m - m_new).astype(np.float32)
        l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
        for i in range(bh):
            vt = v[i, k0:k0 + TILE_F32][v_order]
            parts = chained(split(p[i][:, a_order]), split(vt),
                            min(chain, TILE_F32 // 8))
            acc[i] = (acc[i].astype(np.float64) * corr[i]
                      + parts[0]).astype(np.float32)
            for part in parts[1:]:
                acc[i] = (acc[i] + part).astype(np.float32)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))


@pytest.fixture(scope="module")
def exact(qkv):
    return {causal: oracle(*qkv, causal) for causal in (True, False)}


@pytest.mark.parametrize("chain", [1, KERNEL_CHAIN, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_route_is_as_accurate_as_f32(qkv, exact, causal, chain):
    f32 = np.abs(fold(*qkv, causal, "f32") - exact[causal]).max()
    err = np.abs(fold_wgmma(*qkv, causal, chain, prepass_keys())
                 - exact[causal]).max()
    assert err <= THREE_PASS_RATIO * f32, (err, f32)


@pytest.mark.parametrize("v_keys", ["prepass", "unpermuted"])
def test_vt_split_takes_keys_in_the_a_layout_order(qkv, exact, v_keys):
    # the pre-pass's order is the A fragment's; V^T in plain order pairs
    # each p with another key's v, and the fold comes out wrong
    assert np.array_equal(prepass_keys(), a_layout_keys())
    keys = prepass_keys() if v_keys == "prepass" else np.arange(8)
    f32 = np.abs(fold(*qkv, True, "f32") - exact[True]).max()
    err = np.abs(fold_wgmma(*qkv, True, KERNEL_CHAIN, keys)
                 - exact[True]).max()
    if v_keys == "prepass":
        assert err <= THREE_PASS_RATIO * f32, (err, f32)
    else:
        assert err > ONE_PASS_FLOOR, err
