"""How the CUDA fold's wrappers hand operands to the kernel, on the CPU.

The kernels load q (and, in bfloat16, k and v) with TMA, which takes
rows of whole 16 bytes from 16-byte-aligned bases: ``tma_operand`` passes
such a tensor through and copies any other, zero-padded to
``tma_pitch``. Float32 k and v are split into a scratch of
``split_scratch_bytes`` that the wrapper allocates. These are plain
functions on tensors; the kernels themselves run on the card
(``chip_smoke.py`` phase 2 holds them at the edge shapes)."""

import pytest
import torch

from netsdb_tpu_torch.ops.cuda_kernels import (_kernel_operands,
                                               split_scratch_bytes,
                                               tma_operand, tma_pitch)


@pytest.mark.parametrize("d, itemsize, pitch", [
    (128, 4, 128), (128, 2, 128), (64, 2, 64),
    (40, 4, 40), (40, 2, 40),       # 160 and 80 bytes: whole
    (18, 4, 20), (18, 2, 24),       # 72 and 36 bytes: padded
    (1, 4, 4), (1, 2, 8),
])
def test_pitch_is_whole_16_bytes(d, itemsize, pitch):
    assert tma_pitch(d, itemsize) == pitch
    assert pitch * itemsize % 16 == 0 and pitch - d < 16 // itemsize


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operand_with_whole_rows_passes_through(dtype):
    t = torch.randn(2, 3, 40).to(dtype)
    assert t.data_ptr() % 16 == 0
    assert tma_operand(t) is t


@pytest.mark.parametrize("dtype, pitch", [(torch.float32, 20),
                                          (torch.bfloat16, 24)])
def test_ragged_rows_are_zero_padded(dtype, pitch):
    t = torch.randn(1, 2, 300, 18).to(dtype)
    out = tma_operand(t)
    assert out.shape == (1, 2, 300, pitch) and out.dtype == dtype
    assert torch.equal(out[..., :18], t)
    assert not out[..., 18:].any()
    assert out.data_ptr() % 16 == 0


def test_misaligned_base_is_copied_at_the_same_pitch():
    base = torch.zeros(1 + 2 * 3 * 16)
    t = base[1:].view(2, 3, 16)  # contiguous, 4 bytes past a boundary
    t.copy_(torch.randn(2, 3, 16))
    assert t.data_ptr() % 16 == 4
    out = tma_operand(t)
    assert out.shape == t.shape and out.data_ptr() % 16 == 0
    assert torch.equal(out, t)


@pytest.mark.parametrize("bh, s_k, d, nbytes", [
    # the layer's shape: K and V^T, each as hi and lo, 134 MB
    (16, 4096, 128, 4 * 2 * 16 * (4096 * 128 + 128 * 4096)),
    # d and s_k rounded up to 8: K (300, 24), V^T (24, 304)
    (2, 300, 18, 4 * 2 * 2 * (300 * 24 + 24 * 304)),
    (1, 1, 1, 4 * 2 * (1 * 8 + 8 * 8)),
])
def test_scratch_holds_the_split_of_k_and_v(bh, s_k, d, nbytes):
    assert split_scratch_bytes(bh, s_k, d) == nbytes
    assert nbytes >= 2 * 2 * bh * s_k * d * 4  # hi and lo of k and of v


def test_kernel_operands_bf16_pads_all_and_needs_no_scratch():
    q, k, v = (torch.randn(1, 2, 300, 18).to(torch.bfloat16)
               for _ in range(3))
    qt, kt, vt, scratch = _kernel_operands(q, k, v)
    assert scratch.numel() == 0
    for got, want in ((qt, q), (kt, k), (vt, v)):
        assert got.shape[-1] == 24 and torch.equal(got[..., :18], want)


def test_kernel_operands_f32_splits_k_and_v_into_scratch():
    q, k, v = (torch.randn(1, 2, 300, 18) for _ in range(3))
    qt, kt, vt, scratch = _kernel_operands(q, k, v)
    assert qt.shape[-1] == 20 and kt is k and vt is v
    assert scratch.dtype == torch.uint8
    assert scratch.numel() == split_scratch_bytes(2, 300, 18)
