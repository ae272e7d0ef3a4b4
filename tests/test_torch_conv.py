"""Conv2D, both modes, through the port's database path against the JAX
package's, on the CPU: the same numpy images, filters and bias, drawn
from a seed, go into a JAX ``Client`` and a port ``Client(device="cpu")``
and through both packages' ``ops.conv``. f32 agrees within 1e-4 abs
(outputs of about 5 in magnitude, summation orders differ); bf16 within
one bf16 rounding of the output (the port's conv returns bf16 that is
then widened, the JAX package's accumulates into f32). SAME under
stride 2 pads asymmetrically; the port pads with ``F.pad`` first."""

import numpy as np
import pytest
import torch

from netsdb_tpu.models.conv2d import Conv2DModel as JaxConv
from netsdb_tpu.ops import conv as jconv
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models import Conv2DModel
from netsdb_tpu_torch.ops import conv as pconv
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.weights import conv_arrays_to_device

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-2)
# name → (stride, padding): VALID; SAME at stride 2 on an odd and an even
# size (asymmetric pads); an explicit (before, after) pad, as the
# reference takes it for both spatial dims
PADS = {"valid": ((1, 1), "VALID"),
        "same_s2": ((2, 2), "SAME"),
        "explicit": ((1, 2), (1, 2))}
# (bias?, activation)
EPILOGUES = {"bias_relu": (True, "relu"), "sigmoid": (False, "sigmoid"),
             "bias": (True, None)}


@pytest.fixture()
def port_client(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def draw(seed, n=2, c=3, h=13, w=10, o=4, k=(3, 5)):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, c, h, w)).astype(np.float32)
    kernels = rng.standard_normal((o, c) + k).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return images, kernels, bias


@pytest.mark.parametrize("args", [("SAME", 7, 112, 2), ("SAME", 7, 13, 2),
                                  ("SAME", 3, 10, 1), ("SAME", 5, 3, 4),
                                  ("VALID", 7, 112, 1),
                                  ((2, 1), 3, 9, 2)])
def test_pad_pair_matches_jax(args):
    assert pconv._pad_pair(*args) == jconv._pad_pair(*args)


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("pad", sorted(PADS))
@pytest.mark.parametrize("mode", ["direct", "im2col"])
def test_conv_ops_match_jax(mode, pad, epilogue):
    images, kernels, bias = draw(1)
    stride, padding = PADS[pad]
    with_bias, act = EPILOGUES[epilogue]
    kw = dict(stride=stride, padding=padding, activation=act)
    jfn, pfn = ((jconv.conv2d_direct, pconv.conv2d_direct)
                if mode == "direct"
                else (jconv.conv2d_im2col, pconv.conv2d_im2col))
    ref = np.asarray(jfn(images, kernels, bias if with_bias else None, **kw))
    x, k, b = conv_arrays_to_device(images, kernels,
                                    bias if with_bias else None,
                                    device="cpu")
    got = pfn(x, k, b, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("pad", sorted(PADS))
def test_im2col_matches_jax(pad):
    images, _, _ = draw(2)
    stride, padding = PADS[pad]
    mat, (oh, ow) = pconv.im2col(torch.as_tensor(images), 3, 5, stride,
                                 padding)
    jmat, (joh, jow) = jconv.im2col(images, 3, 5, stride, padding)
    assert (oh, ow) == (joh, jow)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))


@pytest.mark.parametrize("mode", ["direct", "im2col"])
def test_conv_bf16_matches_jax(mode):
    images, kernels, bias = draw(3)
    kw = dict(stride=(2, 2), padding="SAME", activation="relu",
              compute_dtype="bfloat16")
    jfn, pfn = ((jconv.conv2d_direct, pconv.conv2d_direct)
                if mode == "direct"
                else (jconv.conv2d_im2col, pconv.conv2d_im2col))
    ref = np.asarray(jfn(images, kernels, bias, **kw))
    got = pfn(*conv_arrays_to_device(images, kernels, bias, device="cpu"),
              **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **BF16_TOL)


# --- the model through the database ---------------------------------------
def models(mode, **kw):
    return (JaxConv(db=f"conv_{mode}", mode=mode, block=(16, 16), **kw),
            Conv2DModel(db=f"conv_{mode}", mode=mode, block=(16, 16), **kw))


# name → (PADS entry, bias?, activation, compute_dtype)
MODEL_CASES = {"valid_relu": ("valid", True, "relu", None),
               "same_s2_sigmoid_no_bias": ("same_s2", False, "sigmoid", None),
               "explicit_bias": ("explicit", True, None, None),
               "bf16_same_s2_relu": ("same_s2", True, "relu", "bfloat16")}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
@pytest.mark.parametrize("mode", ["direct", "im2col"])
def test_model_inference_matches_jax(client, port_client, mode, case):
    """One image tensor in the set: the scan is a one-item list and so is
    the output, in both packages. No bias means an empty bias set."""
    pad, with_bias, act, cd = MODEL_CASES[case]
    stride, padding = PADS[pad]
    images, kernels, bias = draw(4)
    jm, pm = models(mode, stride=stride, padding=padding, activation=act,
                    compute_dtype=cd)
    for m, c in ((jm, client), (pm, port_client)):
        m.setup(c)
        m.load(c, images, kernels, bias if with_bias else None)
    out = pm.inference(port_client)
    ref = jm.inference(client)
    assert isinstance(out, list) and len(out) == len(ref) == 1
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               **(TOL if cd is None else BF16_TOL))
    # the output set holds one item per image tensor
    stored = port_client.store.get_items(SetIdentifier(pm.db, "output"))
    assert len(stored) == 1 and stored[0] is out[0]


@pytest.mark.parametrize("mode", ["direct", "im2col"])
def test_multiple_image_tensors_of_different_sizes(client, port_client,
                                                   mode):
    """tests/test_models.py:133-144 in both packages: two image tensors
    of other sizes give two outputs of their own sizes."""
    rng = np.random.default_rng(5)
    ker = rng.standard_normal((2, 1, 3, 3)).astype(np.float32)
    i1 = rng.standard_normal((1, 1, 6, 6)).astype(np.float32)
    i2 = rng.standard_normal((1, 1, 8, 8)).astype(np.float32)
    outs = []
    for m, c in zip(models(mode), (client, port_client)):
        m.setup(c)
        c.send_data(m.db, "images", [i1, i2])
        c.send_data(m.db, "kernels", [ker])
        outs.append(m.inference(c))
    ref, out = outs
    assert [tuple(o.shape) for o in out] == [(1, 2, 4, 4), (1, 2, 6, 6)]
    for ours, theirs in zip(out, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_model_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        Conv2DModel(mode="winograd")


def test_conv_arrays_to_device_keeps_bias_none():
    images, kernels, _ = draw(6)
    x, k, b = conv_arrays_to_device(images.astype(np.float64), kernels,
                                    device="cpu")
    assert x.dtype == k.dtype == torch.float32 and b is None
    images[0, 0, 0, 0] = 99.0  # the tensors own their memory
    assert x[0, 0, 0, 0].item() != 99.0
