"""Conv2D model serving — both reference modes as database workloads;
counterpart of ``netsdb_tpu/models/conv2d.py``.

Mode "direct" mirrors ``src/conv2d_proj`` (test program
``src/tests/source/Conv2dProjTest.cc``): image tensors in a set, one
selection applying the conv per tensor. Mode "im2col" mirrors
``src/conv2d_memory_fusion`` (test program
``PipelinedConv2dMemFuseTest.cc:137-299``): patches, one product, fold
back to images. Reference default shapes: 112x112x3
images, 64 7x7x3 filters (``model-inference/convolutional-neural-network/
README.md:8-16``).

Every set is created ``type_name="tensor4d"``: it scans as its list of
image tensors even when it holds one, so ``inference`` returns one
output tensor per stored image tensor, and an empty ``bias`` set means
no bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

from netsdb_tpu_torch.models._common import as_f32, create_sets
from netsdb_tpu_torch.ops import conv as conv_ops
from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet


class Conv2DModel:
    SETS = ("images", "kernels", "bias", "output")

    def __init__(self, db: str = "conv", mode: str = "direct",
                 stride: Tuple[int, int] = (1, 1), padding="VALID",
                 activation: Optional[str] = None,
                 block: Tuple[int, int] = (256, 256),
                 compute_dtype: Optional[str] = None):
        if mode not in ("direct", "im2col"):
            raise ValueError(f"unknown conv mode {mode!r}")
        self.db = db
        self.mode = mode
        self.stride = stride
        self.padding = padding
        self.activation = activation
        self.block = block
        self.compute_dtype = compute_dtype

    def setup(self, client) -> None:
        create_sets(client, self.db, self.SETS, type_name="tensor4d")

    def load(self, client, images, kernels, bias=None) -> None:
        """images (N,C,H,W); kernels (O,I,KH,KW); bias (O,). Each is one
        item of its set (reference ``TensorData``,
        ``src/conv2d_proj/headers/TensorData.h``)."""
        client.send_data(self.db, "images", [as_f32(images)])
        client.send_data(self.db, "kernels", [as_f32(kernels)])
        if bias is not None:
            client.send_data(self.db, "bias", [as_f32(bias)])

    def _conv(self, images, kernels):
        kw = dict(stride=self.stride, padding=self.padding,
                  compute_dtype=self.compute_dtype)
        if self.mode == "direct":
            return conv_ops.conv2d_direct(images, kernels, **kw)
        return conv_ops.conv2d_im2col(images, kernels, block_shape=self.block,
                                      **kw)

    def build_inference_dag(self) -> WriteSet:
        images = ScanSet(self.db, "images")
        kernels = ScanSet(self.db, "kernels")
        bias = ScanSet(self.db, "bias")

        def apply_conv(img_items, ker_items):
            # conv only; bias + activation joined in downstream
            return [self._conv(img, ker_items[0]) for img in img_items]

        def bias_act(conv_items, bias_items):
            b = bias_items[0] if bias_items else None
            return [conv_ops.activate(
                c if b is None else c + b.reshape(1, -1, 1, 1),
                self.activation) for c in conv_items]

        conv = Join(images, kernels, fn=apply_conv,
                    label="Conv2DSelect" if self.mode == "direct"
                    else "ConvMemoryFusion")
        out = Join(conv, bias, fn=bias_act, label="KernelBiasJoin")
        return WriteSet(out, self.db, "output")

    def inference(self, client):
        """Run the conv over every image tensor in the images set; returns
        the list of output tensors."""
        res = client.execute_computations(self.build_inference_dag(),
                                          job_name=f"{self.db}-{self.mode}")
        return next(iter(res.values()))
