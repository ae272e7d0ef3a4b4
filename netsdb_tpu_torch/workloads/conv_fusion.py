"""Conv2D memory fusion — counterpart of
``netsdb_tpu/workloads/conv_fusion.py``: the staged relational im2col
rewrite of the reference's ``src/conv2d_memory_fusion``
(``PipelinedConv2dMemFuseTest.cc:137-299``) as four materialised jobs
through ``Client.execute_computations``:

1. ``kernel_bias_join``: Kernel records → ``KernelToChunks`` →
   ``ImageChunksToBlock`` → ``ImageBlockToMatrix`` → ``KernelBiasJoin``
   (the bias in the trailing column) → ``kernel_flat``;
2. ``image_ops``: Image records → ``ImageToChunks`` (im2col rows ending
   in 1.0, so the bias column multiplies through) → the same blocking →
   ``image_flat``;
3. ``conv2d``: ``FFTransposeMult`` ⋈ + ``FFAggMatrix`` Σ as one
   ``matmul_t`` on the client's device → ``result`` (an all-tensor job:
   one compiled program, a CUDA graph on the card);
4. reassembly: ``ConvChunksToImage`` → ``output`` Image records.

The chunk and block plumbing is host work over numpy records, as the
reference's per-tuple lambdas are; each assembled matrix is uploaded
once. Records keep numpy data; the matrices live on the client's
device. With ``setup(placements=...)`` the flattened matrices are stored
placed (``image_flat`` row-sharded, ``kernel_flat`` replicated, as the
reference's test places them): the one ``matmul_t`` program then runs
per position, and the reassembly reads each position's rows to the
host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.ops.matmul import matmul_t
from netsdb_tpu_torch.parallel.placed_ops import host_array
from netsdb_tpu_torch.plan.computations import (
    Aggregate, Apply, Join, MultiApply, ScanSet, WriteSet)


# --- record types (reference headers/Image.h, Kernel.h, ImageChunk.h) ---

@dataclass
class Image:
    """(C, H, W) array with an integer key — reference ``Image.h``."""
    key: int
    data: np.ndarray  # (C, H, W)

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    def window_count(self, k: int, stride: int, padding: int) -> int:
        _, h, w = self.data.shape
        oh = (h + 2 * padding - k) // stride + 1
        ow = (w + 2 * padding - k) // stride + 1
        return oh * ow


@dataclass
class Kernel:
    """One filter (I, KH, KW), key = output channel — ``Kernel.h``."""
    key: int
    data: np.ndarray  # (I, KH, KW)


@dataclass
class Chunk:
    """A block-wide slice of one im2col row — ``ImageChunk.h``."""
    row: int          # global row of the flattened matrix
    y_index: int      # column-block index
    values: np.ndarray  # block_y long (zero-padded tail)


def _row_chunks(row_index: int, values: np.ndarray, block_y: int) -> List[Chunk]:
    n_blocks = -(-len(values) // block_y)
    padded = np.zeros(n_blocks * block_y, np.float32)
    padded[:len(values)] = values
    return [Chunk(row_index, j, padded[j * block_y:(j + 1) * block_y])
            for j in range(n_blocks)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class ConvFusionPipeline:
    """Staged conv2d as relational algebra over the engine. Images (C, H,
    W), kernels (O, I, KH, KW); the flattened width is C*KH*KW + 1 (the
    +1 carries the bias through the product)."""
    db: str = "convfuse"
    kernel_size: int = 7
    stride: int = 1
    padding: int = 0
    block: Tuple[int, int] = (64, 64)
    compute_dtype: Optional[str] = None
    # the device of the client the pipeline was set up on
    device: Optional[torch.device] = field(default=None, repr=False)

    SETS = ("images", "kernels", "bias",
            "kernel_flat", "image_flat", "result", "output")

    # -- setup / load ---------------------------------------------------

    def setup(self, client, placements=None) -> None:
        """``placements``: set name → Placement. The compute-heavy sets
        are ``image_flat`` (windows × flat width: row-shard it) and
        ``kernel_flat`` (replicate it: the broadcast side of the join);
        the record sets are host objects and keep no placement. A set
        created before keeps its placement."""
        self.device = client.device
        client.create_database(self.db)
        for s in self.SETS:
            client.create_set(self.db, s,
                              placement=(placements or {}).get(s))

    def load(self, client, images: np.ndarray, kernels: np.ndarray,
             bias: Optional[np.ndarray] = None) -> None:
        """images (N, C, H, W) → N Image records; kernels (O, I, KH, KW) →
        O Kernel records; bias (O,) stored whole. A load replaces."""
        images = np.asarray(images, np.float32)
        kernels = np.asarray(kernels, np.float32)
        for s in ("images", "kernels", "bias"):
            client.clear_set(self.db, s)
        client.send_data(self.db, "images",
                         [Image(i, images[i]) for i in range(len(images))])
        client.send_data(self.db, "kernels",
                         [Kernel(o, kernels[o]) for o in range(len(kernels))])
        b = (np.zeros(len(kernels), np.float32) if bias is None
             else np.asarray(bias, np.float32))
        client.send_data(self.db, "bias", [b])

    # -- per-stage computations (reference header per name) -------------

    def _flat_width(self, channels: int) -> int:
        return channels * self.kernel_size * self.kernel_size + 1

    def image_to_chunks(self, img: Image) -> List[Chunk]:
        """``ImageToChunks.h``: im2col window rows (c-major, then kh, kw)
        with a trailing 1.0; global row = key * windows + window."""
        k, s, p = self.kernel_size, self.stride, self.padding
        data = img.data
        if p:
            data = np.pad(data, ((0, 0), (p, p), (p, p)))
        c, h, w = data.shape
        oh = (h - k) // s + 1
        ow = (w - k) // s + 1
        row_start = img.key * oh * ow
        out: List[Chunk] = []
        for wi in range(oh * ow):
            y, x = (wi // ow) * s, (wi % ow) * s
            patch = data[:, y:y + k, x:x + k].reshape(-1)
            row = np.concatenate([patch, [1.0]]).astype(np.float32)
            out.extend(_row_chunks(row_start + wi, row, self.block[1]))
        return out

    def kernel_to_chunks(self, ker: Kernel) -> List[Chunk]:
        """``KernelToChunks.h``: one row per filter, the last column 0
        for the bias join to fill."""
        flat = ker.data.reshape(-1).astype(np.float32)
        row = np.concatenate([flat, [0.0]]).astype(np.float32)
        return _row_chunks(ker.key, row, self.block[1])

    def chunks_to_blocks(self, scan):
        """``ImageChunksToBlock.h``: chunks of one (row block, column
        block) summed into one block (their rows are disjoint)."""
        bx, by = self.block

        def place(ch: Chunk) -> np.ndarray:
            blk = np.zeros((bx, by), np.float32)
            blk[ch.row % bx] = ch.values
            return blk

        return Aggregate(scan, key=lambda ch: (ch.row // bx, ch.y_index),
                         value=place, combine=np.add,
                         label="ImageChunksToBlock")

    def blocks_to_matrix(self, blocks_node, total_rows: int, total_cols: int):
        """``ImageBlockToMatrix.h``: {(bi, bj): block} → one blocked
        matrix of the logical shape, assembled on the host and uploaded
        to the client's device once."""
        def assemble(block_dict) -> BlockedTensor:
            t = BlockedTensor.from_blocks(block_dict, (total_rows, total_cols),
                                          self.block, device="cpu")
            return t.with_data(t.data.to(self._device()))

        return Apply(blocks_node, assemble, label="ImageBlockToMatrix",
                     traceable=False)

    def _device(self) -> torch.device:
        return self.device if self.device is not None else resolve_device()

    # -- the four jobs --------------------------------------------------

    def build_kernel_flat(self, channels: int, num_filters: int) -> WriteSet:
        """Job 1 — ``kernel_bias_join``."""
        width = self._flat_width(channels)
        scan = ScanSet(self.db, "kernels")
        chunks = MultiApply(scan, self.kernel_to_chunks, label="KernelToChunks")
        matrix = self.blocks_to_matrix(self.chunks_to_blocks(chunks),
                                       num_filters, width)
        bias = ScanSet(self.db, "bias")

        def bias_join(kmat: BlockedTensor, bias_items) -> BlockedTensor:
            dense = _host(kmat.to_dense()).copy()
            # a one-tensor set scans as the tensor, a list set as its list
            b = _host(bias_items[0] if isinstance(bias_items, list)
                      else bias_items).astype(np.float32)
            dense[:len(b), width - 1] = b
            return BlockedTensor.from_dense(dense, self.block,
                                            device=kmat.device)

        joined = Join(matrix, bias, fn=bias_join, label="KernelBiasJoin")
        return WriteSet(joined, self.db, "kernel_flat")

    def build_image_flat(self, channels: int, total_windows: int) -> WriteSet:
        """Job 2 — ``image_ops``."""
        width = self._flat_width(channels)
        scan = ScanSet(self.db, "images")
        chunks = MultiApply(scan, self.image_to_chunks, label="ImageToChunks")
        matrix = self.blocks_to_matrix(self.chunks_to_blocks(chunks),
                                       total_windows, width)
        return WriteSet(matrix, self.db, "image_flat")

    def build_conv(self) -> WriteSet:
        """Job 3 — ``conv2d``: FFTransposeMult ⋈ + FFAggMatrix Σ, one
        ``matmul_t`` over the two blocked matrices."""
        image_flat = ScanSet(self.db, "image_flat")
        kernel_flat = ScanSet(self.db, "kernel_flat")
        cd = self.compute_dtype
        prod = Join(image_flat, kernel_flat,
                    fn=lambda a, b: matmul_t(a, b, compute_dtype=cd),
                    label="FFTransposeMult+FFAggMatrix")
        return WriteSet(prod, self.db, "result")

    def build_reassemble(self, out_h: int, out_w: int,
                         num_filters: int) -> WriteSet:
        """Job 4 — ``ConvResultToChunks`` + ``ConvChunksToImage``: the
        result's rows regrouped per image into (O, out_h, out_w)."""
        result = ScanSet(self.db, "result")
        windows = out_h * out_w

        def to_images(res: BlockedTensor) -> List[Image]:
            dense = host_array(res)[:, :num_filters]
            n = dense.shape[0] // windows
            return [Image(i, dense[i * windows:(i + 1) * windows]
                          .reshape(out_h, out_w, num_filters)
                          .transpose(2, 0, 1))
                    for i in range(n)]

        images = Apply(result, to_images, label="ConvChunksToImage",
                       traceable=False)
        return WriteSet(images, self.db, "output")

    # -- driver ---------------------------------------------------------

    def run(self, client, images: np.ndarray, kernels: np.ndarray,
            bias: Optional[np.ndarray] = None) -> List[Image]:
        """The full staged pipeline, one ``execute_computations`` per
        reference job (the same materialisation boundaries)."""
        images = np.asarray(images, np.float32)
        kernels = np.asarray(kernels, np.float32)
        n, c, h, w = images.shape
        o = kernels.shape[0]
        k, s, p = self.kernel_size, self.stride, self.padding
        oh = (h + 2 * p - k) // s + 1
        ow = (w + 2 * p - k) // s + 1

        self.setup(client)
        self.load(client, images, kernels, bias)
        client.execute_computations(self.build_kernel_flat(c, o),
                                    job_name=f"{self.db}-kernel_bias_join")
        client.execute_computations(self.build_image_flat(c, n * oh * ow),
                                    job_name=f"{self.db}-image_ops")
        client.execute_computations(self.build_conv(),
                                    job_name=f"{self.db}-conv2d")
        client.execute_computations(self.build_reassemble(oh, ow, o),
                                    job_name=f"{self.db}-reassemble")
        return list(client.get_set_iterator(self.db, "output"))
