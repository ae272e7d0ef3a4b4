"""Configuration — the subset of ``netsdb_tpu.config.Configuration``
that the ported path reads — and the rule that picks the device."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Tuple

import torch


@dataclasses.dataclass
class Configuration:
    """``default_block_shape`` is the block a matrix set gets when
    ``send_matrix`` is given none (as in the reference package).
    ``root_dir`` is where durable sets will live; nothing is written
    there until persistence is ported (ROADMAP.md A2)."""

    default_block_shape: Tuple[int, int] = (512, 512)
    root_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "netsdb_tpu_torch"))


def resolve_device(device=None) -> torch.device:
    """The device a client runs on: ``device`` if given, else CUDA.
    A CUDA device on a machine without a usable card is an error —
    the port never drops to the CPU on its own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "netsdb_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev
