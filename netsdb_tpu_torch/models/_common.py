"""Helpers shared by the model families: set creation and input dtype."""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np
import torch


def as_f32(x):
    """A tensor as f32 where it lies; anything else as an f32 array."""
    return x.float() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def create_sets(client, db: str, sets: Iterable[str],
                placements: Optional[Mapping[str, object]] = None,
                type_name: str = "tensor") -> None:
    """Create ``db`` and its ``sets``. The ops of these models take
    tensors on one device, so a placed set raises before anything is
    created."""
    sets = list(sets)
    placed = [s for s in sets if (placements or {}).get(s) is not None]
    if placed:
        raise NotImplementedError(
            f"placed sets {placed} of database {db!r}: these models run on "
            f"one device; multi-device placement is ROADMAP.md A4")
    client.create_database(db)
    for s in sets:
        client.create_set(db, s, type_name=type_name)
