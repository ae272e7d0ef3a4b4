"""Set store — the memory storage of ``netsdb_tpu/storage/store.py``.

Every set holds a list of items: one :class:`BlockedTensor` for a matrix
set, one tensor for an activation set, or host objects. The client puts
tensors on its device before they reach the store. A set created with a
placement (:class:`~netsdb_tpu_torch.parallel.placement.Placement`)
applies it to every item stored into it, so its tensors are held
sharded over the placement's mesh. Paged (arena-backed) storage,
spilling and persistence belong to ROADMAP.md A2.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional

from netsdb_tpu_torch.core.blocked import BlockedTensor


class SetIdentifier(NamedTuple):
    """(database, set) pair — reference ``SetIdentifier``."""

    db: str
    set: str

    def __str__(self) -> str:
        return f"{self.db}:{self.set}"


class SetStore:
    """All sets of all databases of one client, in memory. One lock
    serialises every read-modify-write of the set map."""

    def __init__(self):
        self._sets: Dict[SetIdentifier, List[Any]] = {}
        self._placements: Dict[SetIdentifier, Any] = {}
        self._lock = threading.Lock()

    def create_set(self, ident: SetIdentifier,
                   placement: Optional[Any] = None) -> None:
        """Create the set if it is new. A placement given for an
        existing set replaces its placement and re-places what it holds."""
        with self._lock:
            items = self._sets.setdefault(ident, [])
            if placement is not None:
                self._placements[ident] = placement
                self._sets[ident] = [placement.apply(i) for i in items]

    def storage_of(self, ident: SetIdentifier) -> str:
        """Always "memory" in this slice (paged sets are ROADMAP.md A2)."""
        return "memory"

    def placement_of(self, ident: SetIdentifier) -> Optional[Any]:
        with self._lock:
            return self._placements.get(ident)

    def clear_set(self, ident: SetIdentifier) -> None:
        with self._lock:
            if ident in self._sets:
                self._sets[ident] = []

    def add_data(self, ident: SetIdentifier, items: List[Any]) -> None:
        with self._lock:
            self._require(ident).extend(self._placed(ident, items))

    def put_tensor(self, ident: SetIdentifier, tensor: BlockedTensor) -> None:
        """Replace a set's contents with one tensor (every weight set is
        exactly one blocked matrix)."""
        with self._lock:
            self._require(ident)
            self._sets[ident] = self._placed(ident, [tensor])

    def get_items(self, ident: SetIdentifier) -> List[Any]:
        with self._lock:
            return list(self._require(ident))

    def get_tensor(self, ident: SetIdentifier) -> BlockedTensor:
        tensors = [i for i in self.get_items(ident)
                   if isinstance(i, BlockedTensor)]
        if len(tensors) != 1:
            raise ValueError(
                f"set {ident} holds {len(tensors)} tensors; expected exactly 1")
        return tensors[0]

    def _placed(self, ident: SetIdentifier, items: List[Any]) -> List[Any]:
        placement = self._placements.get(ident)
        if placement is None:
            return list(items)
        return [placement.apply(i) for i in items]

    def _require(self, ident: SetIdentifier) -> List[Any]:
        if ident not in self._sets:
            raise KeyError(f"unknown set {ident}; create_set first")
        return self._sets[ident]
