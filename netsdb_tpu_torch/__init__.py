"""netsdb_tpu_torch — the PyTorch / CUDA port of ``netsdb_tpu``.

The package mirrors the JAX package's layout (``core/``, ``ops/``,
``catalog/``, ``storage/``, ``plan/``, ``models/``, ``client.py``,
``config.py``) so each module's counterpart sits under the same name.
It imports ``torch`` and numpy only: never ``jax`` and nothing of
``netsdb_tpu`` (the parity tests are the one place both meet).

Entry point: :class:`netsdb_tpu_torch.client.Client`, which runs on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import Configuration

__all__ = ["Client", "Configuration"]
