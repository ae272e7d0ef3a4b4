"""One module a model kind, named by a configuration's ``kind``: the
program under test (``netsdb_tpu_torch``) driven as its users drive it,
through the client's set API and ``Client.execute_computations``.

Each module has ``open(client, config, data)``, which stores the
weights and each input set and builds one DAG an input set, and returns
an object with ``request(i)`` (one call of ``execute_computations`` over
input set ``i``; returns the program's output as it comes) and
``dense(output)`` (that output as one tensor). The functions below are
what every kind reads of the program besides.
"""

from __future__ import annotations

import os
from typing import Dict


def client(device, root_dir: str, build_dir: str):
    """A client of the program on ``device``. Its sets' files live under
    ``root_dir``; the hand-written kernels build into, and load from,
    ``build_dir``."""
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration

    os.makedirs(root_dir, exist_ok=True)
    return Client(Configuration(root_dir=root_dir,
                                compilation_cache_dir=build_dir),
                  device=device)


def program_counters() -> Dict[str, int]:
    """The program cache's counters (``plan.programs.program_stats``):
    graph captures, replays, runs of variants that stay eager, and the
    bytes the captures reserved for the graphs' pools."""
    from netsdb_tpu_torch.plan.programs import program_stats

    stats = program_stats()
    return {k: int(stats[k]) for k in ("captures", "replays", "eager_runs",
                                       "capture_bytes")}


def release() -> None:
    """Drops the program's compiled programs and their graphs."""
    from netsdb_tpu_torch.plan.executor import clear_compiled_cache

    clear_compiled_cache()
