"""Resident service layer — the port's ``netsdb_tpu/serve/``: one daemon
on one card and its thin clients.

The reference is a long-running shared service: ``PDBServer`` listens on
ports dispatching typed-object frames to registered handlers, ``PDBClient``
talks to it over TCP, the master runs forever and model weight sets stay
loaded while many clients run queries. Here one daemon process owns the
card: it holds the set store (device-resident weights), the catalog, the
compiled plans and the decode sessions, and serves concurrent clients
over the typed-frame protocol of :mod:`netsdb_tpu_torch.serve.protocol`.
Clients are thin: they need no card, and tensors cross the wire as raw
dense buffers.
"""

from netsdb_tpu_torch.serve.client import (RemoteClient, RemoteError,
                                           RemoteTensor)
from netsdb_tpu_torch.serve.server import ServeController

__all__ = ["RemoteClient", "RemoteError", "RemoteTensor", "ServeController"]
