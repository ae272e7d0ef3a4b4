"""Entry points of the port — counterpart of the repository's
``__graft_entry__.py``.

``entry()``               → the flagship FF forward and example args.
``dryrun_multichip(n)``   → the FF section of the reference's dry run on
                            one device: inference through the database,
                            then one training step on params read back
                            from the store.

Both run on CUDA unless given ``device=``, and raise where there is no
card. The reference's dry run also builds an n-device mesh and runs the
sequence-, pipeline- and expert-parallel sections over placed sets; the
port's multi-device work is ROADMAP.md A4 part 3, so ``n_devices > 1`` raises.
"""

from __future__ import annotations

import numpy as np

from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models.ff import FFModel, FFParams


def _onehot(labels: np.ndarray, n_labels: int) -> np.ndarray:
    onehot = np.zeros((n_labels, labels.size), np.float32)
    onehot[labels, np.arange(labels.size)] = 1.0
    return onehot


def _tiny_model(block=(8, 8), features=16, hidden=32, labels=8, batch=16,
                device=None):
    """The reference's ``_tiny_model``: the same numpy draws, in order."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    def blocked(a, bs):
        return BlockedTensor.from_dense(a, bs, device=device)

    model = FFModel(block=block)
    params = FFParams(
        w1=blocked(rng.standard_normal((hidden, features)).astype(np.float32),
                   block),
        b1=blocked(np.zeros((hidden, 1), np.float32), (block[0], 1)),
        wo=blocked(rng.standard_normal((labels, hidden)).astype(np.float32),
                   block),
        bo=blocked(np.zeros((labels, 1), np.float32), (block[0], 1)))
    x = blocked(rng.standard_normal((batch, features)).astype(np.float32),
                block)
    y = blocked(_onehot(rng.integers(0, labels, batch), labels), block)
    return model, params, x, y


def entry(device=None):
    """``(fn, example_args)``: the FF forward step and its arguments."""
    model, params, x, _ = _tiny_model(device=device)
    return model.forward, (params, x)


def dryrun_multichip(n_devices: int, device=None) -> float:
    """The reference dry run's FF section on one device: random weights
    and inputs through ``Client``, ``inference``, the one-hot labels sent
    with ``send_matrix``, params read back with ``params_from_store`` and
    ``get_tensor``, and one ``train_step``. Returns the step's loss;
    raises on a non-finite output or loss. More than one device is
    ROADMAP.md A4 part 3."""
    if n_devices != 1:
        raise NotImplementedError(
            f"dryrun_multichip({n_devices}): the port's dry run covers one "
            f"device; meshes and placed training are ROADMAP.md A4 part 3")
    # the reference's shapes at one device: data and model axes of 1
    block, features, hidden, batch, labels = (8, 8), 16, 16, 16, 8
    rng = np.random.default_rng(0)
    client = Client(device=device)
    model = FFModel(db="ff", block=block)
    model.setup(client)
    model.load_random_weights(client, features=features, hidden=hidden,
                              labels=labels, seed=0)
    model.load_inputs(
        client, rng.standard_normal((batch, features)).astype(np.float32))
    out = model.inference(client)
    if not bool(out.data.isfinite().all()):
        raise RuntimeError("ff inference gave a non-finite output")
    client.create_set("ff", "labels")
    client.send_matrix("ff", "labels",
                       _onehot(rng.integers(0, labels, batch), labels), block)
    params = model.params_from_store(client)
    x = client.get_tensor("ff", "inputs")
    y = client.get_tensor("ff", "labels")
    _, loss = model.train_step(params, x, y)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError("the training step gave a non-finite loss")
    return loss
