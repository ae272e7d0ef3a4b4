"""The port's checkpoints against the reference's
(``netsdb_tpu/storage/checkpoint.py``): the step layout (listing,
latest, pruning, metadata sidecars) answers the same calls alike;
parameter snapshots are the reference's ``leaves.npz`` format, so a
snapshot the port writes, the reference restores; FF parameters, a
``BlockedTensor`` and a placed set round-trip exactly, with their
blocking and placement; whole-store snapshots round-trip."""

import json
import os

import numpy as np
import pytest
import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models.ff import FFParams
from netsdb_tpu_torch.storage import checkpoint as ckpt


def _ff(rng):
    def bt(shape):
        return BlockedTensor.from_dense(
            rng.standard_normal(shape).astype(np.float32), (8, 8),
            device="cpu")
    return FFParams(w1=bt((16, 24)), b1=bt((16, 1)), wo=bt((8, 16)),
                    bo=bt((8, 1)))


def test_step_layout_matches_the_reference(tmp_path):
    """The same calls on both packages' step layouts give the same
    listings, latest steps, pruned steps and sidecars."""
    from netsdb_tpu.storage import checkpoint as ref

    roots = {m: str(tmp_path / name) for m, name in ((ckpt, "port"),
                                                     (ref, "ref"))}
    out = {}
    for mod, root in roots.items():
        assert mod.list_steps(root) == [] and mod.latest_step(root) is None
        assert mod.load_meta(root) is None
        for step in (3, 11, 7):
            mod.save_store(root, {"step": step}, step)
        os.makedirs(os.path.join(root, "step_x"))  # not a step
        mod.save_meta(root, 7, {"mutlog_offset": 123})
        got = [mod.list_steps(root), mod.latest_step(root),
               mod.load_meta(root, 7), mod.load_meta(root),
               mod.load_store(root), mod.load_store(root, 3)]
        got.append(mod.prune_steps(root, keep=2))
        got.append(mod.list_steps(root))
        with pytest.raises(FileNotFoundError):
            mod.load_store(root, 3)
        got.append(mod.prune_steps(root, keep=0))
        out[mod] = got
    assert out[ckpt] == out[ref]
    assert out[ckpt][0] == [3, 7, 11] and out[ckpt][6] == [3]


def test_store_blob_round_trip_and_atomic_write(tmp_path):
    snap = {"databases": ["d"], "types": [{"type": "T",
                                           "entry_point": "m:f",
                                           "source": None}],
            "sets": [{"db": "d", "set": "w", "kind": "tensor",
                      "dense": torch.arange(6.).reshape(2, 3),
                      "block_shape": [2, 2]}]}
    blob = ckpt.dumps_store(snap)
    path = ckpt.save_store_bytes(str(tmp_path / "r"), blob, 4)
    assert sorted(os.listdir(path)) == ["store.pkl"]  # no .tmp left
    back = ckpt.load_store(str(tmp_path / "r"))
    assert back["types"] == snap["types"]
    assert torch.equal(back["sets"][0]["dense"], snap["sets"][0]["dense"])
    assert ckpt.loads_store(memoryview(blob))["databases"] == ["d"]


def test_checkpoint_roundtrip_ffparams(tmp_path):
    """The reference's FF case: two steps, latest and explicit restores
    into a template, blocking kept."""
    rng = np.random.default_rng(0)
    params = _ff(rng)
    root = str(tmp_path / "ckpts")
    ckpt.save(root, params, step=3)
    ckpt.save(root, params, step=7)
    assert ckpt.list_steps(root) == [3, 7] and ckpt.latest_step(root) == 7
    zeros = _ff(np.random.default_rng(1))
    restored = ckpt.restore(root, zeros)
    for name in ("w1", "b1", "wo", "bo"):
        got, want = getattr(restored, name), getattr(params, name)
        assert torch.equal(got.data, want.data)
        assert got.meta == want.meta
    r3 = ckpt.restore(root, zeros, step=3)
    assert torch.equal(r3.wo.to_dense(), params.wo.to_dense())
    with open(os.path.join(root, "step_3", "treedef.json")) as f:
        assert json.load(f) == {"n_leaves": 4}


def test_reference_restores_what_the_port_saves(tmp_path):
    """The port's snapshot is the reference's npz format: the reference
    restores it into its own FF template, leaf for leaf."""
    from netsdb_tpu.core.blocked import BlockedTensor as RefBT
    from netsdb_tpu.models.ff import FFParams as RefFF
    from netsdb_tpu.storage import checkpoint as ref

    params = _ff(np.random.default_rng(2))
    root = str(tmp_path / "x")
    ckpt.save(root, params, step=1)

    def rbt(t):
        return RefBT.from_dense(np.zeros(t.shape, np.float32), (8, 8))

    target = RefFF(w1=rbt(params.w1), b1=rbt(params.b1), wo=rbt(params.wo),
                   bo=rbt(params.bo))
    back = ref.restore(root, target)
    for name in ("w1", "b1", "wo", "bo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(back, name).to_dense()),
            getattr(params, name).to_dense().numpy())


def test_nested_trees_and_dtypes_round_trip(tmp_path):
    tree = {"b": [torch.arange(4, dtype=torch.int64),
                  (torch.ones(2, 2, dtype=torch.bfloat16), None)],
            "a": BlockedTensor.from_dense(np.arange(15.).reshape(3, 5),
                                          (2, 2), device="cpu"),
            "c": np.arange(3, dtype=np.int32)}
    ckpt.save(str(tmp_path), tree, 0)
    template = {"b": [torch.zeros(4, dtype=torch.int64),
                      (torch.zeros(2, 2, dtype=torch.bfloat16), None)],
                "a": BlockedTensor.zeros((3, 5), (2, 2)),
                "c": np.zeros(3, np.int32)}
    back = ckpt.restore(str(tmp_path), template, device="cpu")
    assert torch.equal(back["b"][0], tree["b"][0])
    assert back["b"][1][0].dtype == torch.bfloat16
    assert torch.equal(back["b"][1][0], tree["b"][1][0])
    assert back["b"][1][1] is None
    assert torch.equal(back["a"].data, tree["a"].data)
    assert back["a"].meta == tree["a"].meta
    np.testing.assert_array_equal(back["c"], tree["c"])
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"a": template["a"]})


def test_checkpoint_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), target={"a": np.zeros(2)})


def test_checkpoint_roundtrip_of_placed_sharded_set(tmp_path):
    """The reference's placed case: a placed weight set checkpoints as
    its logical array and restores into a placed set, whose ingest puts
    the placement back."""
    from netsdb_tpu_torch import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.mesh import ShardedTensor, virtual_devices
    from netsdb_tpu_torch.parallel.placement import Placement

    dense = np.random.default_rng(0).standard_normal((64, 32)).astype(
        np.float32)
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "db")),
                   device="cpu")
        c.create_database("m")
        c.create_set("m", "w", placement=Placement.data_parallel(ndim=2))
        c.send_matrix("m", "w", dense, (8, 8))
        t = c.get_tensor("m", "w")
        assert isinstance(t.data, ShardedTensor)
        assert len(t.data.distinct_positions()) == 4
        ckpt.save(str(tmp_path / "ck"), {"w": t}, step=3)

        c2 = Client(Configuration(root_dir=str(tmp_path / "db2")),
                    device="cpu")
        c2.create_database("m")
        c2.create_set("m", "w", placement=Placement.data_parallel(ndim=2))
        target = {"w": BlockedTensor.zeros((64, 32), (8, 8))}
        restored = ckpt.restore(str(tmp_path / "ck"), target, step=3)
        c2.store.put_tensor(c2.store.list_sets()[0], restored["w"])
        t2 = c2.get_tensor("m", "w")
        assert isinstance(t2.data, ShardedTensor)
        assert len(t2.data.distinct_positions()) == 4
        np.testing.assert_array_equal(t2.data.to_dense()[:64, :32].numpy(),
                                      dense)
        # a placed template restores placed, with its own layout
        back = ckpt.restore(str(tmp_path / "ck"), {"w": t}, step=3)
        assert isinstance(back["w"].data, ShardedTensor)
        assert back["w"].data.spec == t.data.spec
        assert torch.equal(back["w"].data.to_dense(), t.data.to_dense())
