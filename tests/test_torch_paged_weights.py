"""Model inference over paged weight sets in the port against the JAX
package's, on the CPU.

Both packages run with the reference tests' arena,
``Configuration(page_size_bytes=4096, page_pool_bytes=16384)``, which is
smaller than the weights, so it spills. The same seeded numpy weights
and inputs go into a JAX ``Client`` and a port ``Client(device="cpu")``
(the reference's ``tests/test_paged_weights.py`` at the same sizes).

Tolerances:

- FF against the JAX package's paged FF: 1e-5, the limit of the port's
  resident FF tests (``tests/test_torch_ff.py``): the two libraries'
  f32 GEMMs sum in different orders.
- FF paged against the port's resident FF: bit for bit. Rows mode leaves
  each output element's contraction whole, and on the CPU torch's GEMM
  gives every row of a block the same sum whatever the block's height.
- The staged layer: ``rtol=atol=2e-5`` at embed 64, as the reference
  holds its own staged DAG. Reduce mode sums the contraction slice by
  slice, a different association than one product.
"""

import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.models.ff import FFModel as JaxFF
from netsdb_tpu.models.transformer import TransformerLayerModel as JaxLayer
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.models.transformer import TransformerLayerModel
from netsdb_tpu_torch.parallel.mesh import ShardedTensor, virtual_devices
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import TensorFold
from netsdb_tpu_torch.storage.store import SetIdentifier

torch.set_num_threads(2)

ARENA = dict(page_size_bytes=4096, page_pool_bytes=16384)
FF_TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
F, H, L, B = 96, 128, 10, 32      # the reference test's FF
E, S, BT, HEADS = 64, 16, 2, 4    # and its transformer layer
ALL_FOUR = ("w_qkv", "w_out", "w_up", "w_down")


def _port(root, **kw) -> Client:
    return Client(Configuration(root_dir=str(root), **ARENA, **kw),
                  device="cpu")


def _jax(root) -> JaxClient:
    return JaxClient(JaxConfiguration(root_dir=str(root), **ARENA))


def _ff_inputs():
    return np.random.default_rng(1).standard_normal((B, F)).astype(
        np.float32)


def _ff(c, cls, storages=None, placements=None):
    m = cls(db="ff", block=(32, 32))
    m.setup(c, placements=placements, storages=storages)
    m.load_random_weights(c, F, H, L, seed=0)
    m.load_inputs(c, _ff_inputs())
    return m


def _ff_out(c, cls=FFModel, **kw) -> np.ndarray:
    m = _ff(c, cls, **kw)
    out = m.inference(c).to_dense()
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _spills(c) -> int:
    return c.store.page_store().stats()["spills"]


@pytest.mark.parametrize("paged", [("w1",), ("w1", "wo")])
def test_ff_paged_weights_match_jax_and_resident(tmp_path, paged):
    clear_compiled_cache()
    storages = {w: "paged" for w in paged}
    jc = _jax(tmp_path / "jax")
    ref = _ff_out(jc, JaxFF, storages=storages)
    pc = _port(tmp_path / "port")
    got = _ff_out(pc, storages=storages)
    assert _spills(jc) > 0 and _spills(pc) > 0
    np.testing.assert_allclose(got, ref, **FF_TOL)
    resident = _ff_out(_port(tmp_path / "res"))
    np.testing.assert_array_equal(got, resident)
    # the output is a blocked tensor of the resident path's blocks
    out = pc.get_tensor("ff", "output")
    assert out.meta.block_shape == (32, 32) and out.shape == (L, B)


def _layer(c, cls, storages=None):
    m = cls(db="tf", num_heads=HEADS)
    m.setup(c, storages=storages)
    m.load_random_weights(c, E, seed=2)
    x = np.random.default_rng(3).standard_normal((BT, S, E)).astype(
        np.float32)
    m.load_inputs(c, x)
    return m, x


def _staged(c, m, job):
    res = c.execute_computations(m.build_forward_dag_staged(), job_name=job)
    out = next(iter(res.values()))
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("paged", [("w_up", "w_down"), ALL_FOUR])
def test_staged_layer_matches_jax_and_the_fused_forward(tmp_path, paged):
    clear_compiled_cache()
    storages = {w: "paged" for w in paged}
    jc = _jax(tmp_path / "jax")
    jm, _ = _layer(jc, JaxLayer, storages)
    ref = _staged(jc, jm, "tf-jax")
    pc = _port(tmp_path / "port")
    pm, x = _layer(pc, TransformerLayerModel, storages)
    got = _staged(pc, pm, "tf-port")
    assert _spills(jc) > 0 and _spills(pc) > 0
    assert got.shape == (BT, S, E)
    np.testing.assert_allclose(got, ref, **LAYER_TOL)
    # the same DAG over resident sets, and the fused forward
    rc = _port(tmp_path / "res")
    rm, _ = _layer(rc, TransformerLayerModel)
    resident = _staged(rc, rm, "tf-res")
    np.testing.assert_allclose(got, resident, **LAYER_TOL)
    fused = rm.forward(rm.params_from_store(rc), torch.from_numpy(x))
    np.testing.assert_allclose(resident, fused.numpy(), **LAYER_TOL)
    # a warm request replays the weights from the device cache
    reads = pc.store.page_store().stats()["page_reads"]
    np.testing.assert_array_equal(_staged(pc, pm, "tf-port"), got)
    assert pc.store.page_store().stats()["page_reads"] == reads


def test_fold_less_consumer_of_a_paged_set_raises(tmp_path):
    c = _port(tmp_path / "p")
    c.create_database("d")
    c.create_set("d", "w", storage="paged")
    c.send_matrix("d", "w", np.ones((64, 16), np.float32))
    sink = WriteSet(Apply(ScanSet("d", "w"), fn=lambda t: t, label="ident"),
                    "d", "out")
    with pytest.raises(ValueError, match="tensor_fold"):
        c.execute_computations(sink, job_name="bad")
    # and the set is never materialised on the device
    with pytest.raises(ValueError, match="paged"):
        c.get_tensor("d", "w")
    # the reference raises the same way
    jc = _jax(tmp_path / "j")
    from netsdb_tpu.plan import computations as jcomp

    jc.create_database("d")
    jc.create_set("d", "w", storage="paged")
    jc.send_matrix("d", "w", np.ones((64, 16), np.float32))
    with pytest.raises(ValueError, match="tensor_fold"):
        jc.execute_computations(jcomp.WriteSet(jcomp.Apply(
            jcomp.ScanSet("d", "w"), fn=lambda t: t, label="ident"),
            "d", "out"), job_name="bad")


def test_a_job_mixing_paged_and_resident_sinks_splits(tmp_path):
    c = _port(tmp_path / "p")
    c.create_database("d")
    c.create_set("d", "w", storage="paged")
    c.create_set("d", "r")
    w = np.random.default_rng(0).standard_normal((200, 8)).astype(np.float32)
    c.send_matrix("d", "w", w, (32, 8))
    c.send_matrix("d", "r", w, (32, 8))
    paged = WriteSet(Apply(ScanSet("d", "w"), fn=lambda t: t.to_dense() + 1,
                           tensor_fold=TensorFold(mode="rows"),
                           label="plus1"), "d", "out_paged")
    resident = WriteSet(Apply(ScanSet("d", "r"),
                              fn=lambda t: t.to_dense() + 1, label="plus1r"),
                        "d", "out_resident")
    res = c.execute_computations(paged, resident, job_name="mixed")
    assert set(res) == {SetIdentifier("d", "out_paged"),
                        SetIdentifier("d", "out_resident")}
    for out in res.values():
        np.testing.assert_array_equal(out.numpy(), w + 1)


def test_flush_and_reload_in_a_fresh_client(tmp_path):
    """Paged and memory tensor sets written to ``data_dir`` come back in
    a fresh client over the same ``root_dir``, paged sets as paged sets,
    and inference gives the same output."""
    root = tmp_path / "dur"
    want = _ff_out(_port(tmp_path / "res"))
    c = _port(root)
    m = _ff(c, FFModel, storages={"w1": "paged", "wo": "paged"})
    assert m.inference(c) is not None
    for s in m.SETS:
        c.store.flush(SetIdentifier("ff", s))
    c2 = _port(root)
    for s in m.SETS:
        c2.store.load_set(SetIdentifier("ff", s))
    assert c2.store.storage_of(SetIdentifier("ff", "w1")) == "paged"
    assert c2.store.storage_of(SetIdentifier("ff", "b1")) == "memory"
    np.testing.assert_array_equal(m.inference(c2).to_dense().numpy(), want)
    assert _spills(c2) > 0


def test_flush_data_writes_the_persistent_sets_only(tmp_path):
    root = tmp_path / "p"
    c = _port(root)
    c.create_database("d")
    c.create_set("d", "keep", storage="paged", persistence="persistent")
    c.create_set("d", "mem", persistence="persistent")
    c.create_set("d", "tmp")
    m = np.arange(600, dtype=np.float32).reshape(60, 10)
    for s in ("keep", "mem", "tmp"):
        c.send_matrix("d", s, m, (16, 10))
    c.flush_data()
    c2 = _port(root)
    for s in ("keep", "mem"):
        c2.store.load_set(SetIdentifier("d", s))
    eye = np.eye(10, dtype=np.float32)
    np.testing.assert_array_equal(c2.paged_matmul("d", "keep", eye).numpy(),
                                  m)
    np.testing.assert_array_equal(c2.get_tensor("d", "mem").to_dense().numpy(),
                                  m)
    with pytest.raises(KeyError, match="no data"):
        c2.store.load_set(SetIdentifier("d", "tmp"))


def test_paged_weights_compose_with_placement(tmp_path):
    """A paged weight set that is also placed puts each staged block on
    the placement's mesh before the step (the reference's
    ``test_ff_paged_weights_compose_with_placement``), over 8 virtual
    CPU positions."""
    pl = {"w1": Placement((("model", 0),), (None, "model")),
          "wo": Placement((("model", 0),), (None, None))}
    want = _ff_out(_port(tmp_path / "res"))
    seen = []
    with virtual_devices(8, "cpu"):
        c = _port(tmp_path / "pag")
        m = _ff(c, FFModel, storages={"w1": "paged", "wo": "paged"},
                placements=pl)
        pt = c.store.paged_tensor(SetIdentifier("ff", "w1"))
        assert pt.placement == pl["w1"]
        import netsdb_tpu_torch.plan.executor as ex

        real = ex.staging.BlockUploader.upload

        def spy(self, block, rows=None):
            out = real(self, block, rows)
            seen.append(out.shape)
            return out

        ex.staging.BlockUploader.upload = spy
        try:
            got = m.inference(c).to_dense().numpy()
        finally:
            ex.staging.BlockUploader.upload = real
        stored = c.store.get_items(SetIdentifier("ff", "w1"))
        assert not any(isinstance(i, ShardedTensor) for i in stored)
    assert _spills(c) > 0 and seen
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_placed_paged_block_is_sharded(tmp_path):
    """The executor applies the set's placement to every staged block: a
    rows-mode fn sees a sharded block on the mesh's 8 positions."""
    kinds = []

    def record(w):
        kinds.append((type(w.data).__name__, len({
            str(t.device) + str(id(t)) for t in w.data.shards.flat})
            if isinstance(w.data, ShardedTensor) else 1))
        return w.to_dense() if not isinstance(w.data, ShardedTensor) \
            else w.data.to_dense()

    with virtual_devices(8, "cpu"):
        c = _port(tmp_path / "p")
        c.create_database("d")
        c.create_set("d", "w", storage="paged",
                     placement=Placement((("model", 0),), (None, "model")))
        w = np.random.default_rng(0).standard_normal((100, 64)).astype(
            np.float32)
        c.send_matrix("d", "w", w, (16, 16))
        sink = WriteSet(Apply(ScanSet("d", "w"), fn=record,
                              tensor_fold=TensorFold(mode="rows"),
                              label="gather"), "d", "out")
        out = next(iter(c.execute_computations(sink).values()))
    np.testing.assert_array_equal(out.numpy(), w)
    assert kinds and all(k == ("ShardedTensor", 8) for k in kinds)


def test_reduce_fold_accumulates_in_place_and_never_writes_a_cached_block(
        tmp_path):
    """Reduce mode over a paged weight: the carry is a fresh tensor
    updated in place, and the cached blocks keep their bytes across
    warm requests."""
    c = _port(tmp_path / "p")
    c.create_database("d")
    c.create_set("d", "w", storage="paged")
    c.create_set("d", "x")
    rng = np.random.default_rng(4)
    w = rng.standard_normal((300, 12)).astype(np.float32)
    x = rng.standard_normal((5, 300)).astype(np.float32)
    c.send_matrix("d", "w", w, (32, 12))
    c.send_data("d", "x", [x])
    carries = []

    def partial(carry, start, block, acts):
        p = acts[:, start:start + block.shape[0]] @ block
        if carry is None:
            carries.append(p)
            return p
        assert carry is carries[0]
        return carry.add_(p)

    sink = WriteSet(Join(ScanSet("d", "x"), ScanSet("d", "w"),
                         fn=lambda a, b: a @ b.to_dense(),
                         tensor_fold=TensorFold(mode="reduce",
                                                partial=partial,
                                                finalize=lambda cr, a: cr * 2),
                         label="proj"), "d", "y")
    for _ in range(3):
        carries.clear()
        out = next(iter(c.execute_computations(sink).values()))
        np.testing.assert_allclose(out.numpy(), 2 * (x @ w), rtol=1e-5,
                                   atol=1e-4)
    pt = c.store.paged_tensor(SetIdentifier("d", "w"))
    cached = [b for _, b in pt.devcache._entries.items()]
    assert cached
    blocks = torch.cat([entry[0][0][1] if isinstance(entry[0][0], tuple)
                        else entry[0][0] for entry in cached])
    assert blocks.shape[0] == 300
    np.testing.assert_array_equal(np.sort(blocks.numpy().ravel()),
                                  np.sort(w.ravel()))


def test_placed_sets_flush_and_reload(tmp_path):
    """A placed memory set (sharded data, gathered on flush) and a placed
    paged set come back placed in a fresh client."""
    pl = Placement((("model", 0),), (None, "model"))
    m = np.random.default_rng(5).standard_normal((100, 64)).astype(
        np.float32)
    with virtual_devices(8, "cpu"):
        c = _port(tmp_path / "p")
        c.create_database("d")
        c.create_set("d", "mem", placement=pl, persistence="persistent")
        c.create_set("d", "pag", placement=pl, storage="paged",
                     persistence="persistent")
        for s in ("mem", "pag"):
            c.send_matrix("d", s, m, (16, 16))
        assert isinstance(c.get_tensor("d", "mem").data, ShardedTensor)
        c.flush_data()
        c2 = _port(tmp_path / "p")
        for s in ("mem", "pag"):
            c2.store.load_set(SetIdentifier("d", s))
        mem = c2.get_tensor("d", "mem")
        assert isinstance(mem.data, ShardedTensor)
        np.testing.assert_array_equal(mem.to_dense().to_dense().numpy(), m)
        assert c2.store.placement_of(SetIdentifier("d", "pag")) == pl
        np.testing.assert_array_equal(
            c2.paged_matmul("d", "pag", np.eye(64, dtype=np.float32)).numpy(),
            m)
