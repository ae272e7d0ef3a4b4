"""Collective-step resharding (``parallel/reshard.py``) against the JAX
package's, on the CPU (``tests/test_reshard.py``'s cases).

The JAX side runs on 4 of the suite's virtual CPU devices; the port on 4
virtual positions of the CPU. The planner's schedules are compared step
for step; a placed paged relation reshards its device-cached blocks with
no page read, and its warm requery under the new layout reads none
either and equals a fresh stream under that layout; memory sets (tables,
blocked tensors) move through the schedule; a paged tensor set's cached
weight blocks and its SUMMA blocks (1-d ↔ 2x2) move between layouts with
byte-equal results (integer-valued operands)."""

import contextlib

import numpy as np
import pytest
import torch

from netsdb_tpu.parallel import reshard as JR
from netsdb_tpu_torch import Client, obs
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.parallel.mesh import ShardedTensor, virtual_devices
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.parallel.reshard import (Step, execute_steps,
                                               plan_steps, reshard_set,
                                               reshard_summa_layout)
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.relational.outofcore import PagedColumns
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage.store import SetIdentifier

pytestmark = pytest.mark.mesh

SRC = Placement((("data", 4),), ("data",))
REPL = Placement((("data", 4),), (None,))
IDENT = SetIdentifier("d", "t")


@pytest.fixture(autouse=True)
def four():
    with virtual_devices(4, "cpu") as d:
        yield list(d)


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 100, n).astype(np.int32),
            "v": rng.uniform(0, 1, n).astype(np.float32)}


def _table(cols):
    return ColumnTable.from_columns(cols, device="cpu")


def _client(tmp_path, name="p", placement=SRC, **cfg):
    cfg.setdefault("page_size_bytes", 4096)
    c = Client(Configuration(root_dir=str(tmp_path / name), **cfg),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "t", type_name="table", storage="paged",
                 placement=placement)
    return c


def _consume(pc, placement):
    from netsdb_tpu_torch.parallel.placement import gather_table

    out = []
    with contextlib.closing(pc.stream_tables(placement=placement)) as s:
        for t in s:
            t = gather_table(t)
            out.append({k: v.numpy() for k, v in t.cols.items()}
                       | {"__valid__": t.mask().numpy()})
    return out


def _pc(c):
    return next(i for i in c.store.get_items(IDENT)
                if isinstance(i, PagedColumns))


# ------------------------------------------------------- the planner
@pytest.mark.parametrize("src,dst,ndim,kw", [
    (("data",), ("data",), 1, {}),
    (("data",), (None,), 1, {"axis_sizes": {"data": 4}}),
    (("data",), (None,), 1, {}),
    ((None,), ("data",), 1, {}),
    (("data", None), (None, "data"), 2, {}),
    (("data",), ("data",), 1, {"same_mesh": False}),
    (("data",), ("data", None), 2, {}),
    ((None, "data"), ("data", None), 2, {"axis_sizes": {"data": 4}}),
    ((("data", "model"), None), (None, "data"), 2, {}),
    ((None,), (None,), 1, {"same_mesh": False}),
])
def test_plan_steps_lattice_matches_the_reference(src, dst, ndim, kw):
    got = plan_steps(src, dst, ndim, **kw)
    want = JR.plan_steps(src, dst, ndim, **kw)
    assert [(s.kind, s.dim, s.dim_to, s.axis, s.peak) for s in got] == \
        [(s.kind, s.dim, s.dim_to, s.axis, s.peak) for s in want]
    assert [s.label() for s in got] == [s.label() for s in want]


def test_plan_steps_named_cases():
    assert plan_steps(("data",), (None,), 1, axis_sizes={"data": 4}) == \
        [Step("all_gather", dim=0, axis="data", peak=4)]
    assert plan_steps((None,), ("data",), 1) == \
        [Step("local_slice", dim=0, axis="data", peak=1)]
    assert plan_steps(("data", None), (None, "data"), 2) == \
        [Step("all_to_all", dim=0, dim_to=1, axis="data", peak=1)]
    steps = plan_steps(("data",), ("data",), 1, same_mesh=False)
    assert [s.kind for s in steps] == ["all_gather", "replace"]


# --------------------------------------------- the paged-set primitive
def test_reshard_paged_set_zero_arena_reads(tmp_path):
    """A warm placed set reshards sharded → replicated device to device:
    no page read, and the warm requery under the new layout reads none
    and equals a fresh stream ingested under it."""
    c = _client(tmp_path)
    cols = _cols(6000)
    c.send_table("d", "t", _table(cols))
    pc = _pc(c)
    cache = c.store.device_cache()
    _consume(pc, c.store.placement_of(IDENT))  # cold: installs src blocks
    entries0 = cache.stats()["entries"]
    assert entries0 == len(pc.block_ranges())
    pages0 = pc.pages_streamed
    rep = reshard_set(c.store, IDENT, REPL)
    assert rep.labels() == ["all_gather[data:0]"]
    assert rep.steps[0].peak == 4
    assert rep.blocks_moved == entries0
    assert rep.bytes_moved > 0
    assert pc.pages_streamed == pages0
    assert c.store.placement_of(IDENT) is REPL
    warm = _consume(pc, c.store.placement_of(IDENT))
    assert pc.pages_streamed == pages0
    cu = _client(tmp_path, "fresh", placement=REPL, device_cache_bytes=0)
    cu.send_table("d", "t", _table(cols))
    ref = _consume(_pc(cu), REPL)
    assert len(warm) == len(ref)
    for a, b in zip(warm, ref):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert staging.active_count() == 0


def test_reshard_devcache_key_miss_old_hit_new(tmp_path):
    c = _client(tmp_path)
    c.send_table("d", "t", _table(_cols(5000, seed=3)))
    pc = _pc(c)
    cache = c.store.device_cache()
    _consume(pc, SRC)
    entries0 = cache.stats()["entries"]
    reshard_set(c.store, IDENT, REPL)
    assert cache.stats()["entries"] == entries0
    ranges = pc.block_ranges()
    _e, old = cache.plan_ranges(pc.partial_base_key("tables",
                                                    placement=SRC), ranges)
    assert old == {}
    _e, new = cache.plan_ranges(pc.partial_base_key("tables",
                                                    placement=REPL), ranges)
    assert len(new) == len(ranges)
    assert staging.active_count() == 0


def test_reshard_replicated_to_sharded_local_slice(tmp_path):
    c = _client(tmp_path, placement=REPL)
    cols = _cols(4000, seed=5)
    c.send_table("d", "t", _table(cols))
    pc = _pc(c)
    _consume(pc, REPL)
    pages0 = pc.pages_streamed
    rep = reshard_set(c.store, IDENT, SRC)
    assert rep.labels() == ["local_slice[data:0]"]
    assert rep.blocks_moved == len(pc.block_ranges())
    assert pc.pages_streamed == pages0
    warm = _consume(pc, SRC)
    assert pc.pages_streamed == pages0
    merged = np.concatenate([t["v"][t["__valid__"]] for t in warm])
    assert np.array_equal(np.sort(merged), np.sort(cols["v"]))


def test_warm_placed_query_after_a_reshard_reads_no_page(tmp_path):
    """The suite's fold over the placed paged relation: warm under the new
    layout, it reads no page and gives the same answer."""
    from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet
    from netsdb_tpu_torch.plan.fold import single_pass, tree_add_states

    c = _client(tmp_path)
    cols = _cols(3001, seed=8)
    c.send_table("d", "t", _table(cols))
    fold = single_pass(
        lambda prev, src: torch.zeros((), dtype=torch.float32),
        lambda st, t: st + torch.where(t.mask(), t["v"], 0.0).sum(),
        lambda st, src: st, state_merge=tree_add_states)
    sink = WriteSet(Apply(ScanSet("d", "t"), fold=fold, label="sum-v"),
                    "d", "o")
    first = next(iter(c.execute_computations(sink).values()))
    pc = _pc(c)
    pages0 = pc.pages_streamed
    reshard_set(c.store, IDENT, REPL)
    again = next(iter(c.execute_computations(sink).values()))
    assert pc.pages_streamed == pages0
    assert again.item() == pytest.approx(first.item(), rel=1e-6)
    assert first.item() == pytest.approx(float(cols["v"].sum()), rel=1e-5)


# ------------------------------------------------------- memory sets
def test_reshard_memory_blocked_tensor_all_to_all(tmp_path):
    from netsdb_tpu_torch.core.blocked import BlockedTensor

    src = Placement((("data", 4),), ("data", None))
    dst = Placement((("data", 4),), (None, "data"))
    c = Client(Configuration(root_dir=str(tmp_path / "m")), device="cpu")
    c.create_database("d")
    c.create_set("d", "t", type_name="tensor", placement=src)
    rng = np.random.default_rng(1)
    dense = rng.integers(-8, 8, (512, 512)).astype(np.float32)
    c.send_matrix("d", "t", dense)
    version = c.store.version_of(IDENT)
    rep = reshard_set(c.store, IDENT, dst)
    assert rep.items_moved == 1
    assert [s.kind for s in rep.steps] == ["all_to_all"]
    item = next(i for i in c.store.get_items(IDENT)
                if isinstance(i, BlockedTensor))
    assert isinstance(item.data, ShardedTensor)
    assert item.data.spec == (None, "data")
    whole = item.to_dense()
    if isinstance(whole, ShardedTensor):
        whole = whole.to_dense()
    assert np.array_equal(whole.numpy(), dense)
    assert c.store.placement_of(IDENT) is dst
    assert c.store.version_of(IDENT) == version  # the commit moves none


def test_reshard_memory_table_set(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "mt")), device="cpu")
    c.create_database("d")
    c.create_set("d", "t", type_name="table", placement=SRC)
    cols = _cols(4097, seed=11)  # 4 does not divide it
    c.send_table("d", "t", _table(cols))
    rep = reshard_set(c.store, IDENT, REPL)
    assert rep.items_moved == 1
    assert [s.kind for s in rep.steps] == ["all_gather"]
    item = c.get_table("d", "t")
    assert item["v"].spec == (None,)
    got = item["v"].to_dense().numpy()[item.valid.to_dense().numpy()]
    assert np.array_equal(np.sort(got), np.sort(cols["v"]))
    assert [r["k"] for r in item.to_rows()] == cols["k"].tolist()


def test_execute_steps_values_and_layout(four):
    x = torch.arange(64, dtype=torch.float32)
    steps = plan_steps(tuple(SRC.spec), tuple(REPL.spec), 1)
    out = execute_steps(x, steps, SRC, REPL)
    assert isinstance(out, ShardedTensor) and out.spec == (None,)
    assert torch.equal(out.to_dense(), x)
    back = execute_steps(out, plan_steps((None,), ("data",), 1), REPL, SRC)
    assert back.spec == ("data",)
    assert torch.equal(back.to_dense(), x)
    assert torch.equal(back.shards.flat[2], x[32:48])


# --------------------------------------------------- paged tensor sets
def test_reshard_paged_tensor_stream_blocks_round_trip(tmp_path):
    """A placed paged weight set reshards its cached rows-mode blocks
    (sharded → replicated → sharded); each warm inference under the new
    layout reads no page and is byte-equal."""
    from netsdb_tpu_torch.models.ff import FFModel

    src = Placement((("data", 4),), ("data", None))
    repl = Placement((("data", 4),), (None, None))
    rng = np.random.default_rng(9)
    F, H, L, B = 96, 128, 10, 32
    ints = lambda shape: rng.integers(-2, 2, shape).astype(np.float32)  # noqa: E731
    c = Client(Configuration(root_dir=str(tmp_path / "ff"),
                             page_size_bytes=4096, page_pool_bytes=16384),
               device="cpu")
    m = FFModel(db="ff", block=(32, 32))
    m.setup(c, storages={"w1": "paged"}, placements={"w1": src})
    m.load_weights(c, ints((H, F)), ints((H,)), ints((L, H)), ints((L,)))
    m.load_inputs(c, ints((B, F)))
    cold = m.inference(c).to_dense().numpy()
    ident = SetIdentifier("ff", "w1")
    ps = c.store.page_store()
    pm = next(i for i in c.store.get_items(ident)
              if type(i).__name__ == "_PagedMatrix")
    nblocks = len(ps.block_ranges(pm.name))
    assert nblocks > 1
    rep = reshard_set(c.store, ident, repl)
    assert rep.labels() == ["all_gather[data:0]"]
    assert rep.blocks_moved == nblocks and rep.bytes_moved > 0
    reads0 = ps.stats()["page_reads"]
    warm = m.inference(c).to_dense().numpy()
    assert ps.stats()["page_reads"] == reads0
    np.testing.assert_array_equal(cold, warm)
    rep2 = reshard_set(c.store, ident, src)
    assert rep2.labels() == ["local_slice[data:0]"]
    assert rep2.blocks_moved == nblocks
    back = m.inference(c).to_dense().numpy()
    assert ps.stats()["page_reads"] == reads0
    np.testing.assert_array_equal(cold, back)
    assert staging.active_count() == 0


def _summa_set(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "sm"),
                             page_size_bytes=64 * 1024), device="cpu")
    c.create_database("d")
    c.create_set("d", "m", type_name="tensor", storage="paged")
    return c


def test_reshard_summa_layout_1d_to_2d_and_back(tmp_path, four):
    from netsdb_tpu_torch.parallel.summa import (summa_grid_matmul_streamed,
                                                 summa_matmul_streamed)

    c = _summa_set(tmp_path)
    rng = np.random.default_rng(2)
    a = rng.integers(-4, 4, (512, 64)).astype(np.float32)
    rhs = rng.integers(-4, 4, (64, 32)).astype(np.float32)
    c.send_matrix("d", "m", a)
    ident = SetIdentifier("d", "m")
    pm = next(i for i in c.store.get_items(ident)
              if type(i).__name__ == "_PagedMatrix")
    ps = c.store.page_store()
    cache = c.store.device_cache()
    base = summa_matmul_streamed(ps, pm.name, rhs, devices=four,
                                 cache=cache, cache_scope=str(ident))
    assert np.array_equal(base.numpy(), a @ rhs)
    moved0 = obs.REGISTRY.counter("reshard.blocks_moved").value
    rep = reshard_summa_layout(c.store, ident, four, four, dst_grid=(2, 2))
    assert rep.blocks_moved > 0 and rep.bytes_moved > 0
    assert obs.REGISTRY.counter("reshard.blocks_moved").value == \
        moved0 + rep.blocks_moved
    reads0 = ps.stats()["page_reads"]
    warm = {}
    out = summa_grid_matmul_streamed(ps, pm.name, rhs, devices=four,
                                     grid=(2, 2), cache=cache,
                                     cache_scope=str(ident), stats_out=warm)
    assert out.numpy().tobytes() == base.numpy().tobytes()
    assert ps.stats()["page_reads"] == reads0
    assert warm["staged_bytes_total"] <= rhs.nbytes
    rep2 = reshard_summa_layout(c.store, ident, four, four, src_grid=(2, 2))
    assert rep2.blocks_moved == rep.blocks_moved
    o1 = summa_matmul_streamed(ps, pm.name, rhs, devices=four, cache=cache,
                               cache_scope=str(ident))
    assert o1.numpy().tobytes() == base.numpy().tobytes()
    assert ps.stats()["page_reads"] == reads0
    assert staging.active_count() == 0


def test_reshard_summa_layout_guards(tmp_path, four):
    c = _summa_set(tmp_path)
    c.send_matrix("d", "m",
                  np.arange(64 * 32, dtype=np.float32).reshape(64, 32))
    with pytest.raises(ValueError, match="equal participant counts"):
        reshard_summa_layout(c.store, SetIdentifier("d", "m"), four,
                             four[:2])
    with pytest.raises(ValueError, match="equal participant counts"):
        reshard_summa_layout(c.store, SetIdentifier("d", "m"), four, four,
                             src_grid=(2, 2), dst_grid=(1, 2))
    c.create_set("d", "mem", type_name="tensor")
    c.send_matrix("d", "mem", np.eye(8, dtype=np.float32))
    with pytest.raises(ValueError, match="no paged matrix"):
        reshard_summa_layout(c.store, SetIdentifier("d", "mem"), four,
                             four)
