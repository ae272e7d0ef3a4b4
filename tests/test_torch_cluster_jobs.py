"""Jobs over sets placed across two joined processes, on the CPU: the
counterparts of the reference's ``tests/test_multihost_smoke.py:181``
(a placed Q01 through ``Client``), ``:417`` (a paged and placed Q01) and
``:592`` (FF over paged weight sets placed over the mesh), and the
sequence-parallel layer with its ring split across the processes.

Every process runs the same client program (SPMD) over the 8 global
positions, 4 its own (2 for the layer, over 4). The harness is
``tests/test_torch_cluster_bringup.run_pair``. Each result is held
against a numpy oracle, against the reference's one-process run on
``tests/conftest.py``'s 8 CPU devices (integers exactly, float sums
within ``SUM_RTOL``, the layer within ``LAYER_TOL``), and against the
port's one-process run over the same positions, bit for bit.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.models.ff import FFModel as JaxFF
from netsdb_tpu.models.transformer import TransformerLayerModel as JaxLayer
from netsdb_tpu.models.transformer import TransformerLayerParams as JaxParams
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu.parallel.placement import Placement as JaxPlacement
from netsdb_tpu.plan.executor import clear_compiled_cache
from netsdb_tpu.relational import dag as jdag
from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.models.transformer import TransformerLayerModel
from netsdb_tpu_torch.parallel.mesh import virtual_devices
from netsdb_tpu_torch.parallel.placed_ops import dense
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.relational import dag
from netsdb_tpu_torch.relational.queries import tables_from_rows
from netsdb_tpu_torch.workloads import tpch
from tests.test_torch_cluster_bringup import run_pair

SUM_RTOL = 1e-5    # float aggregates against the reference's own order
ORACLE_RTOL = 1e-4  # against the f64 row oracle (the reference test's)
FF_TOL = 1e-4      # FF probabilities against numpy (the reference's)
LAYER_TOL = 1e-4   # the layer against the reference's (test_transformer_sp)
Q01_COLS = ("count", "l_linestatus", "l_returnflag", "sum_base_price",
            "sum_charge", "sum_disc", "sum_disc_price", "sum_qty")


def q01_oracle(rows):
    """Counts and f64 charge sums of Q01's groups, from the raw rows."""
    counts, charge = collections.Counter(), collections.Counter()
    for r in rows:
        if r["l_shipdate"] <= "1998-09-02":
            key = (r["l_returnflag"], r["l_linestatus"])
            counts[key] += 1
            charge[key] += (r["l_extendedprice"] * (1 - r["l_discount"])
                            * (1 + r["l_tax"]))
    return counts, charge


def q01_groups(cols, dicts):
    """{(returnflag, linestatus): (count, sum_charge)} of a Q01 output."""
    rf, ls = dicts["l_returnflag"], dicts["l_linestatus"]
    return {(rf[int(cols["l_returnflag"][i])],
             ls[int(cols["l_linestatus"][i])]):
            (int(cols["count"][i]), float(cols["sum_charge"][i]))
            for i in range(len(cols["count"])) if cols["count"][i]}


def port_q01(root, rows, paged: bool):
    """The port's one-process Q01 over 8 positions of the CPU."""
    cfg = dict(page_size_bytes=4096, page_pool_bytes=16384) if paged else {}
    with virtual_devices(8, "cpu"):
        c = Client(Configuration(root_dir=str(root), **cfg), device="cpu")
        c.create_database("tpch")
        c.create_set("tpch", "lineitem", type_name="table",
                     storage="paged" if paged else "memory",
                     placement=Placement((("data", 8),), ("data",)))
        c.send_table("tpch", "lineitem",
                     tables_from_rows({"lineitem": rows},
                                      device="cpu")["lineitem"]
                     if paged else rows)
        res = dag.run_query(c, dag.q01_sink("tpch"))
        return {k: res.cols[k].numpy() for k in Q01_COLS}, res.dicts


def jax_q01(root, rows):
    """The reference's one-process placed Q01 on conftest's 8 devices."""
    clear_compiled_cache()
    j = JaxClient(JaxConfiguration(root_dir=str(root)))
    j.create_database("tpch")
    j.create_set("tpch", "lineitem", type_name="table",
                 placement=JaxPlacement((("data", 8),), ("data",)))
    j.send_table("tpch", "lineitem", rows)
    res = jdag.run_query(j, jdag.q01_sink("tpch"))
    return {k: np.asarray(res[k]) for k in Q01_COLS}, res.dicts


_Q01 = """
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.parallel.mesh import RemoteShardsError
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.queries import tables_from_rows
    from netsdb_tpu_torch.workloads import tpch

    paged = extra[0] == "paged"
    cfg = dict(page_size_bytes=4096, page_pool_bytes=16384) if paged else {}
    c = Client(Configuration(root_dir=os.path.join(OUT_DIR, f"c{pid}"),
                             **cfg), device="cpu")
    c.create_database("tpch")
    c.create_set("tpch", "lineitem", type_name="table",
                 storage="paged" if paged else "memory",
                 placement=Placement((("data", 8),), ("data",)))
    rows = tpch.generate(scale=int(extra[1]), seed=int(extra[2]))["lineitem"]
    c.send_table("tpch", "lineitem",
                 tables_from_rows({"lineitem": rows}, device="cpu")[
                     "lineitem"] if paged else rows)
    if not paged:
        # this process keeps its own 4 blocks of the 8
        tab = c.get_table("tpch", "lineitem")
        col = next(iter(tab.cols.values()))
        assert col.mesh.spans_processes and col.mesh.size == 8
        assert sum(t is not None for t in col.shards.flat) == 4
        try:
            col.to_dense()
            raise SystemExit("read blocks another process holds")
        except RemoteShardsError:
            pass
    res = dag.run_query(c, dag.q01_sink("tpch"))
    for k in ("count", "l_linestatus", "l_returnflag", "sum_base_price",
              "sum_charge", "sum_disc", "sum_disc_price", "sum_qty"):
        save(k, res.cols[k])
    if paged:
        st = c.store.page_store().stats()
        assert st["spills"] > 0 and st["loads"] > 0, st
    D.shutdown_cluster()
    print("Q01", pid, "OK")
"""


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_placed_q01_across_two_processes(tmp_path, paged):
    """``:181`` (resident, SF 1, seed 4) and ``:417`` (paged and placed in
    a 16 KiB arena, spills in both processes, SF 4, seed 9)."""
    scale, seed = (4, 9) if paged else (1, 4)
    got = run_pair(tmp_path, _Q01, "Q01",
                   extra_args=("paged" if paged else "resident", scale,
                               seed))
    rows = tpch.generate(scale=scale, seed=seed)["lineitem"]
    one, dicts = port_q01(tmp_path / "one", rows, paged)
    counts, charge = q01_oracle(rows)
    want, jdicts = jax_q01(tmp_path / "jax", rows)
    assert jdicts["l_returnflag"] == dicts["l_returnflag"]
    assert jdicts["l_linestatus"] == dicts["l_linestatus"]
    for pid in (0, 1):
        cols = {k: got[f"{k}_{pid}"] for k in Q01_COLS}
        for k in Q01_COLS:
            np.testing.assert_array_equal(cols[k], one[k])
            if k in ("count", "l_returnflag", "l_linestatus"):
                np.testing.assert_array_equal(cols[k], want[k])
            else:
                np.testing.assert_allclose(cols[k], want[k], rtol=SUM_RTOL)
        groups = q01_groups(cols, dicts)
        assert {g: n for g, (n, _) in groups.items()} == dict(counts)
        for g, (_, s) in groups.items():
            assert abs(s - charge[g]) <= ORACLE_RTOL * abs(charge[g])


_FF = """
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.parallel import _transport
    from netsdb_tpu_torch.parallel.placed_ops import dense
    from netsdb_tpu_torch.parallel.placement import Placement

    c = Client(Configuration(root_dir=os.path.join(OUT_DIR, f"c{pid}"),
                             page_size_bytes=4096, page_pool_bytes=16384),
               device="cpu")
    m = FFModel(db="ff", block=(32, 32))
    m.setup(c, placements={"w1": Placement((("model", 8),),
                                           (None, "model"))},
            storages={"w1": "paged", "wo": "paged"})
    F, H, L, B = 96, 128, 10, 32
    m.load_random_weights(c, F, H, L, seed=0)
    x = np.random.default_rng(1).standard_normal((B, F)).astype(np.float32)
    m.load_inputs(c, x)
    save("out", dense(m.inference(c)))
    assert c.store.page_store().stats()["spills"] > 0
    # the per-block psums crossed the processes
    assert _transport.stats()["messages"] > 0
    D.shutdown_cluster()
    print("FF", pid, "OK")
"""


def test_ff_over_paged_weight_sets_across_two_processes(tmp_path):
    """``:592``: w1 and wo stream from each process's 16 KiB arena, every
    w1 block placed over the 8 global positions before its step, and the
    per-block psums run in both processes."""
    got = run_pair(tmp_path, _FF, "FF")
    F, H, L, B = 96, 128, 10, 32
    x = np.random.default_rng(1).standard_normal((B, F)).astype(np.float32)
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((H, F), dtype=np.float32) * np.sqrt(2.0 / F)
    b1 = rng.standard_normal((H,), dtype=np.float32) * 0.01
    wo = rng.standard_normal((L, H), dtype=np.float32) * np.sqrt(2.0 / H)
    bo = rng.standard_normal((L,), dtype=np.float32) * 0.01
    h = np.maximum(w1 @ x.T + b1[:, None], 0)
    yo = wo @ h + bo[:, None]
    e = np.exp(yo - yo.max(0))
    oracle = e / e.sum(0)
    placements = {"w1": ((("model", 8),), (None, "model"))}
    storages = {"w1": "paged", "wo": "paged"}
    with virtual_devices(8, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "one"),
                                 page_size_bytes=4096,
                                 page_pool_bytes=16384), device="cpu")
        m = FFModel(db="ff", block=(32, 32))
        m.setup(c, placements={k: Placement(*v)
                               for k, v in placements.items()},
                storages=storages)
        m.load_random_weights(c, F, H, L, seed=0)
        m.load_inputs(c, x)
        one = dense(m.inference(c)).numpy()
    clear_compiled_cache()
    j = JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax"),
                                   page_size_bytes=4096,
                                   page_pool_bytes=16384))
    jm = JaxFF(db="ff", block=(32, 32))
    jm.setup(j, placements={k: JaxPlacement(*v)
                            for k, v in placements.items()},
             storages=storages)
    jm.load_random_weights(j, F, H, L, seed=0)
    jm.load_inputs(j, x)
    want = np.asarray(jm.inference(j).to_dense())
    for pid in (0, 1):
        out = got[f"out_{pid}"]
        np.testing.assert_array_equal(out, one)
        np.testing.assert_allclose(out, want, rtol=FF_TOL, atol=FF_TOL)
        assert np.abs(out - oracle).max() <= FF_TOL


_SP = """
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel
    from netsdb_tpu_torch.parallel.placement import Placement

    c = Client(Configuration(root_dir=os.path.join(OUT_DIR, f"c{pid}")),
               device="cpu")
    m = TransformerLayerModel(db="sp", num_heads=4)
    axes = (("sp", 4),)
    m.setup(c, placements={s: Placement(axes, (None, None))
                           for s in TransformerLayerModel.SETS})
    m.load_random_weights(c, embed=32, seed=0)
    x = np.random.default_rng(1).standard_normal((2, 64, 32)).astype(
        np.float32)
    m.load_inputs(c, x, placement=Placement(axes, (None, "sp", None)))
    y = m.serve_forward(c)
    assert y.mesh.spans_processes
    assert sum(t is not None for t in y.shards.flat) == 2
    save("y", y.gather_global())
    D.shutdown_cluster()
    print("SP", pid, "OK")
"""


def test_sequence_parallel_layer_across_two_processes(tmp_path):
    """The layer through ``Client`` over ("sp", 4), two positions a
    process: its ring crosses the processes at two of the four links."""
    got = run_pair(tmp_path, _SP, "SP", positions=2)
    x = np.random.default_rng(1).standard_normal((2, 64, 32)).astype(
        np.float32)
    axes = (("sp", 4),)
    with virtual_devices(4, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path / "one")),
                   device="cpu")
        m = TransformerLayerModel(db="sp", num_heads=4)
        m.setup(c, placements={s: Placement(axes, (None, None))
                               for s in TransformerLayerModel.SETS})
        m.load_random_weights(c, embed=32, seed=0)
        m.load_inputs(c, x, placement=Placement(axes, (None, "sp", None)))
        one = m.serve_forward(c).to_dense().numpy()
        w = {n: dense(c.get_tensor("sp", n)).numpy()
             for n in TransformerLayerModel.SETS}
    jmesh = jmake_mesh((4,), ("sp",), jax.devices()[:4])
    jx = jax.device_put(jnp.asarray(x),
                        NamedSharding(jmesh, P(None, "sp", None)))
    want = np.asarray(JaxLayer(num_heads=4).forward_sp(
        JaxParams(**{n: jnp.asarray(a) for n, a in w.items()}), jx, jmesh,
        axis="sp", causal=True))
    for pid in (0, 1):
        np.testing.assert_array_equal(got[f"y_{pid}"], one)
        np.testing.assert_allclose(got[f"y_{pid}"], want, rtol=LAYER_TOL,
                                   atol=LAYER_TOL)
