"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package (nor ``msgpack`` or ``cloudpickle``: its wire codecs are its
own), its client runs on CUDA unless told otherwise, and what the
port does not cover yet raises ``NotImplementedError`` naming its
ROADMAP.md item instead of being ignored."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet
from netsdb_tpu_torch.plan.fold import TensorFold
from netsdb_tpu_torch.storage.store import SetIdentifier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import netsdb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(netsdb_tpu_torch.__path__,
                                               "netsdb_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "netsdb_tpu" or m.startswith("netsdb_tpu.")
             or m.split(".")[0] in ("msgpack", "cloudpickle"))
relational = sorted(n for n in names if ".relational." in n)
print(len(names), relational, bad)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    count, rest = proc.stdout.strip().split(" ", 1)
    relational, bad = rest.rsplit("] ", 1)
    assert int(count) >= 62  # every module of the package was imported
    for mod in ("table", "kernels", "tuning", "stats", "planner", "queries",
                "folds", "dag", "bench", "outofcore", "autojoin", "sharded",
                "shuffle"):
        assert f"'netsdb_tpu_torch.relational.{mod}'" in relational
    assert bad == "[]", f"the port pulled in {bad}"


def test_host_record_modules_import_no_jax_and_nothing_of_the_jax_package():
    """The host-record slice (dispatcher, parser, the tblparse binding and
    the row workloads) on its own, in a fresh interpreter."""
    mods = ["netsdb_tpu_torch.storage.dispatcher",
            "netsdb_tpu_torch.plan.parser",
            "netsdb_tpu_torch.relational.autojoin",
            "netsdb_tpu_torch.native.tblparse",
            "netsdb_tpu_torch.workloads.tpch",
            "netsdb_tpu_torch.workloads.tpch_bench",
            "netsdb_tpu_torch.workloads.tpch_bench_columnar",
            "netsdb_tpu_torch.workloads.reddit",
            "netsdb_tpu_torch.workloads.reddit_columnar"]
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'netsdb_tpu' or "
             "m.startswith('netsdb_tpu.')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_mesh_modules_import_no_jax_and_nothing_of_the_jax_package():
    """The in-process mesh (collectives, Ulysses, SUMMA, resharding,
    row-sharded relations and the row shuffle) on its own, in a fresh
    interpreter."""
    mods = ["netsdb_tpu_torch.parallel",
            "netsdb_tpu_torch.parallel.collectives",
            "netsdb_tpu_torch.parallel.ring",
            "netsdb_tpu_torch.parallel.summa",
            "netsdb_tpu_torch.parallel.reshard",
            "netsdb_tpu_torch.relational.sharded",
            "netsdb_tpu_torch.relational.shuffle"]
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'netsdb_tpu' or "
             "m.startswith('netsdb_tpu.')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_replication_modules_import_no_jax_and_nothing_of_the_jax_package():
    """The replication slice's own copies of host-only reference code —
    fault injection, HA terms, the mutation log and checkpoints — and
    the daemon that uses them, on their own in a fresh interpreter (the
    package-wide probe above walks them too)."""
    mods = ["netsdb_tpu_torch.serve.chaos",
            "netsdb_tpu_torch.serve.ha",
            "netsdb_tpu_torch.storage.mutlog",
            "netsdb_tpu_torch.storage.checkpoint",
            "netsdb_tpu_torch.serve.server"]
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'netsdb_tpu' or "
             "m.startswith('netsdb_tpu.')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_single_device_workload_and_dedup_modules_import_no_jax():
    """The workloads of ROADMAP.md A8 part 1, the MoE layer, the sampler
    and the dedup package on their own, in a fresh interpreter."""
    mods = ["netsdb_tpu_torch.utils.sampler",
            "netsdb_tpu_torch.workloads.kmeans",
            "netsdb_tpu_torch.workloads.gmm",
            "netsdb_tpu_torch.workloads.lda",
            "netsdb_tpu_torch.workloads.pagerank",
            "netsdb_tpu_torch.workloads.topk",
            "netsdb_tpu_torch.workloads.conv_fusion",
            "netsdb_tpu_torch.models.moe",
            "netsdb_tpu_torch.dedup",
            "netsdb_tpu_torch.dedup.detector",
            "netsdb_tpu_torch.dedup.lsh",
            "netsdb_tpu_torch.dedup.pool"]
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'netsdb_tpu' or "
             "m.startswith('netsdb_tpu.')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("knob,value,item", [
    ("mesh_shape", (2, 4), "A4"), ("mesh_axis_names", ("x",), "A4"),
    ("summa_participants", 4, "A4"), ("sched_feedback", True, "A8"),
    ("sched_slo_shed", True, "A8"), ("ha_election_timeout_s", 1.0, "A7"),
    ("ha_mutlog", True, "A7"), ("rebalance", True, "A7"),
    ("device_cache_pin_auto", True, "A7"), ("rebalance_windows", 5, "A7"),
    ("obs_enabled", False, "A8"), ("obs_trace_sample", 4, "A8"),
    ("lock_witness", True, "A8")])
def test_later_configuration_knobs_raise(knob, value, item):
    """The A4 knobs (the mesh and SUMMA) were ported with the in-process
    mesh, and the observability knobs and the scheduler's feedback with
    the observability part of A8, the HA knobs with the replication part
    of A7: all are taken as given. The lock witness (the rest of A8) and
    the rebalancing knobs of A7 still raise."""
    if item == "A4" or (item == "A8" and knob != "lock_witness") \
            or knob.startswith("ha_"):
        assert getattr(Configuration(**{knob: value}), knob) == value
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        Configuration(**{knob: value})


def test_placed_conv_fusion_and_expert_parallel_moe_raise(tmp_path):
    """Both once raised naming ROADMAP.md A4 part 3 and are ported: a
    placed conv set is created placed on the CPU positions asked for,
    and expert-parallel MoE runs on them (equal to ``mesh=None``)."""
    from netsdb_tpu_torch.models.moe import init_moe_params, moe_forward
    from netsdb_tpu_torch.parallel.mesh import make_mesh, virtual_devices
    from netsdb_tpu_torch.workloads.conv_fusion import ConvFusionPipeline

    params = init_moe_params(4, 8, 2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 4)).astype(np.float32))
    with virtual_devices(2, "cpu"):
        c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
        ConvFusionPipeline(db="cf").setup(c, placements={
            "image_flat": Placement.data_parallel(ndim=2)})
        pl = c.store.placement_of(SetIdentifier("cf", "image_flat"))
        assert pl == Placement.data_parallel(ndim=2)
        assert all(d.type == "cpu" for d in pl.mesh().devices.flat)
        ep = moe_forward(params, x, 2.0, make_mesh((2,), ("model",)),
                         "model")
    np.testing.assert_allclose(ep.numpy(),
                               moe_forward(params, x, 2.0).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_new_entry_points_default_to_cuda_and_never_fall_back():
    from netsdb_tpu_torch.dedup.lsh import bench_lsh_zoo
    from netsdb_tpu_torch.models.moe import init_moe_params
    from netsdb_tpu_torch.workloads.pagerank import pagerank

    calls = [lambda **kw: init_moe_params(4, 8, 2, **kw).w_gate.device,
             lambda **kw: pagerank(np.asarray([0, 1]), np.asarray([1, 0]),
                                   2, **kw).device,
             lambda **kw: bench_lsh_zoo(n_models=2, blocks_per_model=1,
                                        block=8, n_families=1,
                                        **kw) and torch.device(
                 kw.get("device", "cuda"))]
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert call(device="cpu").type == "cpu"


@pytest.mark.parametrize("mods", [
    ["netsdb_tpu_torch.obs", "netsdb_tpu_torch.obs.metrics",
     "netsdb_tpu_torch.obs.trace", "netsdb_tpu_torch.obs.operators"],
    ["netsdb_tpu_torch.plan.fusion", "netsdb_tpu_torch.plan.programs",
     "netsdb_tpu_torch.plan.executor"],
    ["netsdb_tpu_torch.obs.attrib", "netsdb_tpu_torch.obs.slo",
     "netsdb_tpu_torch.obs.slowlog", "netsdb_tpu_torch.obs.history",
     "netsdb_tpu_torch.obs.export", "netsdb_tpu_torch.obs.devclock",
     "netsdb_tpu_torch.utils.profiling", "netsdb_tpu_torch.utils.timing",
     "netsdb_tpu_torch.utils.compare"]])
def test_compiled_plan_modules_import_no_jax_and_nothing_of_the_jax_package(
        mods):
    """The observability parts and the compiled-plan modules (the program
    cache, the fusion mapper) on their own, in a fresh interpreter; the
    ``obs`` modules import nothing but the standard library."""
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'netsdb_tpu' or "
             "m.startswith('netsdb_tpu.')), 'torch' in sys.modules)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().rsplit(" ", 1)[0] == "[]"
    if mods[0] == "netsdb_tpu_torch.obs":
        # the package's __init__ brings the client (and torch); the obs
        # modules themselves import no third-party module
        import pathlib

        for name in ("metrics", "trace", "operators", "__init__", "attrib",
                     "slo", "slowlog", "history", "export"):
            src = (pathlib.Path(REPO) / "netsdb_tpu_torch" / "obs"
                   / f"{name}.py").read_text()
            assert "import torch" not in src and "numpy" not in src


def test_nothing_raises_naming_a6():
    """The relational engine is ported whole on one device: no message
    of the package still names A6."""
    import pathlib

    pkg = pathlib.Path(REPO) / "netsdb_tpu_torch"
    hits = [str(p.relative_to(REPO)) for p in pkg.rglob("*.py")
            if "ROADMAP.md A6" in p.read_text()]
    assert hits == []


def test_client_defaults_to_cuda_and_never_falls_back(tmp_path):
    config = Configuration(root_dir=str(tmp_path / "port"))
    if torch.cuda.is_available():
        assert Client(config).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Client(config)
    assert Client(config, device="cpu").device.type == "cpu"


def test_carried_weights_default_to_cuda_and_never_fall_back():
    from netsdb_tpu_torch.weights import (blocked_from_numpy,
                                          conv_arrays_to_device,
                                          logreg_params_from_numpy,
                                          lstm_params_from_numpy,
                                          transformer_params_from_numpy)

    eye = np.eye(4, dtype=np.float32)
    dense = dict(w_qkv=np.zeros((4, 12), np.float32), w_out=eye,
                 w_up=np.zeros((4, 16), np.float32),
                 w_down=np.zeros((16, 4), np.float32))
    padded = (eye, (4, 4), (2, 2))
    gates = {f"{k}_{g}": padded for k in "wub" for g in "ifco"}
    calls = [lambda **kw: blocked_from_numpy(eye, (4, 4), (2, 2), **kw),
             lambda **kw: transformer_params_from_numpy(dense, **kw).w_out,
             lambda **kw: logreg_params_from_numpy(
                 {"w": padded, "b": padded}, **kw).w,
             lambda **kw: lstm_params_from_numpy(gates, **kw).u_o,
             lambda **kw: conv_arrays_to_device(
                 np.zeros((1, 1, 4, 4)), eye[None, None], **kw)[1]]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert call(device="cpu").device.type == "cpu"


def _la_constructors():
    from netsdb_tpu_torch.dsl import LAInterpreter, run_pdml
    from netsdb_tpu_torch.graft_entry import entry
    from netsdb_tpu_torch.ops import linalg
    from netsdb_tpu_torch.workloads import make_inputs

    return {
        "identity": lambda **kw: linalg.identity(4, 2, **kw).device,
        "zeros": lambda **kw: linalg.zeros(4, 4, 2, 2, **kw).device,
        "ones": lambda **kw: linalg.ones(4, 4, 2, 2, **kw).device,
        "make_inputs": lambda **kw: make_inputs("gram", 8, 4, 2,
                                                **kw)["X"].device,
        "LAInterpreter": lambda **kw: LAInterpreter(**kw).device,
        "run_pdml": lambda **kw: run_pdml("A = ones(2,2,1,1)",
                                          **kw)["A"].device,
        "entry": lambda **kw: entry(**kw)[1][1].device,
    }


@pytest.mark.parametrize("name", ["identity", "zeros", "ones", "make_inputs",
                                  "LAInterpreter", "run_pdml", "entry"])
def test_la_and_entry_constructors_default_to_cuda_and_never_fall_back(name):
    """The LA op set's constructors, the LA tasks' inputs, the DSL
    interpreter and the port's ``graft_entry.entry`` put what they make on
    CUDA unless asked, and raise where there is no card."""
    call = _la_constructors()[name]
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert call(device="cpu").type == "cpu"


def test_client_writes_nothing_to_its_root_dir(tmp_path):
    Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    assert not (tmp_path / "port").exists()


@pytest.fixture()
def port_client(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "port")), device="cpu")
    c.create_database("d")
    return c


@pytest.mark.parametrize("kwargs,exc,item", [
    (dict(type_name="table", storage="paged",
          placement=Placement.data_parallel(ndim=1)), NotImplementedError,
     "ROADMAP.md A4"),
    (dict(type_name="object", eviction="fifo"), ValueError, "eviction"),
    (dict(type_name="table", storage="paged", eviction="random",
          placement=Placement.replicated()), NotImplementedError,
     "ROADMAP.md A4")])
def test_out_of_slice_set_options_raise(port_client, kwargs, exc, item):
    """A paged and placed relation (once ROADMAP.md A4) is ported, and an
    eviction policy the reference lacks is an error; set eviction (``lru``,
    ``mru``, ``random``: ``tests/test_torch_eviction.py``), paged object
    sets (``tests/test_torch_paged_objects.py``), paged or persistent
    tensor sets (``tests/test_torch_paged_weights.py``), paged relations
    (``tests/test_torch_paged_relations.py``) and the dispatcher's
    ``partition_lambda`` are ported."""
    if item == "ROADMAP.md A4":  # ported: the relation's chunks are placed
        port_client.create_set("d", "s", **kwargs)
        port_client.send_table("d", "s", [{"k": 1, "v": 2.0}])
        assert port_client.store.placement_of(SetIdentifier("d", "s")) \
            == kwargs["placement"]
        port_client.remove_set("d", "s")
    else:
        with pytest.raises(exc, match=item):
            port_client.create_set("d", "s", **kwargs)
    assert not port_client.catalog.set_exists("d", "s")
    port_client.create_set("d", "s", storage="paged",
                           persistence="persistent")
    assert port_client.store.storage_of(SetIdentifier("d", "s")) == "paged"
    port_client.create_set("d", "t", type_name="table", storage="paged")
    port_client.send_table("d", "t", [{"k": 1, "v": 2.0}])
    assert port_client.store.paged_relation(
        SetIdentifier("d", "t")).num_rows == 1
    for name, kw in (("o", dict(type_name="object", storage="paged")),
                     ("r", dict(type_name="relation", storage="paged")),
                     ("pl", dict(type_name="object", storage="paged",
                                 placement=Placement.replicated(),
                                 partition_lambda="by_k"))):
        port_client.create_set("d", name, **kw)
        port_client.send_data("d", name, [{"k": 1}, {"k": 2}])
        assert list(port_client.get_set_iterator("d", name)) == \
            [{"k": 1}, {"k": 2}]
    assert port_client.catalog.get_set("d", "pl")["meta"][
        "partition_lambda"] == "by_k"


def test_out_of_slice_client_features_raise(port_client, tmp_path):
    # Client(address=) is the served client (tests/test_torch_serve.py);
    # replicas with hedged reads are ported (tests/test_torch_serve_
    # dataplane.py) and need an address to hedge from
    with pytest.raises(ValueError, match="replicas= needs address="):
        Client(replicas=["localhost:2"])
    # the distributed matmul's knobs are ported (tests/test_torch_summa.py);
    # a malformed grid raises where it is read, as in the reference
    assert Configuration(distributed_matmul=True).distributed_matmul
    from netsdb_tpu_torch.parallel.summa import grid_shape

    with pytest.raises(ValueError, match="PRxPC"):
        grid_shape(Configuration(summa_grid="2d"), 4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        Configuration(device_cache_pin_auto=True)
    # the dirty-range log of paged relations is ported: the knob bounds it
    # (tests/test_torch_paged_relations.py::test_dirty_log_is_bounded)
    assert Configuration(device_cache_dirty_log=8).device_cache_dirty_log \
        == 8
    with pytest.raises(ValueError, match="device_cache_dirty_log"):
        Configuration(device_cache_dirty_log=0)
    # the fusion knobs are ported with the reference's defaults and
    # checks (tests/test_torch_fusion.py)
    cfg = Configuration()
    assert (cfg.plan_fusion, cfg.fusion_min_region, cfg.fusion_cost_source,
            cfg.fusion_mapper, cfg.fusion_stage_budget_bytes) == \
        (True, 2, "ledger", "optimal", 0)
    for knob, name in ((dict(fusion_mapper="dp"), "fusion_mapper"),
                       (dict(fusion_cost_source="x"), "fusion_cost_source"),
                       (dict(fusion_stage_budget_bytes=-1),
                        "fusion_stage_budget_bytes")):
        with pytest.raises(ValueError, match=name):
            Configuration(**knob)
    with pytest.raises(ValueError, match="bucket_density"):
        Configuration(bucket_density=3)
    with pytest.raises(ValueError, match="storage"):
        port_client.create_set("d", "s", storage="disk")
    # flush_data is ported: with no persistent set it writes nothing
    port_client.flush_data()
    assert not (tmp_path / "port").exists()


def test_tensor_fold_is_not_ported():
    """``tensor_fold`` is ported, and so is its distributed branch (once
    ROADMAP.md A4: ``summa_rhs`` under ``distributed_matmul``,
    tests/test_torch_summa.py): the fold keeps ``summa_rhs`` and the
    configuration that uses it is accepted."""
    scan = ScanSet("d", "s")
    fold = TensorFold(mode="rows", summa_rhs=lambda x: x)
    assert Apply(scan, lambda x: x, tensor_fold=fold).tensor_fold is fold
    assert Join(scan, scan, lambda a, b: a,
                tensor_fold=fold).tensor_fold is fold
    with pytest.raises(ValueError, match="mode"):
        TensorFold(mode="columns")
    with pytest.raises(ValueError, match="partial"):
        TensorFold(mode="reduce")
    assert fold.summa_rhs(3) == 3
    assert Configuration(distributed_matmul=True,
                         summa_participants=4).summa_participants == 4


def test_model_setup_forwards_out_of_slice_options(port_client):
    """``storages`` reach ``create_set``: "paged" makes a paged set and an
    unknown storage raises there."""
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    FFModel().setup(port_client, storages={"w1": "paged"})
    assert port_client.store.storage_of(SetIdentifier("ff", "w1")) == "paged"
    assert port_client.store.storage_of(SetIdentifier("ff", "wo")) == "memory"
    TransformerLayerModel().setup(port_client, storages={"w_qkv": "paged"})
    assert port_client.store.storage_of(
        SetIdentifier("transformer", "w_qkv")) == "paged"
    with pytest.raises(ValueError, match="storage"):
        TransformerLayerModel(db="t2").setup(port_client,
                                             storages={"w_up": "disk"})


def test_store_keeps_results_on_the_client_device(port_client):
    port_client.create_set("d", "m")
    t = port_client.send_matrix("d", "m", np.ones((3, 3)), (2, 2))
    assert t.device == port_client.device and t.dtype == torch.float32
    with pytest.raises(KeyError, match="create_database"):
        port_client.create_set("nope", "s")
    with pytest.raises(KeyError, match="create_set"):
        port_client.send_data("d", "missing", [1])


def test_no_port_source_imports_jax_the_jax_package_msgpack_or_cloudpickle():
    """Every import statement of the port and of ``chip_smoke.py`` —
    function-level ones included — names none of ``jax``, ``netsdb_tpu``,
    ``msgpack`` or ``cloudpickle``; and the serving modules load in a
    fresh interpreter without them."""
    import ast
    import pathlib

    banned = {"jax", "jaxlib", "netsdb_tpu", "msgpack", "cloudpickle"}
    files = sorted((pathlib.Path(REPO) / "netsdb_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(REPO) / "chip_smoke.py")
    hits = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    hits.append(f"{path.relative_to(REPO)}:{node.lineno} "
                                f"{name}")
    assert hits == []
    mods = ["netsdb_tpu_torch.serve", "netsdb_tpu_torch.serve.server",
            "netsdb_tpu_torch.serve.sessions",
            "netsdb_tpu_torch.models.decode", "chip_smoke"]
    probe = ("import importlib, sys\n"
             f"for m in {mods!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{sorted(banned)!r}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
