"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, its client runs on CUDA unless told otherwise, and what the
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
             or m == "netsdb_tpu" or m.startswith("netsdb_tpu."))
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
    assert int(count) >= 61  # every module of the package was imported
    for mod in ("table", "kernels", "tuning", "stats", "planner", "queries",
                "folds", "dag", "bench"):
        assert f"'netsdb_tpu_torch.relational.{mod}'" in relational
    assert bad == "[]", f"the port pulled in {bad}"


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


@pytest.mark.parametrize("kwargs", [dict(type_name="object", storage="paged"),
                                    dict(type_name="relation",
                                         storage="paged"),
                                    dict(type_name="object", storage="paged",
                                         persistence="persistent",
                                         placement=Placement.replicated())])
def test_out_of_slice_set_options_raise(port_client, kwargs):
    """Paged object sets and relations are ROADMAP.md A6; a paged or
    persistent tensor set is ported (``tests/test_torch_paged_weights.py``)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        port_client.create_set("d", "s", **kwargs)
    assert not port_client.catalog.set_exists("d", "s")
    port_client.create_set("d", "s", storage="paged",
                           persistence="persistent")
    assert port_client.store.storage_of(SetIdentifier("d", "s")) == "paged"


def test_out_of_slice_client_features_raise(port_client, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        Client(address="localhost:1", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        Configuration(distributed_matmul=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        Configuration(summa_grid="2d")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        Configuration(device_cache_pin_auto=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        Configuration(device_cache_dirty_log=8)
    for knob in (dict(plan_fusion=True), dict(fusion_min_region=2),
                 dict(fusion_mapper="dp"), dict(fusion_cost_source="ledger"),
                 dict(fusion_stage_budget_bytes=1 << 20)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A2"):
            Configuration(**knob)
    with pytest.raises(ValueError, match="bucket_density"):
        Configuration(bucket_density=3)
    with pytest.raises(ValueError, match="storage"):
        port_client.create_set("d", "s", storage="disk")
    # flush_data is ported: with no persistent set it writes nothing
    port_client.flush_data()
    assert not (tmp_path / "port").exists()


def test_tensor_fold_is_not_ported():
    """``tensor_fold`` is ported; its distributed branch (``summa_rhs``
    under ``distributed_matmul``, ROADMAP.md A4) is not: the fold keeps
    ``summa_rhs`` and the configuration that would use it raises."""
    scan = ScanSet("d", "s")
    fold = TensorFold(mode="rows", summa_rhs=lambda x: x)
    assert Apply(scan, lambda x: x, tensor_fold=fold).tensor_fold is fold
    assert Join(scan, scan, lambda a, b: a,
                tensor_fold=fold).tensor_fold is fold
    with pytest.raises(ValueError, match="mode"):
        TensorFold(mode="columns")
    with pytest.raises(ValueError, match="partial"):
        TensorFold(mode="reduce")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A4"):
        Configuration(distributed_matmul=True)


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
