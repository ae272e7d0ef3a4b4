"""Shipped type sources on the CPU: a type registered with its module's
source binds on a daemon that never installed the module — the
reference's replicated user-type .so (``PDBCatalog.h:45-50``).

A torch UDF shipped with ``register_type(source=...)`` runs through
``execute_plan`` and equals the reference daemon's JAX twin on the same
matrix; ``ship_module=True`` reads a file module's source; two handler
threads binding one shipped type exec its module once; a follower
resynced by a snapshot binds the same type from the catalog rows the
snapshot carries; the in-process ``Client`` and the catalog keep the
source. Every daemon listens on port 0 and is shut down in
``finally``."""

import importlib
import sys
import threading
import types

import numpy as np
import pytest

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.serve.client import RemoteClient as JRemote
from netsdb_tpu.serve.server import ServeController as JServe
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.catalog.catalog import Catalog, read_module_source
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.serve import server as server_mod
from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
from netsdb_tpu_torch.serve.server import ServeController

TIMEOUT = 60.0
PLAN = "\n".join(["in <= SCAN('db', 'm')",
                  "sq <= APPLY(in, 'udf')",
                  "out <= OUTPUT(sq, 'db', 'sq')"])
PORT_SRC = "\n".join([
    "import torch",
    "def udf(t):",
    "    return t.with_data(torch.tanh(t.data) * t.data + 0.5 * t.data)",
])
REF_SRC = "\n".join([
    "import jax.numpy as jnp",
    "def udf(t):",
    "    return t.with_data(jnp.tanh(t.data) * t.data + 0.5 * t.data)",
])


@pytest.fixture()
def fresh_module_name(request):
    """A module name installed nowhere; popped from ``sys.modules`` after
    the test (the daemons of this process exec shipped code into it)."""
    name = f"udf_torch_shipped_{request.node.name.split('[')[0][-24:]}"
    assert importlib.util.find_spec(name) is None
    yield name
    sys.modules.pop(name, None)


def _daemon(root, **kw):
    ctl = ServeController(Configuration(root_dir=str(root)), port=0,
                          device="cpu", **kw)
    ctl.start()
    return ctl


def _load(c, a):
    c.create_database("db")
    c.create_set("db", "m")
    c.send_matrix("db", "m", a, (2, 2))


def test_shipped_udf_equals_the_reference(tmp_path, fresh_module_name):
    a = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    ctl = _daemon(tmp_path / "port", allow_pickle=False)
    try:
        c = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
        _load(c, a)
        c.register_type("UdfOp", f"{fresh_module_name}:udf", source=PORT_SRC)
        assert ctl.library.catalog.get_type_source("UdfOp") == PORT_SRC
        got = next(iter(c.execute_plan(PLAN, {"udf": "UdfOp"},
                                       job_name="shipped").values()))
        got = np.asarray(got.to_dense())
        c.close()
    finally:
        ctl.shutdown()
    sys.modules.pop(fresh_module_name, None)
    ref_name = fresh_module_name + "_ref"
    jctl = JServe(JConfiguration(root_dir=str(tmp_path / "ref")), port=0,
                  allow_pickle=False)
    jctl.start()
    try:
        jc = JRemote(f"127.0.0.1:{jctl.port}")
        jc.create_database("db")
        jc.create_set("db", "m")
        jc.send_matrix("db", "m", a, (2, 2))
        jc.register_type("UdfOp", f"{ref_name}:udf", source=REF_SRC)
        want = next(iter(jc.execute_plan(PLAN, {"udf": "UdfOp"},
                                         job_name="shipped").values()))
        want = np.asarray(want.to_dense())
        jc.close()
    finally:
        jctl.shutdown()
        sys.modules.pop(ref_name, None)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.tanh(a) * a + 0.5 * a, rtol=1e-5,
                               atol=1e-6)


def test_ship_module_reads_a_file_module(tmp_path, fresh_module_name):
    """``ship_module=True`` reads the source off the importable module on
    the client; the daemon, which cannot import it, execs what shipped."""
    moddir = tmp_path / "mods"
    moddir.mkdir()
    (moddir / f"{fresh_module_name}.py").write_text(PORT_SRC + "\n")
    a = np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)
    ctl = _daemon(tmp_path / "d")
    try:
        c = RemoteClient(ctl.advertise_addr, timeout=TIMEOUT)
        _load(c, a)
        sys.path.insert(0, str(moddir))
        try:
            assert read_module_source(f"{fresh_module_name}:udf") == \
                PORT_SRC + "\n"
            c.register_type("FileUdf", f"{fresh_module_name}:udf",
                            ship_module=True)
        finally:
            sys.path.remove(str(moddir))
            importlib.invalidate_caches()
        assert importlib.util.find_spec(fresh_module_name) is None
        got = next(iter(c.execute_plan(PLAN, {"udf": "FileUdf"},
                                       job_name="file").values()))
        np.testing.assert_allclose(np.asarray(got.to_dense()),
                                   np.tanh(a) * a + 0.5 * a,
                                   rtol=1e-5, atol=1e-6)
        assert sys.modules[fresh_module_name].__spec__.loader is None
        c.close()
    finally:
        ctl.shutdown()


def test_concurrent_binds_exec_the_module_once(fresh_module_name):
    probe = types.ModuleType("ship_probe_counter")
    probe.n = []
    sys.modules["ship_probe_counter"] = probe
    src = "import ship_probe_counter\nship_probe_counter.n.append(1)\n" \
          "def udf(t):\n    return t\n"
    try:
        barrier = threading.Barrier(8)
        got = []

        def bind():
            barrier.wait()
            got.append(server_mod.resolve_entry_point(
                f"{fresh_module_name}:udf", src))

        ts = [threading.Thread(target=bind) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert len(got) == 8 and len({id(f) for f in got}) == 1
        assert probe.n == [1]
    finally:
        sys.modules.pop("ship_probe_counter", None)
    # without source, a module installed nowhere still raises
    with pytest.raises(ModuleNotFoundError):
        server_mod.resolve_entry_point(f"{fresh_module_name}_none:udf")


def test_snapshot_resynced_follower_binds_the_shipped_type(
        tmp_path, fresh_module_name):
    links = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
                 heartbeat_misses=2, mirror_ack_timeout_s=2.0,
                 resync_grace_s=5.0)
    a = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    fctl = _daemon(tmp_path / "f")
    mctl = _daemon(tmp_path / "m", followers=[fctl.advertise_addr], **links)
    try:
        c = RemoteClient(mctl.advertise_addr, timeout=TIMEOUT,
                         retry=RetryPolicy(max_attempts=5,
                                           base_delay_s=0.01,
                                           max_delay_s=0.1))
        _load(c, a)
        mctl._evict_follower(fctl.advertise_addr, "test eviction")
        # registered while the follower is away: only the snapshot
        # carries it there
        c.register_type("UdfOp", f"{fresh_module_name}:udf", source=PORT_SRC)
        want = next(iter(c.execute_plan(PLAN, {"udf": "UdfOp"},
                                        job_name="lead").values()))
        deadline = threading.Event()
        for _ in range(400):
            st = mctl.follower_status()
            if st["active"] and not st["degraded"]:
                break
            deadline.wait(0.05)
        assert mctl.last_resync["mode"] == "snapshot"
        assert fctl.library.catalog.get_type_source("UdfOp") == PORT_SRC
        sys.modules.pop(fresh_module_name, None)  # the follower execs anew
        fc = RemoteClient(fctl.advertise_addr, timeout=TIMEOUT)
        got = next(iter(fc.execute_plan(PLAN, {"udf": "UdfOp"},
                                        job_name="follower").values()))
        np.testing.assert_array_equal(np.asarray(got.to_dense()),
                                      np.asarray(want.to_dense()))
        fc.close()
        c.close()
    finally:
        mctl.shutdown()
        fctl.shutdown()


def test_in_process_client_and_catalog_keep_the_source(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
    c.register_type("Plain", "netsdb_tpu_torch.ops.linalg:transpose")
    assert c.catalog.get_type_source("Plain") is None
    c.register_type("Shipped", "netsdb_tpu_torch.ops.linalg:transpose",
                    ship_module=True)
    src = c.catalog.get_type_source("Shipped")
    assert "def transpose" in src
    assert c.catalog.get_type("Shipped") == \
        "netsdb_tpu_torch.ops.linalg:transpose"
    # the mesh-node rows
    cat = Catalog()
    cat.register_node(0, "127.0.0.1:8108", 1, "cuda")
    cat.register_node(1, "127.0.0.1:8109", 4, "cuda")
    assert cat.list_nodes() == [
        {"node_id": 0, "address": "127.0.0.1:8108", "num_devices": 1,
         "device_kind": "cuda"},
        {"node_id": 1, "address": "127.0.0.1:8109", "num_devices": 4,
         "device_kind": "cuda"}]
    with pytest.raises(ImportError, match="ship_module"):
        read_module_source("no_such_module_anywhere:f")
