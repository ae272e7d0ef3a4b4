"""What a ``ScanSet`` gives the DAG, in the port as in the reference: a
set holding one matrix, tensor or placed tensor scans as that value (the
sets of FF, the transformer layer, the SP layer and paged sets); an
object set and an empty set scan as their item list; a ``tensor4d`` set
(the conv model's) scans as its item list even with one tensor, as the
reference scans a set of one numpy array
(``netsdb_tpu/plan/executor.py:1148-1172``)."""

import numpy as np
import pytest
import torch

from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.parallel.mesh import ShardedTensor
from netsdb_tpu_torch.parallel.placement import Placement
from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet
from netsdb_tpu_torch.storage.paged import PagedTensor
from netsdb_tpu_torch.storage.store import SetIdentifier

torch.set_num_threads(2)


@pytest.fixture()
def port_client(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "port"),
                             page_size_bytes=4096, page_pool_bytes=16384),
               device="cpu")
    c.create_database("d")
    return c


def scanned(client, set_name):
    """The value a ScanSet of ``d:set_name`` hands the next node (a
    gather node, so that a paged handle reaches it as it is)."""
    seen = []
    scan = ScanSet("d", set_name)
    client.execute_computations(
        WriteSet(Join(scan, scan, lambda v, _: seen.append(v) or 0,
                      label="Probe", passthrough=True), "d", "probe_out"),
        materialize=False)
    return seen[0]


def test_tensor4d_set_with_one_array_scans_as_a_list(port_client):
    port_client.create_set("d", "images", type_name="tensor4d")
    port_client.send_data("d", "images", [np.ones((1, 2, 3, 3), np.float32)])
    value = scanned(port_client, "images")
    assert isinstance(value, list) and len(value) == 1
    assert tuple(value[0].shape) == (1, 2, 3, 3)
    port_client.create_set("d", "empty4d", type_name="tensor4d")
    assert scanned(port_client, "empty4d") == []


@pytest.mark.parametrize("kind", ["blocked", "tensor", "placed", "paged"])
def test_one_tensor_sets_scan_as_the_tensor(port_client, kind):
    """The sets of slices 1-4 keep their scan: the value itself."""
    dense = np.arange(12, dtype=np.float32).reshape(3, 4)
    if kind == "paged":
        port_client.create_set("d", "s", storage="paged")
        port_client.send_matrix("d", "s", dense, (2, 2))
        assert isinstance(scanned(port_client, "s"), PagedTensor)
        return
    port_client.create_set("d", "s", placement=(
        Placement.replicated() if kind == "placed" else None))
    if kind == "tensor":
        port_client.send_data("d", "s", [dense])
        value = scanned(port_client, "s")
        assert isinstance(value, torch.Tensor)
        np.testing.assert_array_equal(value.numpy(), dense)
        return
    port_client.send_matrix("d", "s", dense, (2, 2))
    value = scanned(port_client, "s")
    assert isinstance(value, BlockedTensor)
    assert isinstance(value.data, ShardedTensor) == (kind == "placed")


def test_object_and_multi_item_sets_scan_as_lists(port_client):
    port_client.create_set("d", "objs", type_name="object")
    port_client.send_data("d", "objs", [{"a": 1}])
    assert scanned(port_client, "objs") == [{"a": 1}]
    port_client.create_set("d", "two")
    port_client.send_data("d", "two", [np.zeros(2), np.ones(2)])
    assert len(scanned(port_client, "two")) == 2
    port_client.create_set("d", "none")
    assert scanned(port_client, "none") == []


def test_tensor4d_type_survives_flush_and_load(tmp_path):
    config = Configuration(root_dir=str(tmp_path / "port"))
    c = Client(config, device="cpu")
    c.create_database("d")
    c.create_set("d", "images", type_name="tensor4d",
                 persistence="persistent")
    c.send_data("d", "images", [np.ones((1, 1, 2, 2), np.float32)])
    c.flush_data()
    c2 = Client(config, device="cpu")
    c2.store.load_set(SetIdentifier("d", "images"))
    assert c2.store.scans_as_list(SetIdentifier("d", "images"))
    assert isinstance(scanned(c2, "images"), list)
