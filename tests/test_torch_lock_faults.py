"""Lock faults the port's first lint run found in its own tree, each
held where it was fixed (on the CPU, under the port's runtime witness):

* a replaced paged matrix's pages were freed under its ``rw`` write lock
  with the arena looked up inside it, and a streamed matmul looked up
  the device cache under the matrix's read lock, so ``SetStore._lock``
  nested in ``_PagedMatrix.rw`` — against the store -> relation order
  every other path takes (``SetStore._drop_pages``,
  ``SetStore.paged_matmul``);
* a fresh paged record set was written through ``PagedObjects.append``
  under the store lock, taking the new relation's locks there
  (``PagedObjects.ingest`` now writes a relation no one else can reach
  without them);
* ``append_table`` uploaded a memory set's batch while it held the store
  lock, stalling every other set for the copy."""

import threading

import numpy as np
import torch

from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.relational.table import ColumnTable
from netsdb_tpu_torch.storage.store import SetIdentifier, SetStore
from netsdb_tpu_torch.utils.locks import witness_scope


def _store(tmp_path):
    return SetStore(Configuration(root_dir=str(tmp_path / "r"),
                                  page_size_bytes=4096,
                                  page_pool_bytes=65536), device="cpu")


def _edges(w):
    return {(e["held"], e["acquired"]) for e in w.export_edges()}


def test_replacing_a_paged_matrix_takes_no_store_lock_under_its_rw(tmp_path):
    st = _store(tmp_path)
    ident = SetIdentifier("d", "m")
    st.create_set(ident, storage="paged")
    rng = np.random.default_rng(0)
    with witness_scope(raise_on_cycle=True) as w:
        for _ in range(2):  # the second put replaces and frees the first
            st.put_tensor(ident, BlockedTensor.from_dense(
                torch.from_numpy(rng.standard_normal(
                    (64, 32)).astype(np.float32)), (16, 16)))
        edges = _edges(w)
    assert ("_PagedMatrix.rw", "SetStore._lock") not in edges, edges


def test_a_paged_matmul_takes_no_store_lock_under_the_matrix_rw(tmp_path):
    st = _store(tmp_path)
    ident = SetIdentifier("d", "m")
    st.create_set(ident, storage="paged")
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((64, 32)).astype(np.float32)
    st.put_tensor(ident, BlockedTensor.from_dense(torch.from_numpy(dense),
                                                  (16, 16)))
    rhs = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    with witness_scope(raise_on_cycle=True) as w:
        got = st.paged_matmul(ident, rhs)
        edges = _edges(w)
    assert ("_PagedMatrix.rw", "SetStore._lock") not in edges, edges
    np.testing.assert_allclose(got.numpy(), dense @ rhs.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_a_fresh_paged_record_set_is_written_without_its_locks(tmp_path):
    st = _store(tmp_path)
    ident = SetIdentifier("d", "objs")
    st.create_set(ident, storage="paged")
    with witness_scope(raise_on_cycle=True) as w:
        st.add_data(ident, [{"k": i} for i in range(40)])  # fresh ingest
        fresh = _edges(w)
        st.add_data(ident, [{"k": 40}])  # an append: outside the store lock
        assert [r["k"] for r in st.get_items(ident)[0]] == list(range(41))
    assert ("SetStore._lock", "PagedObjects.rw") not in fresh, fresh


def test_append_table_uploads_its_batch_outside_the_store_lock(
        tmp_path, monkeypatch):
    st = _store(tmp_path)
    ident = SetIdentifier("d", "t")
    st.create_set(ident, type_name="table")
    batch = ColumnTable({"a": torch.arange(8, dtype=torch.int32)})
    st.append_table(ident, batch)
    probes = []
    real_to = ColumnTable.to

    def probing_to(self, device):
        # another thread takes the store lock while the batch uploads:
        # it gets it at once unless the caller holds it
        got = []
        t = threading.Thread(target=lambda: got.append(
            st._lock.acquire(timeout=0.5) and (st._lock.release() or True)))
        t.start()
        t.join()
        probes.append(bool(got and got[0]))
        return real_to(self, device)

    monkeypatch.setattr(ColumnTable, "to", probing_to)
    st.append_table(ident, ColumnTable({"a": torch.arange(
        8, 12, dtype=torch.int32)}))
    assert probes and probes[0], probes
    got = st.get_items(ident)[0]
    assert got.cols["a"][got.mask()].tolist() == list(range(12))
