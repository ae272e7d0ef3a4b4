"""Set eviction in the port's store (``netsdb_tpu_torch/storage/store.py``)
against the reference's (``netsdb_tpu/storage/store.py:1173-1212``): the
same writes and reads under the same ``max_host_bytes`` evict the same
sets by their policies (``lru``, ``mru``, ``random`` — the latter with
Python's ``random`` seeded alike in both), count the same evictions,
spills, hits, misses and loads, and an evicted set reloads on its next
read with its data unchanged. In the port the budget bounds the bytes of
memory sets on the client's device."""

import random
import time

import numpy as np
import pytest
import torch

from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.core.blocked import BlockedTensor as JBlocked
from netsdb_tpu.storage.store import SetIdentifier as JIdent
from netsdb_tpu.storage.store import SetStore as JStore
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.plan.computations import Apply, ScanSet, WriteSet
from netsdb_tpu_torch.storage.store import SetIdentifier, SetStore

KB = 16 * 16 * 4  # one 16 x 16 f32 matrix


def stores(tmp_path, budget):
    return {"ref": JStore(JConfiguration(root_dir=str(tmp_path / "ref")),
                          max_host_bytes=budget),
            "port": SetStore(Configuration(root_dir=str(tmp_path / "port")),
                             device="cpu", max_host_bytes=budget)}


def ident(key, name):
    return (JIdent if key == "ref" else SetIdentifier)("db", name)


def matrix(key, value):
    x = np.full((16, 16), value, np.float32)
    if key == "ref":
        return JBlocked.from_dense(x, (8, 8))
    return BlockedTensor.from_dense(x, (8, 8), device="cpu")


def in_memory(store, key, names):
    return {n: store.set_stats(ident(key, n))["in_memory"] for n in names}


def stats(store):
    return {k: getattr(store.stats, k)
            for k in ("evictions", "spills", "hits", "misses", "loads")}


def test_store_eviction_spills_lru_like_the_reference(tmp_path):
    """tests/test_storage_catalog.py:107 in both packages."""
    out = {}
    for key, store in stores(tmp_path, 1000).items():
        a, b = ident(key, "a"), ident(key, "b")
        for i in (a, b):
            store.create_set(i)
        store.put_tensor(a, matrix(key, 1.0))
        store.put_tensor(b, matrix(key, 1.0))
        assert store.stats.evictions >= 1
        assert not store.set_stats(a)["in_memory"]
        t = store.get_tensor(a)
        total = float(np.asarray(t.to_dense()).sum())
        out[key] = (total, stats(store), in_memory(store, key, "ab"))
    assert out["port"] == out["ref"]
    assert out["port"][0] == 256


def _scenario(store, key, policy, read_first):
    """a, b under a budget of 2 matrices; one of them read; c arrives."""
    for n in "abc":
        store.create_set(ident(key, n), eviction=policy)
    store.put_tensor(ident(key, "a"), matrix(key, 1.0))
    time.sleep(0.01)
    store.put_tensor(ident(key, "b"), matrix(key, 2.0))
    time.sleep(0.01)
    store.get_items(ident(key, read_first))
    time.sleep(0.01)
    store.put_tensor(ident(key, "c"), matrix(key, 3.0))


@pytest.mark.parametrize("read_first", ["a", "b"])
@pytest.mark.parametrize("policy", ["lru", "mru"])
def test_lru_and_mru_evict_what_the_reference_evicts(tmp_path, policy,
                                                     read_first):
    out = {}
    for key, store in stores(tmp_path, 2 * KB + 100).items():
        _scenario(store, key, policy, read_first)
        out[key] = (in_memory(store, key, "abc"), stats(store))
    assert out["port"] == out["ref"]
    mem = out["port"][0]
    evicted = [n for n in "ab" if not mem[n]]
    assert len(evicted) == 1 and mem["c"]
    # lru drops the one not read since, mru the one just read
    assert (evicted[0] == read_first) == (policy == "mru")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_evicts_what_the_reference_evicts(tmp_path, seed):
    out = {}
    for key, store in stores(tmp_path, 2 * KB + 100).items():
        random.seed(seed)  # c and d each evict one set
        for n in "abcd":
            store.create_set(ident(key, n), eviction="random")
        for n, v in zip("abcd", (1.0, 2.0, 3.0, 4.0)):
            store.put_tensor(ident(key, n), matrix(key, v))
        out[key] = (in_memory(store, key, "abcd"), stats(store))
    assert out["port"] == out["ref"]
    assert sum(out["port"][0].values()) == 2 and out["port"][0]["d"]


def test_mixed_policies_like_the_reference(tmp_path):
    out = {}
    for key, store in stores(tmp_path, 2 * KB + 100).items():
        for n, pol in zip("abc", ("mru", "lru", "lru")):
            store.create_set(ident(key, n), eviction=pol)
        for n in "abc":
            store.put_tensor(ident(key, n), matrix(key, 1.0))
            time.sleep(0.01)
        out[key] = in_memory(store, key, "abc")
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("policy", ["lru", "mru", "random"])
def test_evicted_sets_reload_unchanged(tmp_path, policy):
    store = stores(tmp_path, KB + 100)["port"]
    for n, v in zip("abc", (1.0, 2.0, 3.0)):
        store.create_set(ident("port", n), eviction=policy)
        store.put_tensor(ident("port", n), matrix("port", v))
    assert store.stats.evictions == 2
    for n, v in zip("abc", (1.0, 2.0, 3.0)):
        got = store.get_tensor(ident("port", n)).to_dense()
        assert torch.equal(got, torch.full((16, 16), v))


def test_host_records_count_like_the_reference(tmp_path):
    out = {}
    for key, store in stores(tmp_path, 256 * 10).items():
        for n in "ab":
            store.create_set(ident(key, n))
        store.add_data(ident(key, "a"), [{"i": i} for i in range(8)])
        time.sleep(0.01)
        store.add_data(ident(key, "b"), [{"i": i} for i in range(4)])
        out[key] = (in_memory(store, key, "ab"),
                    store.set_stats(ident(key, "b"))["nbytes"])
        assert list(store.scan(ident(key, "a"))) == \
            [{"i": i} for i in range(8)]
    assert out["port"] == out["ref"]


def test_paged_sets_are_never_evicted(tmp_path):
    store = SetStore(Configuration(root_dir=str(tmp_path),
                                   page_size_bytes=4096,
                                   page_pool_bytes=1 << 20), device="cpu",
                     max_host_bytes=100)
    p, m = SetIdentifier("db", "p"), SetIdentifier("db", "m")
    store.create_set(p, storage="paged")
    store.put_tensor(p, matrix("port", 1.0))
    store.create_set(m)
    store.put_tensor(m, matrix("port", 2.0))
    assert store.stats.evictions == 0
    assert store.set_stats(p)["in_memory"]


def test_client_create_set_takes_every_policy(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
    c.create_database("db")
    for pol in ("lru", "mru", "random"):
        c.create_set("db", pol, eviction=pol)
        assert c.store.set_stats(SetIdentifier("db", pol))["eviction"] == pol
    with pytest.raises(ValueError, match="eviction"):
        c.create_set("db", "x", eviction="fifo")
    assert not c.set_exists("db", "x")


def test_a_query_over_an_evicted_set_reloads_it(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path)), device="cpu")
    c.store.max_host_bytes = KB + 100
    c.create_database("db")
    for n in ("w", "v"):
        c.create_set("db", n, eviction="lru")
    c.send_matrix("db", "w", np.full((16, 16), 2.0, np.float32), (8, 8))
    time.sleep(0.01)
    c.send_matrix("db", "v", np.ones((16, 16), np.float32), (8, 8))
    assert not c.store.set_stats(SetIdentifier("db", "w"))["in_memory"]
    sink = WriteSet(Apply(ScanSet("db", "w"), lambda t: t.with_data(
        t.data + 1), label="plus1"), "db", "out")
    out = next(iter(c.execute_computations(sink, job_name="ev").values()))
    assert torch.equal(out.to_dense(), torch.full((16, 16), 3.0))
    assert c.store.stats.loads >= 1


def test_eviction_persists_to_the_data_dir(tmp_path):
    store = stores(tmp_path, KB + 100)["port"]
    for n in "ab":
        store.create_set(ident("port", n))
        store.put_tensor(ident("port", n), matrix("port", 1.0))
    files = list((tmp_path / "port" / "data").iterdir())
    assert [f.name for f in files] == ["db__a.ptset"]
    assert store.set_stats(ident("port", "a"))["nbytes"] == 0
