"""Model dedup of the port against the reference's
(``netsdb_tpu/dedup/``, the store's aliases and pooled sets,
``Client.dedup_resident``): the same fingerprints (hex digests), the
same LSH bits and groups, the same pooling report, assembly bit-exact,
aliases read-only (``tests/test_dedup_e2e.py``), pooled sets as in
``tests/test_dedup_pool.py`` (but its daemon test, ROADMAP.md A7), and
the graph hazard: a dropped assembly is never read by a program."""

import gc
import importlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.client import Client as JClient
from netsdb_tpu.config import Configuration as JConfiguration
from netsdb_tpu.core.blocked import BlockedTensor as JBlocked
from netsdb_tpu.models.ff import FFModel as JFF
from netsdb_tpu.plan.executor import clear_compiled_cache as j_clear
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.plan import executor
from netsdb_tpu_torch.storage.store import SetIdentifier

jdet, jlsh, jpool = (importlib.import_module(f"netsdb_tpu.dedup.{m}")
                     for m in ("detector", "lsh", "pool"))
det, lsh, pool = (importlib.import_module(f"netsdb_tpu_torch.dedup.{m}")
                  for m in ("detector", "lsh", "pool"))


@pytest.fixture()
def port(tmp_path):
    return Client(Configuration(root_dir=str(tmp_path / "port")),
                  device="cpu")


def _both(arr, block):
    return (JBlocked.from_dense(arr, block),
            BlockedTensor.from_dense(arr, block, device="cpu"))


# --- detector -------------------------------------------------------------

@pytest.mark.parametrize("shape,block,quantize", [
    ((64, 48), (16, 16), None), ((30, 17), (8, 8), None),
    ((30, 17), (8, 8), 1e-3), ((40,), (16,), None)])
def test_fingerprints_are_the_references_hex_digests(shape, block, quantize):
    arr = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    j, p = _both(arr, block)
    assert det.block_fingerprints(p, quantize) == \
        jdet.block_fingerprints(j, quantize)


def test_page_packing_matches_the_reference():
    rng = np.random.default_rng(1)
    sizes = {f"b{i}": int(rng.integers(1, 40)) for i in range(30)}
    groups = [[f"b{i}" for i in range(0, 30, 4)], ["b1", "b2", "zz"]]
    assert det.pack_blocks_into_pages(sizes, 64, groups) == \
        jdet.pack_blocks_into_pages(sizes, 64, groups)
    tensors = {f"t{i}": [f"b{int(j)}" for j in rng.integers(0, 25, 12)]
               for i in range(6)}
    assert det.bin_pack_tensors(tensors, 4) == \
        jdet.bin_pack_tensors(tensors, 4)
    with pytest.raises(ValueError, match="exceeds page size"):
        det.pack_blocks_into_pages({"x": 99}, 64)


def _two_ff(c, ff_cls, block=(16, 16)):
    a = ff_cls(db="ffa", block=block)
    b = ff_cls(db="ffb", block=block)
    for m, seed in ((a, 1), (b, 2)):
        m.setup(c)
        m.load_random_weights(c, features=32, hidden=48, labels=8, seed=seed)
    return a, b


def test_dedup_weight_sets_aliases_a_shared_backbone(client, port):
    _two_ff(client, JFF)
    _two_ff(port, FFModel)
    for name in ("w1", "b1"):  # B's backbone is A's (a fine-tuned copy)
        jt = client.get_tensor("ffa", name)
        client.store.put_tensor(
            __import__("netsdb_tpu.storage.store", fromlist=["x"])
            .SetIdentifier("ffb", name), JBlocked(jt.data, jt.meta))
        pt = port.get_tensor("ffa", name)
        port.store.put_tensor(SetIdentifier("ffb", name),
                              BlockedTensor(pt.data.clone(), pt.meta))
    sets = [("ffa", "w1"), ("ffb", "w1")]
    assert det.find_shared_blocks(port, sets) == \
        jdet.find_shared_blocks(client, sets)
    for name in ("w1", "b1", "wo"):
        assert det.dedup_weight_sets(port, "ffb", name, "ffa", name) == \
            jdet.dedup_weight_sets(client, "ffb", name, "ffa", name)
    s = port.store._sets[SetIdentifier("ffb", "w1")]
    assert s.alias_of == SetIdentifier("ffa", "w1")
    assert port.get_tensor("ffb", "w1") is port.get_tensor("ffa", "w1")
    assert port.collect_stats()["ffb:w1"]["alias_of"] == "ffa:w1"
    assert port.collect_stats()["ffb:wo"]["alias_of"] is None


def test_inference_unchanged_after_aliasing(port):
    a, b = _two_ff(port, FFModel)
    for name in ("w1", "b1"):
        t = port.get_tensor("ffa", name)
        port.store.put_tensor(SetIdentifier("ffb", name),
                              BlockedTensor(t.data.clone(), t.meta))
    x = BlockedTensor.from_dense(np.random.default_rng(3).standard_normal(
        (24, 32)).astype(np.float32), (16, 16), device="cpu")
    before = [m.forward(m.params_from_store(port), x).to_dense().clone()
              for m in (a, b)]
    for name in ("w1", "b1"):
        assert det.dedup_weight_sets(port, "ffb", name, "ffa",
                                     name)["aliased"]
    after = [m.forward(m.params_from_store(port), x).to_dense()
             for m in (a, b)]
    for x0, x1 in zip(before, after):
        assert torch.equal(x0, x1)


def test_alias_set_is_read_only(port):
    from netsdb_tpu_torch.relational.table import ColumnTable

    _two_ff(port, FFModel)
    port.add_shared_mapping("ffb", "w1", "ffa", "w1")
    ident = SetIdentifier("ffb", "w1")
    for write in (
            lambda: port.store.put_tensor(ident, port.get_tensor("ffa", "wo")),
            lambda: port.send_data("ffb", "w1", [np.ones(3)]),
            lambda: port.store.update_set(ident, lambda items: items),
            lambda: port.store.append_table(ident, ColumnTable(
                {"k": torch.zeros(2, dtype=torch.int32)})),
            lambda: port.store.set_pooled(ident, None)):
        with pytest.raises(ValueError, match="alias.*read-only"):
            write()


def test_a_write_to_the_shared_set_reaches_its_aliases(port):
    """An alias reads in place what its shared set holds now, and a
    program that read it through the alias is dropped by the write."""
    port.create_database("d")
    port.create_set("d", "shared")
    port.create_set("d", "alias")
    port.send_matrix("d", "shared", np.ones((8, 8), np.float32), (4, 4))
    port.add_shared_mapping("d", "alias", "d", "shared")
    v0 = port.store.version_of(SetIdentifier("d", "alias"))
    port.send_matrix("d", "shared", np.full((8, 8), 2.0, np.float32),
                     (4, 4))
    assert port.store.version_of(SetIdentifier("d", "alias")) > v0
    assert float(port.get_tensor("d", "alias").data.sum()) == 128.0


# --- LSH ------------------------------------------------------------------

def test_lsh_bits_equal_the_references():
    rng = np.random.default_rng(0)
    for shape, block in (((128, 64), 64), ((96, 40), 32)):
        arr = rng.standard_normal(shape).astype(np.float32)
        j, p = _both(arr, (block, block))
        ji, jb = jlsh.block_signatures(j)
        pi, pb = lsh.block_signatures(p)
        assert pi == ji
        np.testing.assert_array_equal(pb, jb)


def test_lsh_groups_and_zoo_equal_the_references():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((128, 64))
    arrs = {"a": base, "b": base + 1e-5 * rng.standard_normal(base.shape),
            "c": rng.standard_normal((128, 64))}
    jidx, pidx = jlsh.LSHIndex(), lsh.LSHIndex()
    for name, a in arrs.items():
        j, p = _both(a.astype(np.float32), (64, 64))
        assert pidx.add_model(name, p) == jidx.add_model(name, j)
    assert pidx.near_duplicate_groups() == jidx.near_duplicate_groups()
    assert pidx.verified_pairs == jidx.verified_pairs
    assert pidx.stats() == jidx.stats()
    assert pidx.candidates(("a", (0, 0))) == jidx.candidates(("a", (0, 0)))
    zoo = {f"m{i}": rng.standard_normal((128, 64)).astype(np.float32)
           for i in range(12)}
    want = jlsh.dedup_model_zoo({n: JBlocked.from_dense(a, (64, 64))
                                 for n, a in zoo.items()})
    got = lsh.dedup_model_zoo({n: BlockedTensor.from_dense(a, (64, 64),
                                                           device="cpu")
                               for n, a in zoo.items()})
    assert got == want


def test_bench_lsh_zoo_counts_equal_the_references():
    kw = dict(n_models=20, blocks_per_model=2, block=64, n_families=4)
    want = jlsh.bench_lsh_zoo(**kw)
    got = lsh.bench_lsh_zoo(**kw, device="cpu")
    for key in ("models", "blocks", "groups", "groups_family_pure",
                "verified_pairs", "all_pairs", "index_stats"):
        assert got[key] == want[key], key
    assert got["groups"] == 8 and got["groups_family_pure"]


def test_projection_cache_keys_on_the_device():
    p = lsh._device_projection(16, 8, 0, torch.device("cpu"))
    assert any(k[3] == torch.device("cpu") for k in lsh._proj_cache)
    assert p.device.type == "cpu"


# --- pool -----------------------------------------------------------------

def _variant_pair(seed=0, rows=128, cols=128, block=(32, 32), changed=1):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((rows, cols)).astype(np.float32)
    variant = base.copy()
    variant[:block[0], :block[1]] += 0.5
    for b in range(1, changed):
        variant[b * block[0]:(b + 1) * block[0], :block[1]] -= 0.25
    return base, variant


@pytest.mark.parametrize("changed,shape", [(1, (128, 128)), (3, (128, 128)),
                                           (2, (100, 90))])
def test_pool_models_report_and_assembly(changed, shape):
    base, variant = _variant_pair(rows=shape[0], cols=shape[1],
                                  changed=changed)
    jt = {n: JBlocked.from_dense(a, (32, 32))
          for n, a in (("m:a", base), ("m:b", variant))}
    pt = {n: BlockedTensor.from_dense(a, (32, 32), device="cpu")
          for n, a in (("m:a", base), ("m:b", variant))}
    _, want = jpool.pool_models(jt)
    pooled, got = pool.pool_models(pt)
    assert got == want
    grid = int(np.prod(pt["m:a"].meta.grid))
    assert got["unique_blocks"] == grid + changed
    for name in pt:
        a = pooled[name].assemble()
        assert torch.equal(a.data, pt[name].data)
        assert a.meta == pt[name].meta
    with pytest.raises(ValueError, match="one block class"):
        pool.pool_models({"x": pt["m:a"], "y": BlockedTensor.from_dense(
            base, (16, 16), device="cpu")})


def test_pooled_tensor_pickles_as_the_whole_tensor():
    import pickle

    base, variant = _variant_pair()
    pooled, _ = pool.pool_models({"a": BlockedTensor.from_dense(
        base, (32, 32), device="cpu")})
    back = pickle.loads(pickle.dumps(pooled["a"]))
    assert isinstance(back, BlockedTensor)
    np.testing.assert_array_equal(back.to_dense().numpy(), base)


def _zoo(c):
    c.create_database("zoo")
    base, variant = _variant_pair(seed=3)
    for name, a in (("w_a", base), ("w_b", variant)):
        c.create_set("zoo", name)
        c.send_matrix("zoo", name, a, (32, 32))
    return base, variant


def test_dedup_resident_matches_the_reference_and_reads_unchanged(config,
                                                                  port):
    ref = JClient(config)
    _zoo(ref)
    base, variant = _zoo(port)
    x = np.random.default_rng(1).standard_normal((16, 128)).astype(
        np.float32)
    before = [port.get_tensor("zoo", n).to_dense().numpy() @ x.T
              for n in ("w_a", "w_b")]
    sets = [("zoo", "w_a"), ("zoo", "w_b")]
    want = ref.dedup_resident(sets)
    got = port.dedup_resident(sets)
    assert got == want
    assert got["shared_block_refs"] == 15
    after = [port.get_tensor("zoo", n).to_dense().numpy() @ x.T
             for n in ("w_a", "w_b")]
    for b0, b1 in zip(before, after):
        np.testing.assert_array_equal(b0, b1)
    stats = port.collect_stats()
    want_stats = ref.collect_stats()
    sizes = [stats[k]["nbytes"] for k in ("zoo:w_a", "zoo:w_b")]
    assert sizes == [want_stats[k]["nbytes"] for k in ("zoo:w_a",
                                                         "zoo:w_b")]
    assert all(s < 4096 for s in sizes)
    assert port.store.live_pool_bytes() == got["hbm_bytes_pooled"] == \
        ref.store.live_pool_bytes()
    port.remove_set("zoo", "w_a")
    assert port.store.live_pool_bytes() == got["hbm_bytes_pooled"]
    port.remove_set("zoo", "w_b")
    assert port.store.live_pool_bytes() == 0


def test_consecutive_reads_do_not_regather(port):
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((32, 32)).astype(np.float32)
    port.create_database("dp")
    for name in ("m1", "m2"):
        port.create_set("dp", name)
        port.send_matrix("dp", name, dense, (8, 8))
    port.dedup_resident([("dp", "m1"), ("dp", "m2")])
    item = port.store._sets[SetIdentifier("dp", "m1")].items[0]
    assert isinstance(item, pool.PooledTensor)
    t1 = port.get_tensor("dp", "m1")
    t2 = port.get_tensor("dp", "m1")
    assert item.assembly_count == 1 and t1 is t2
    np.testing.assert_array_equal(t1.to_dense().numpy(), dense)
    released = port.store.drop_pool_caches()
    assert released == 32 * 32 * 4  # m1's assembly (m2 was never read)
    t3 = port.get_tensor("dp", "m1")
    assert item.assembly_count == 2
    np.testing.assert_array_equal(t3.to_dense().numpy(), dense)


def test_live_pool_bytes_across_set_removal(port):
    dense = np.random.default_rng(4).standard_normal((32, 32)).astype(
        np.float32)
    port.create_database("dp")
    for name in ("p1", "p2"):
        port.create_set("dp", name)
        port.send_matrix("dp", name, dense, (8, 8))
    rep = port.dedup_resident([("dp", "p1"), ("dp", "p2")])
    live = port.store.live_pool_bytes()
    assert live == rep["hbm_bytes_pooled"] == 16 * 8 * 8 * 4
    port.remove_set("dp", "p1")
    assert port.store.live_pool_bytes() == live
    port.remove_set("dp", "p2")
    assert port.store.live_pool_bytes() == 0


def test_memory_pressure_drops_pool_caches_before_evicting(port):
    dense = np.random.default_rng(5).standard_normal((64, 64)).astype(
        np.float32)
    port.create_database("dp")
    for name in ("q1", "q2"):
        port.create_set("dp", name)
        port.send_matrix("dp", name, dense, (16, 16))
    port.dedup_resident([("dp", "q1"), ("dp", "q2")])
    port.get_tensor("dp", "q1")
    port.get_tensor("dp", "q2")
    item = port.store._sets[SetIdentifier("dp", "q1")].items[0]
    assert item.cached is not None
    # a budget the pool and slot grids fit, the two assemblies do not
    port.store.max_host_bytes = port.store.live_pool_bytes() + 2 * 4096
    port.create_set("dp", "small")
    port.send_matrix("dp", "small", np.ones((4, 4), np.float32), (4, 4))
    assert item.cached is None
    assert port.store.stats.evictions == 0
    np.testing.assert_array_equal(
        port.get_tensor("dp", "q1").to_dense().numpy(), dense)


# --- the graph hazard -------------------------------------------------------

def _ff_requests(c, m, job):
    out = c.execute_computations(m.build_inference_dag(), job_name=job)
    return out[SetIdentifier(m.db, "output")].to_dense().clone()


def test_pooled_weights_dropped_assembly_is_never_replayed(port):
    """Pool FF's weights, run the request through its program twice (one
    trace), drop the pool caches, run again: the output is bit-equal, the
    drop counted as a write (a new trace), and no program still holds
    the dropped assembly."""
    executor.clear_compiled_cache()
    a, b = _two_ff(port, FFModel)
    xs = np.random.default_rng(7).standard_normal((24, 32)).astype(
        np.float32)
    for m in (a, b):
        m.load_inputs(port, xs)
    want = [_ff_requests(port, m, f"ff-{m.db}") for m in (a, b)]
    port.dedup_resident([("ffa", "w1"), ("ffb", "w1"),
                         ("ffa", "wo"), ("ffb", "wo")])
    first = [_ff_requests(port, m, f"ff-{m.db}") for m in (a, b)]
    t0 = executor.compile_stats()["traces"]
    again = [_ff_requests(port, m, f"ff-{m.db}") for m in (a, b)]
    assert executor.compile_stats()["traces"] == t0  # replayed
    old = weakref.ref(port.get_tensor("ffa", "w1").data)
    assert port.store.drop_pool_caches() > 0
    gc.collect()
    assert old() is None  # no program kept the dropped assembly
    after = [_ff_requests(port, m, f"ff-{m.db}") for m in (a, b)]
    assert executor.compile_stats()["traces"] == t0 + 2  # one per model
    for w, f, g, h in zip(want, first, again, after):
        assert torch.equal(w, f) and torch.equal(f, g) and torch.equal(g, h)
    # a drop by the tensor itself (not the store): the fresh assembly on
    # the next read is a write too
    item = port.store._sets[SetIdentifier("ffa", "w1")].items[0]
    v = port.store.version_of(SetIdentifier("ffa", "w1"))
    item.drop_cache()
    assert torch.equal(_ff_requests(port, a, "ff-ffa"), want[0])
    assert port.store.version_of(SetIdentifier("ffa", "w1")) > v


def test_reference_pool_parity_on_ff_sets(client, port):
    """The same two FF models pooled by both packages: equal reports."""
    j_clear()
    _two_ff(client, JFF)
    _two_ff(port, FFModel)
    sets = [("ffa", "w1"), ("ffb", "w1"), ("ffa", "wo"), ("ffb", "wo")]
    assert port.dedup_resident(sets) == client.dedup_resident(sets)
    for db, name in sets:
        np.testing.assert_array_equal(
            port.get_tensor(db, name).data.numpy(),
            np.asarray(client.get_tensor(db, name).data))


def test_pool_shares_every_byte_equal_block_past_the_lsh_buckets():
    """Two variants of 2048 blocks each (buckets of 8-bit bands far past
    the 8-block all-pairs limit): every byte-equal block shares a slot.
    The reference's pool byte-compares only what its LSH grouped, and
    its anchor heuristic leaves most of these unpaired."""
    from netsdb_tpu.dedup import pool as jpool

    rng = np.random.default_rng(7)
    base = rng.standard_normal((512, 256)).astype(np.float32)
    variant = base.copy()
    variant[:128] += 1.0  # 512 of the 2048 blocks of 8 x 8 change
    want_unique = 2048 + 512
    _, report = pool.pool_models(
        {"a": BlockedTensor.from_dense(base, (8, 8), device="cpu"),
         "b": BlockedTensor.from_dense(variant, (8, 8), device="cpu")})
    assert report["unique_blocks"] == want_unique
    assert report["shared_block_refs"] == 4096 - want_unique
    assert report["hbm_bytes_pooled"] == want_unique * 8 * 8 * 4
    _, ref = jpool.pool_models({"a": JBlocked.from_dense(base, (8, 8)),
                                "b": JBlocked.from_dense(variant, (8, 8))})
    assert ref["unique_blocks"] > want_unique  # the reference's misses
    assert (ref["lsh_groups"], ref["verified_pairs"]) == \
        (report["lsh_groups"], report["verified_pairs"])


def test_pool_without_the_lsh_report_builds_no_lsh_index(monkeypatch):
    """``dedup_resident`` reads no LSH field, so it pools with
    ``report_lsh=False``: the same slots and report less the two LSH
    fields, and no LSH index built."""
    from netsdb_tpu_torch.dedup import lsh

    base, variant = _variant_pair(changed=3)
    pt = {n: BlockedTensor.from_dense(a, (32, 32), device="cpu")
          for n, a in (("m:a", base), ("m:b", variant))}
    full_pool, full = pool.pool_models(pt)

    def refuse(*a, **k):
        raise AssertionError("an LSH index was built")

    monkeypatch.setattr(lsh, "LSHIndex", refuse)
    pooled, report = pool.pool_models(pt, report_lsh=False)
    assert report == {k: v for k, v in full.items()
                      if k not in ("lsh_groups", "verified_pairs")}
    for name in pt:
        assert np.array_equal(pooled[name].slots, full_pool[name].slots)
        assert torch.equal(pooled[name].assemble().data, pt[name].data)
