"""The port's paged tensor storage (``netsdb_tpu_torch/storage/paged.py``
over its own build and binding of ``native/pagestore.cpp``) against the
JAX package's: the same matrices give the same block layout and the
same streamed bytes, the arena spills in both, and the port's native
and pure-Python backends agree. Both packages run with the reference
tests' arena, ``Configuration(page_size_bytes=4096,
page_pool_bytes=16384)``. Blocks are compared bit for bit: storage
moves bytes and computes nothing."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from netsdb_tpu.config import Configuration as RefConfiguration
from netsdb_tpu.storage.paged import PagedTensorStore as RefStore
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.native import build as native_build
from netsdb_tpu_torch.storage.paged import PagedTensorStore

torch.set_num_threads(2)

ARENA = dict(page_size_bytes=4096, page_pool_bytes=16384)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def stores(tmp_path):
    ref = RefStore(RefConfiguration(root_dir=str(tmp_path / "ref"), **ARENA),
                   pool_bytes=ARENA["page_pool_bytes"])
    port = PagedTensorStore(Configuration(root_dir=str(tmp_path / "port"),
                                          **ARENA))
    yield ref, port
    ref.close()
    port.close()


def _matrix(seed, rows, cols=24):
    return np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)


def _fill(store, name="w"):
    """A matrix paged in, then two ragged appends (37 and 5 rows)."""
    store.put(name, _matrix(0, 400))
    store.put(name, _matrix(1, 37), append=True)
    store.put(name, _matrix(2, 5), append=True)


def _blocks(store, name="w", **kw):
    return [(s, b.copy()) for s, b in store.stream_blocks(name, **kw)]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_layout_and_streamed_blocks_match_the_reference(stores, prefetch):
    ref, port = stores
    for s in stores:
        _fill(s)
    assert port.meta("w") == ref.meta("w")
    assert port.block_ranges("w") == ref.block_ranges("w")
    assert port.num_blocks("w") == ref.num_blocks("w")
    # 4096-byte pages of 96-byte rows: 42 rows each, ragged after appends
    assert port.meta("w")[1] == (42, 24)
    got, want = _blocks(port, prefetch=prefetch), _blocks(ref,
                                                         prefetch=prefetch)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    dense = np.concatenate([_matrix(0, 400), _matrix(1, 37), _matrix(2, 5)])
    np.testing.assert_array_equal(np.concatenate([b for _, b in got]), dense)
    # a selective feed (the stitched stream's gaps) reads only those pages
    pick = [1, 4, len(got) - 1]
    sel = _blocks(port, prefetch=prefetch, blocks=pick)
    ref_sel = _blocks(ref, prefetch=prefetch, blocks=pick)
    assert [s for s, _ in sel] == [s for s, _ in ref_sel]
    for (_, a), (_, b) in zip(sel, ref_sel):
        np.testing.assert_array_equal(a, b)
    for i in (0, 3, len(got) - 1):
        (s0, b0), (s1, b1) = port.read_block("w", i), ref.read_block("w", i)
        assert s0 == s1
        np.testing.assert_array_equal(b0, b1)


def test_the_arena_spills_in_both(stores):
    for s in stores:
        _fill(s)
        _blocks(s)
    ref, port = stores
    assert ref.stats()["spills"] > 0
    assert port.stats()["spills"] > 0
    assert port.native and ref.native
    # every page was read back once by the stream (some from spill files)
    assert port.stats()["page_reads"] == port.num_blocks("w")


def test_rewrite_block_in_place(stores):
    for s in stores:
        _fill(s)
    new = np.full((42, 24), 7.0, np.float32)
    for s in stores:
        s.rewrite_block("w", 2, new)
    ref, port = stores
    np.testing.assert_array_equal(port.read_block("w", 2)[1], new)
    np.testing.assert_array_equal(port.read_block("w", 2)[1],
                                  ref.read_block("w", 2)[1])
    with pytest.raises(ValueError, match="shape"):
        port.rewrite_block("w", 2, new[:10])


def test_drop_and_recreate_the_same_name(stores):
    for s in stores:
        _fill(s)
        s.drop("w")
        s.drop("w")  # a second drop is a no-op
        with pytest.raises(KeyError):
            s.block_ranges("w")
        s.put("w", _matrix(5, 100))
    ref, port = stores
    assert port.block_ranges("w") == ref.block_ranges("w")
    np.testing.assert_array_equal(
        np.concatenate([b for _, b in _blocks(port)]), _matrix(5, 100))
    np.testing.assert_array_equal(
        np.concatenate([b for _, b in _blocks(port)]),
        np.concatenate([b for _, b in _blocks(ref)]))
    # a replacing put frees the old pages: nothing of them is streamed
    for s in stores:
        s.put("w", _matrix(6, 50))
    assert port.block_ranges("w") == ref.block_ranges("w")
    np.testing.assert_array_equal(
        np.concatenate([b for _, b in _blocks(port)]), _matrix(6, 50))


def test_streaming_from_a_closed_store_raises(tmp_path):
    for make, cfg in ((RefStore, RefConfiguration), (PagedTensorStore,
                                                     Configuration)):
        s = make(cfg(root_dir=str(tmp_path / make.__module__), **ARENA),
                 pool_bytes=ARENA["page_pool_bytes"])
        _fill(s)
        live = s.stream_blocks("w", prefetch=2)
        next(live)
        s.close()  # joins the live stream's reader first
        with pytest.raises((RuntimeError, KeyError)):
            for _ in range(100):
                next(live)
    # a new stream of the closed port store raises before it touches the
    # freed arena, with or without a reader thread (the reference asks
    # the arena for the page list first, so it is not probed here)
    for prefetch in (0, 2):
        with pytest.raises(RuntimeError, match="closed"):
            list(s.stream_blocks("w", prefetch=prefetch))


def test_abandoned_stream_joins_its_reader(stores):
    _, port = stores
    _fill(port)
    live = port.stream_blocks("w", prefetch=2)
    next(live)
    live.close()
    with port._readers_lock:
        assert all(not t.is_alive() for t, _ in port._readers)


def test_native_and_python_backends_agree(tmp_path):
    cfg = Configuration(root_dir=str(tmp_path / "port"), **ARENA)
    native = PagedTensorStore(cfg)
    python = PagedTensorStore(cfg, force_python=True)
    assert native.native and not python.native
    for s in (native, python):
        _fill(s)
        s.rewrite_block("w", 1, np.ones((42, 24), np.float32))
    assert native.block_ranges("w") == python.block_ranges("w")
    for (s0, a), (s1, b) in zip(_blocks(native), _blocks(python)):
        assert s0 == s1
        np.testing.assert_array_equal(a, b)
    assert set(native.stats()) == set(python.stats())
    assert native.stats()["spills"] > 0
    native.close()
    python.close()


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet drop to the Python backend: the reference falls back
    when its build fails, the port raises."""
    from netsdb_tpu_torch.native import pagestore

    def broken(name="pagestore"):
        raise native_build.NativeBuildError("g++ failed (test)")

    monkeypatch.setattr(pagestore, "_lib", None)
    monkeypatch.setattr(pagestore, "build_library", broken)
    with pytest.raises(native_build.NativeBuildError, match="g\\+\\+"):
        PagedTensorStore(Configuration(root_dir=str(tmp_path / "p"),
                                       **ARENA))


_BUILD = """
import ctypes, sys, time
from pathlib import Path
import netsdb_tpu_torch.native.build as b
b.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.001)
lib = b.build_library()
ctypes.CDLL(str(lib))
print(lib)
"""


def test_two_processes_building_at_once(tmp_path):
    """Workers on a fresh tree build the same library at once: both get
    one whole library, loadable, and no temporary file is left."""
    import time

    out = tmp_path / "build"
    start = str(time.time() + 2.0)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(out),
                               start], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    results = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, results):
        assert p.returncode == 0, se
    paths = {so.strip() for so, _ in results}
    assert len(paths) == 1
    files = sorted(f.name for f in out.iterdir())
    assert files == sorted([os.path.basename(paths.pop()),
                            "pagestore.lock"]), files


def test_concurrent_streams_of_one_matrix(stores):
    """Readers on several threads see the same bytes (prefetch threads
    of separate streams share one arena)."""
    _, port = stores
    _fill(port)
    want = np.concatenate([b for _, b in _blocks(port)])
    got, errors = [], []

    def read():
        try:
            got.append(np.concatenate([b for _, b in _blocks(port)]))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=read) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(got) == 4
    for g in got:
        np.testing.assert_array_equal(g, want)
