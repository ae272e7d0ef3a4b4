"""The port's persisted compiled plan against the reference's
(``tests/test_aot.py``): ``plan/aot.py`` over ``torch.export`` — the FF
forward exported and reloaded within 1e-5 of the reference's FF forward
on the same numpy weights, the ten-query TPC-H suite exported and
reloaded within rtol 1e-5, atol 1e-4 of the reference's suite, the
refusal of tables whose statics differ, and a
``Configuration(compilation_cache_dir=<dir>)`` reaching the kernel
builds' paths (no nvcc runs on the CPU: only paths are computed)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from netsdb_tpu_torch.plan import aot
from netsdb_tpu_torch.relational.queries import compile_suite, tables_from_rows
from netsdb_tpu_torch.workloads import tpch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    return tpch.generate(scale=2, seed=13)


@pytest.fixture(scope="module")
def tables(data):
    return tables_from_rows(data, device="cpu")


def test_export_round_trip_simple(tmp_path):
    def fn(a, b):
        return a @ b + 1.0

    x = torch.ones((8, 8))
    call = aot.load_exported(aot.export_jitted(fn, x, x))
    np.testing.assert_allclose(call(x, x).numpy(), fn(x, x).numpy())
    # and through a file: a different input of the same shape
    path = aot.save_exported(str(tmp_path / "mm.pt2"), fn, x, x)
    y = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    np.testing.assert_allclose(aot.load_exported(path)(y, x).numpy(),
                               fn(y, x).numpy())


def test_tpch_suite_export_matches_the_reference(data, tables, tmp_path):
    from netsdb_tpu.relational.queries import compile_suite as jcompile
    from netsdb_tpu.relational.queries import tables_from_rows as jtables
    import jax

    path = str(tmp_path / "suite.pt2")
    aot.export_tpch_suite(tables, path)
    assert os.path.getsize(path) > 0 and os.path.exists(path + ".meta")
    got = aot.load_tpch_suite(path, tables)()
    own = compile_suite(tables)()
    want = jcompile(jtables(data))()
    flat_g = pytree.tree_leaves(got)
    flat_o = pytree.tree_leaves(own)
    flat_w, _ = jax.tree_util.tree_flatten(want)
    assert set(got) == set(want)
    assert len(flat_g) == len(flat_o) == len(flat_w)
    for g, o, w in zip(flat_g, flat_o, flat_w):
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_suite_load_refuses_incompatible_tables(tables, tmp_path):
    path = str(tmp_path / "suite.pt2")
    aot.export_tpch_suite(tables, path)
    other = tables_from_rows(tpch.generate(scale=3, seed=99), device="cpu")
    with pytest.raises(ValueError, match="different static"):
        aot.load_tpch_suite(path, other)
    os.remove(path + ".meta")
    with pytest.raises(ValueError, match="sidecar"):
        aot.load_tpch_suite(path, tables)


def test_ff_export_round_trip_matches_the_reference(tmp_path):
    """``graft_entry.entry``'s FF forward exported, reloaded and run:
    within 1e-5 of the in-process forward and of the reference's
    ``__graft_entry__`` forward (the same numpy draws)."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as g
    import jax

    from netsdb_tpu_torch import graft_entry
    from netsdb_tpu_torch.core.blocked import BlockedTensor

    fn, args = graft_entry.entry(device="cpu")
    path = str(tmp_path / "ff.pt2")
    model, params, x, _ = graft_entry._tiny_model(device="cpu")
    aot.export_ff_inference(model, params, x, path)
    got = aot.load_exported(path)(*args)
    assert isinstance(got, BlockedTensor)
    np.testing.assert_allclose(got.data.numpy(), fn(*args).data.numpy(),
                               rtol=1e-5, atol=1e-5)
    jfn, jargs = g.entry()
    want = jax.jit(jfn)(*jargs)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(want.to_dense()),
                               rtol=1e-5, atol=1e-5)


def test_compilation_cache_dir_reaches_the_kernel_builds(tmp_path):
    """A directory set as ``compilation_cache_dir`` is where the kernel
    libraries build and load from, in a fresh process too; ``"auto"``
    keeps the package's build directory."""
    cache = str(tmp_path / "cc")
    script = f"""
from netsdb_tpu_torch.client import Client
from netsdb_tpu_torch.config import Configuration, enable_compilation_cache
from netsdb_tpu_torch.ops import cuda_build
Client(Configuration(root_dir={str(tmp_path / 'r')!r},
                     compilation_cache_dir={cache!r}), device="cpu")
p = cuda_build.library_path("flash_attention")
assert str(p.parent) == {cache!r}, p
enable_compilation_cache(Configuration(compilation_cache_dir="auto"))
assert cuda_build.library_path("flash_attention").parent == \\
    cuda_build.BUILD_DIR
print(p.name, cuda_build.nvcc_runs)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    name, runs = out.stdout.split()
    assert name.startswith("libflash_attention_") and runs == "0"
    assert os.path.isdir(cache)


def test_compilation_cache_dir_is_process_wide_and_reentrant(tmp_path):
    from netsdb_tpu_torch.config import (Configuration,
                                         enable_compilation_cache)
    from netsdb_tpu_torch.ops import cuda_build

    try:
        a = enable_compilation_cache(Configuration(
            compilation_cache_dir=str(tmp_path / "a")))
        assert a == str(tmp_path / "a")
        assert cuda_build.build_dir() == tmp_path / "a"
        b = enable_compilation_cache(Configuration(
            compilation_cache_dir=str(tmp_path / "b")))
        assert cuda_build.library_path("flash_attention_step").parent == \
            tmp_path / "b" and b == str(tmp_path / "b")
        assert enable_compilation_cache(Configuration(
            compilation_cache_dir=None)) is None
        assert cuda_build.build_dir() == cuda_build.BUILD_DIR
    finally:
        enable_compilation_cache(Configuration())
