"""The CUDA build cache of the port: a library's path is keyed on its
source, every shared header of ``csrc`` and the compiler flags, so an
edited header can never load a stale library. Runs on the CPU: it only
computes paths, it builds nothing."""

import shutil

import pytest

from netsdb_tpu_torch.ops import cuda_build

KERNELS = ("flash_attention", "flash_attention_step")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(cuda_build.SRC_DIR, src)
    monkeypatch.setattr(cuda_build, "SRC_DIR", src)
    return src


def _paths():
    return {name: cuda_build.library_path(name) for name in KERNELS}


def test_both_kernels_include_the_shared_fold():
    for name in KERNELS:
        text = (cuda_build.SRC_DIR / f"{name}.cu").read_text()
        assert '#include "flash_fold_mma.cuh"' in text


def test_path_is_stable(csrc):
    assert _paths() == _paths()
    for name, path in _paths().items():
        assert path.parent == cuda_build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"


@pytest.mark.parametrize("edit", [
    "edit the shared header",
    "add a header",
    "rename a header",
])
def test_header_change_rebuilds_every_kernel(csrc, edit):
    before = _paths()
    header = csrc / "flash_fold_mma.cuh"
    if edit == "edit the shared header":
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "add a header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        header.rename(csrc / "renamed.cuh")
    after = _paths()
    for name in KERNELS:
        assert after[name] != before[name], (edit, name)


def test_source_change_rebuilds_only_its_kernel(csrc):
    before = _paths()
    src = csrc / "flash_attention_step.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert after["flash_attention_step"] != before["flash_attention_step"]
    assert after["flash_attention"] == before["flash_attention"]


def test_other_files_do_not_rebuild(csrc):
    before = _paths()
    (csrc / "notes.txt").write_text("not a source\n")
    assert _paths() == before


def test_flags_change_rebuilds(csrc, monkeypatch):
    before = _paths()
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    after = _paths()
    for name in KERNELS:
        assert after[name] != before[name]
