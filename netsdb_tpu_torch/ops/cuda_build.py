"""Build and load the hand-written CUDA kernels of ``netsdb_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``netsdb_tpu_torch/_build/`` (listed in ``.gitignore``), or into the
directory a ``Configuration(compilation_cache_dir=...)`` names
(:func:`set_build_dir`, through ``config.enable_compilation_cache``),
and loaded with ``ctypes``. The library's file name carries a hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused, and
a fresh process given a directory that holds the library runs no nvcc
(``nvcc_runs`` counts this process's compiles). Several processes may
build into one directory at once (a leader and its workers): each
compiles under an ``fcntl`` lock on the directory, to a private name
renamed into place, so the compiler runs once and no process loads a
half-written library.
Nothing is built at import time: the CPU tests import every module of
the package on machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: the directory set by :func:`set_build_dir` (None: ``BUILD_DIR``)
_build_dir: Optional[Path] = None
#: nvcc compiles this process ran
nvcc_runs = 0

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); it is needed to build "
                       "netsdb_tpu_torch's CUDA kernels")


def set_build_dir(path) -> None:
    """Build and load the kernel libraries in ``path`` (None: the
    package's ``BUILD_DIR``)."""
    global _build_dir
    _build_dir = Path(path) if path is not None else None


def build_dir() -> Path:
    return _build_dir if _build_dir is not None else BUILD_DIR


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, every
    header of ``csrc`` (name and bytes) and the flags, so an edited
    shared header rebuilds every library."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's report (ptxas: registers, shared memory, spills) is
    kept beside the library as ``<library>.log``. Raises
    ``RuntimeError`` with the compiler's output on failure."""
    global nvcc_runs
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        # build to a private name, then rename: concurrent loaders never
        # see a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            nvcc_runs += 1
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 str(SRC_DIR / f"{name}.cu")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name}.cu (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, loaded (callers cache it)."""
    return ctypes.CDLL(str(build(name)))
