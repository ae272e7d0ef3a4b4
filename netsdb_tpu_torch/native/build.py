"""Build the native page store (``native/pagestore.cpp``) with g++ into
``netsdb_tpu_torch/_build/`` — counterpart of
``netsdb_tpu/native/build.py``.

The source is read-only here: the port compiles the repository's
``native/pagestore.cpp`` as it is and never writes into ``native/``.
The library's file name carries a hash of the source and the flags, so
an edited source builds a new library and an unchanged one is reused.
Several processes may build at once (test workers on a fresh tree):
each compiles to a private name under an ``fcntl`` lock on the build
directory and renames the result into place, so no process ever loads
a half-written library and the compiler runs once.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
NATIVE_DIR = PKG_DIR.parent / "native"
BUILD_DIR = PKG_DIR / "_build"

FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str = "pagestore") -> Path:
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_library(name: str = "pagestore") -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists; returns
    the library's path. Raises :class:`NativeBuildError` with the
    compiler's output when g++ is missing or fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                try:
                    proc = subprocess.run(
                        ["g++", *FLAGS, str(NATIVE_DIR / f"{name}.cpp"),
                         "-o", tmp], capture_output=True, text=True)
                except FileNotFoundError as e:
                    raise NativeBuildError(
                        f"g++ is needed to build native/{name}.cpp: {e}"
                    ) from e
                if proc.returncode != 0:
                    raise NativeBuildError(
                        f"g++ failed building native/{name}.cpp:\n"
                        f"{proc.stderr[-2000:]}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out
