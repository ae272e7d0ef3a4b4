"""ctypes binding of the native page store (``native/pagestore.cpp``) —
counterpart of ``netsdb_tpu/native/pagestore.py``.

The arena hands out raw pointers to pinned pages; a read copies the
page out while it is pinned. The library is
built on first use (:func:`netsdb_tpu_torch.native.build.build_library`)
and a failed build raises: nothing drops to a Python backend on its own.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Union

import numpy as np

from netsdb_tpu_torch.native.build import NativeBuildError, build_library

_POLICIES = {"lru": 0, "mru": 1, "random": 2}
_STATS = ("hits", "misses", "evictions", "spills", "loads",
          "bytes_allocated", "bytes_in_use")

_lib = None
_lib_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library("pagestore")))
        u64, i64, vp = ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p
        lib.ps_create.restype = vp
        lib.ps_create.argtypes = [u64, u64, ctypes.c_char_p, ctypes.c_int]
        lib.ps_destroy.restype = None
        lib.ps_destroy.argtypes = [vp]
        lib.ps_create_set.restype = ctypes.c_int
        lib.ps_create_set.argtypes = [vp, u64, ctypes.c_int32]
        lib.ps_alloc_page.restype = i64
        lib.ps_alloc_page.argtypes = [vp, u64, u64]
        lib.ps_pin.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ps_pin.argtypes = [vp, u64, ctypes.POINTER(u64)]
        lib.ps_unpin.restype = ctypes.c_int
        lib.ps_unpin.argtypes = [vp, u64, ctypes.c_int]
        lib.ps_free_page.restype = ctypes.c_int
        lib.ps_free_page.argtypes = [vp, u64]
        lib.ps_flush_set.restype = ctypes.c_int
        lib.ps_flush_set.argtypes = [vp, u64]
        lib.ps_set_page_count.restype = i64
        lib.ps_set_page_count.argtypes = [vp, u64]
        lib.ps_set_page_id.restype = i64
        lib.ps_set_page_id.argtypes = [vp, u64, u64]
        lib.ps_page_size.restype = i64
        lib.ps_page_size.argtypes = [vp, u64]
        lib.ps_stats.restype = None
        lib.ps_stats.argtypes = [vp, ctypes.POINTER(u64)]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the native page store builds and loads here. The probe
    builds the library on its first call; a failed build answers False
    (and :class:`NativePageStore` raises with the compiler's error)."""
    try:
        _load()
    except (NativeBuildError, OSError):
        return False
    return True


def _as_bytes(payload: Union[bytes, np.ndarray]) -> np.ndarray:
    if isinstance(payload, (bytes, bytearray)):
        return np.frombuffer(payload, dtype=np.uint8)
    return np.ascontiguousarray(payload).reshape(-1).view(np.uint8)


class NativePageStore:
    """Python handle on one C++ page arena of ``pool_bytes``, spilling
    cold pages to files under ``spill_dir``."""

    def __init__(self, pool_bytes: int, spill_dir: str,
                 evict_watermark: Optional[int] = None):
        lib = _load()
        os.makedirs(spill_dir, exist_ok=True)
        self._lib = lib
        self._h = lib.ps_create(pool_bytes,
                                evict_watermark or int(pool_bytes * 0.8),
                                spill_dir.encode(), 0)
        if not self._h:
            raise RuntimeError("failed to create the native page arena")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ps_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def _handle(self):
        if not self._h:
            raise RuntimeError("the native page arena is closed")
        return self._h

    # --- sets / pages -------------------------------------------------
    def create_set(self, set_id: int, policy: str = "lru") -> None:
        rc = self._lib.ps_create_set(self._handle(), set_id,
                                     _POLICIES[policy])
        if rc != 0:
            raise RuntimeError(f"create_set failed rc={rc}")

    def write_page(self, set_id: int, payload) -> int:
        """Allocate a page, copy ``payload`` in, unpin it dirty; returns
        the page id."""
        buf = _as_bytes(payload)
        pid = self._lib.ps_alloc_page(self._handle(), set_id, buf.nbytes)
        if pid < 0:
            raise MemoryError(f"alloc_page failed rc={pid} "
                              f"(pool exhausted or unknown set)")
        size = ctypes.c_uint64()
        ptr = self._lib.ps_pin(self._handle(), pid, ctypes.byref(size))
        try:
            if buf.nbytes:
                np.ctypeslib.as_array(ptr, shape=(buf.nbytes,))[:] = buf
        finally:
            self._lib.ps_unpin(self._handle(), pid, 1)  # the write pin
        self._lib.ps_unpin(self._handle(), pid, 1)      # the alloc pin
        return int(pid)

    def read_page(self, page_id: int) -> np.ndarray:
        """Pin (reloading from its spill file if evicted), copy out,
        unpin. The copy is a ``memmove`` through ctypes, which releases
        the GIL, so a reader thread copies while other threads run."""
        size = ctypes.c_uint64()
        ptr = self._lib.ps_pin(self._handle(), page_id, ctypes.byref(size))
        if not ptr:
            raise KeyError(f"unknown or unloadable page {page_id}")
        try:
            out = np.empty(size.value, dtype=np.uint8)
            if size.value:
                ctypes.memmove(out.ctypes.data, ptr, size.value)
            return out
        finally:
            self._lib.ps_unpin(self._handle(), page_id, 0)

    def overwrite_page(self, page_id: int, payload) -> None:
        """Replace one page's bytes in place (same size): pin, copy,
        unpin dirty."""
        buf = _as_bytes(payload)
        size = ctypes.c_uint64()
        ptr = self._lib.ps_pin(self._handle(), page_id, ctypes.byref(size))
        if not ptr:
            raise KeyError(f"unknown or unloadable page {page_id}")
        try:
            if size.value != buf.nbytes:
                raise ValueError(f"overwrite_page: size change "
                                 f"{size.value} -> {buf.nbytes} not allowed")
            if buf.nbytes:
                np.ctypeslib.as_array(ptr, shape=(buf.nbytes,))[:] = buf
        finally:
            self._lib.ps_unpin(self._handle(), page_id, 1)

    def free_page(self, page_id: int) -> None:
        rc = self._lib.ps_free_page(self._handle(), page_id)
        if rc != 0:
            raise RuntimeError(f"free_page failed rc={rc}")

    def flush_set(self, set_id: int) -> None:
        rc = self._lib.ps_flush_set(self._handle(), set_id)
        if rc != 0:
            raise RuntimeError(f"flush_set failed rc={rc}")

    def set_pages(self, set_id: int) -> list:
        n = self._lib.ps_set_page_count(self._handle(), set_id)
        if n < 0:
            raise KeyError(f"unknown set {set_id}")
        return [int(self._lib.ps_set_page_id(self._handle(), set_id, i))
                for i in range(n)]

    def page_size(self, page_id: int) -> int:
        """Payload bytes of one page, from metadata (no pin, no reload)."""
        n = self._lib.ps_page_size(self._handle(), page_id)
        if n < 0:
            raise KeyError(f"unknown page {page_id}")
        return int(n)

    def stats(self) -> dict:
        arr = (ctypes.c_uint64 * len(_STATS))()
        self._lib.ps_stats(self._handle(), arr)
        return dict(zip(_STATS, (int(v) for v in arr)))
