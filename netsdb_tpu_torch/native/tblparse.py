"""ctypes binding of the native .tbl parser (``native/tblparse.cpp``) —
counterpart of ``netsdb_tpu/native/tblparse.py``.

Columnar ingestion of TPC-H dbgen files (the C++ role of the
reference's ``tpchDataLoader.cc``), returning numpy columns. The library
is built on first use by :func:`netsdb_tpu_torch.native.build.
build_library` into ``netsdb_tpu_torch/_build/`` (the source stays
read-only; concurrent builders serialise on a file lock). As in the
reference, :func:`parse_columnar` returns None when the library cannot
be built, and callers keep the Python row parser; :func:`available`
says which path runs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from netsdb_tpu_torch.native.build import NativeBuildError, build_library

_lib = None
_lib_err: Optional[str] = None
_lib_lock = threading.Lock()

_TYPE_CODES = {int: 0, float: 1, str: 2}


def _load():
    """The library, built on first use; None (and the reason in
    ``_lib_err``) when it cannot be built or loaded."""
    global _lib, _lib_err
    with _lib_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build_library("tblparse")))
        except (NativeBuildError, OSError) as e:
            _lib_err = str(e)
            return None
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib) -> None:
    lib.tp_parse.restype = ctypes.c_void_p
    lib.tp_parse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
    lib.tp_num_rows.restype = ctypes.c_int64
    lib.tp_num_rows.argtypes = [ctypes.c_void_p]
    lib.tp_error_msg.restype = ctypes.c_char_p
    lib.tp_error_msg.argtypes = [ctypes.c_void_p]
    lib.tp_int_col.restype = ctypes.POINTER(ctypes.c_int64)
    lib.tp_int_col.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tp_float_col.restype = ctypes.POINTER(ctypes.c_double)
    lib.tp_float_col.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tp_str_data.restype = ctypes.c_void_p
    lib.tp_str_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tp_str_offsets.restype = ctypes.POINTER(ctypes.c_int64)
    lib.tp_str_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tp_free.argtypes = [ctypes.c_void_p]


def available() -> bool:
    return _load() is not None


def parse_columnar(path: str, schema: List[Tuple[str, type]]
                   ) -> Optional[Dict[str, np.ndarray]]:
    """Parse a .tbl file into {column: array} (int64 / float64 /
    object-dtype strings). Returns None when the native library is
    unavailable; raises ValueError on malformed input (same contract as
    the Python parser)."""
    lib = _load()
    if lib is None:
        return None
    types = (ctypes.c_int * len(schema))(
        *[_TYPE_CODES[t] for _, t in schema])
    h = lib.tp_parse(path.encode(), len(schema), types)
    if not h:
        raise FileNotFoundError(path)
    try:
        err = lib.tp_error_msg(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n = lib.tp_num_rows(h)
        out: Dict[str, np.ndarray] = {}
        for i, (name, typ) in enumerate(schema):
            if typ is int:
                buf = np.ctypeslib.as_array(lib.tp_int_col(h, i), (n,))
                out[name] = buf.copy()
            elif typ is float:
                buf = np.ctypeslib.as_array(lib.tp_float_col(h, i), (n,))
                out[name] = buf.copy()
            else:
                offs = np.ctypeslib.as_array(lib.tp_str_offsets(h, i),
                                             (n + 1,)).copy()
                total = int(offs[-1])
                data_ptr = lib.tp_str_data(h, i)
                raw = ctypes.string_at(data_ptr, total) if total else b""
                ol = offs.tolist()
                col = np.empty(n, dtype=object)
                if raw.isascii():
                    # byte offsets == char offsets: decode once, slice
                    # (~2x faster than per-row bytes.decode)
                    blob = raw.decode()
                    col[:] = [blob[ol[j]:ol[j + 1]] for j in range(n)]
                else:
                    # multi-byte UTF-8: offsets are BYTE offsets, so
                    # slice bytes first, then decode each field
                    col[:] = [raw[ol[j]:ol[j + 1]].decode()
                              for j in range(n)]
                out[name] = col
        return out
    finally:
        lib.tp_free(h)
