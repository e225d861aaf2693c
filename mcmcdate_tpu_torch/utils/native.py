"""ctypes bindings for the native Newick tree-list parser.

The native library is optional: :func:`read_treelist_fast` falls back to the
pure-Python parser when the shared object is absent or fails.  Build with
``make -C native`` (g++ only, no dependencies).
"""

from __future__ import annotations

import ctypes
import gzip
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libnewick.so",
)
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _LIB_PATH
    if not os.path.exists(path):
        # Try a one-shot build; stay silent on failure (fallback covers it).
        src = os.path.join(os.path.dirname(path), "newick_parser.cpp")
        if os.path.exists(src):
            try:
                subprocess.run(
                    ["make", "-C", os.path.dirname(path)],
                    capture_output=True, timeout=120, check=True,
                )
            except Exception:
                return None
        else:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.newick_parse_file.restype = ctypes.c_void_p
    lib.newick_parse_file.argtypes = [ctypes.c_char_p]
    lib.newick_parse_buffer.restype = ctypes.c_void_p
    lib.newick_parse_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.newick_error.restype = ctypes.c_char_p
    lib.newick_error.argtypes = [ctypes.c_void_p]
    for fn in ("newick_n_trees", "newick_n_nodes"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.newick_lengths.restype = ctypes.POINTER(ctypes.c_double)
    lib.newick_lengths.argtypes = [ctypes.c_void_p]
    lib.newick_struct_hashes.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.newick_struct_hashes.argtypes = [ctypes.c_void_p]
    lib.newick_parents.restype = ctypes.POINTER(ctypes.c_int32)
    lib.newick_parents.argtypes = [ctypes.c_void_p]
    lib.newick_names.restype = ctypes.c_char_p
    lib.newick_names.argtypes = [ctypes.c_void_p]
    lib.newick_free.restype = None
    lib.newick_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_treelist_fast(path: str):
    """Parse a (possibly gzipped) tree-list file natively.

    Returns ``(lengths [n_trees, n_nodes], parents [n_nodes], names,
    struct_hashes [n_trees])`` with lengths in pre-order matching the Python
    parser; equal structure hashes certify equal topology including sub-tree
    order and labels.  Returns ``None`` when the native library is
    unavailable (caller falls back).

    Raises ``ValueError`` on parse errors (same contract as the Python path).
    """
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        data = gzip.open(path, "rb").read()
        h = lib.newick_parse_buffer(data, len(data))
    else:
        h = lib.newick_parse_file(path.encode())
    try:
        err = lib.newick_error(h)
        if err:
            raise ValueError(f"newick native parser: {err.decode()}")
        n_trees = lib.newick_n_trees(h)
        n_nodes = lib.newick_n_nodes(h)
        lens = np.ctypeslib.as_array(
            lib.newick_lengths(h), shape=(n_trees * n_nodes,)
        ).reshape(n_trees, n_nodes).copy()
        parents = np.ctypeslib.as_array(
            lib.newick_parents(h), shape=(n_nodes,)
        ).copy()
        names = lib.newick_names(h).decode().split("\n")[:n_nodes]
        hashes = np.ctypeslib.as_array(
            lib.newick_struct_hashes(h), shape=(n_trees,)
        ).copy()
        return lens, parents, names, hashes
    finally:
        lib.newick_free(h)
