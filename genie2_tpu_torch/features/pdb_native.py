"""The C++ CA parser (`csrc/pdb_parser.cpp`) bound by ctypes: the default
PDB reader of the training data path (`features_from_pdb(use_native=True)`).

`parse_pdb_fast(path)` returns what `features/pdb.py:parse_pdb` returns,
per-chain residue-type indices and CA coordinates, with the coordinates
read as float32 by the C++ parser (as genie2_tpu's native parser reads
them). The library is compiled by `g++ -O3 -shared -fPIC` at first use into
`build/host/pdb_parser-<hash>.so` beside the package (the hash covers the
source and the flags), never at import and never into the source tree. A
missing compiler or a failed build raises with the compiler's output: there
is no silent fallback, so reading PDB files for training needs g++ (or the
compiler that CXX names). `features_from_pdb(use_native=False)` is the
numpy path for a caller of the library.

A file the C++ parser declines (a residue type it does not know: a negative
return) goes to the numpy parser, whose error is the format's. The buffers
hold one CA record a line of the file, so no structure is truncated.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from genie2_tpu_torch.features.pdb import parse_pdb
from genie2_tpu_torch.ops.build import finish_compile, keyed_library, start_compile

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "csrc", "pdb_parser.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "host")
CXX = os.environ.get("CXX", "g++")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """The library of SOURCE in BUILD_DIR, keyed by the source and the flags."""
    return keyed_library(BUILD_DIR, "pdb_parser", CXX_FLAGS, [SOURCE])


def build() -> str:
    """Compile SOURCE with CXX unless its library exists; returns the
    library's path. Raises RuntimeError with the compiler's output."""
    target = library_path()
    if os.path.isfile(target):
        return target
    try:
        proc, tmp = start_compile([CXX, *CXX_FLAGS], SOURCE, target)
    except OSError as exc:
        raise RuntimeError(f"reading PDB files needs a C++ compiler, and {CXX!r} cannot run ({exc}): "
                           "install g++ or point the CXX environment variable at a C++ compiler") from exc
    code, text = finish_compile(proc, tmp, target)
    if code != 0:
        raise RuntimeError(f"{CXX} {' '.join(CXX_FLAGS)} {SOURCE} failed (exit {code}):\n{text}")
    return target


def load_library() -> ctypes.CDLL:
    """The parser's library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.parse_pdb_ca.restype = ctypes.c_int64
            lib.parse_pdb_ca.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def parse_pdb_fast(filepath: str) -> Tuple[List[List[int]], List[List[List[float]]]]:
    """`parse_pdb` through the C++ parser, coordinates float32-rounded."""
    lib = load_library()
    opener = gzip.open if filepath.endswith(".gz") else open
    with opener(filepath, "rb") as f:
        data = f.read()
    capacity = data.count(b"\n") + 1  # at most one CA record a line
    coords = np.empty((capacity, 3), dtype=np.float32)
    restypes = np.empty(capacity, dtype=np.int32)
    chain_ids = np.empty(capacity, dtype=np.int32)
    n = lib.parse_pdb_ca(
        data, len(data), coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        restypes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        chain_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), capacity,
    )
    if n < 0:  # a residue type the C++ parser does not know: the numpy parser's error
        return parse_pdb(filepath)
    seqs: List[List[int]] = []
    out_coords: List[List[List[float]]] = []
    for c in range(chain_ids[:n].max() + 1 if n else 0):
        m = chain_ids[:n] == c
        seqs.append(restypes[:n][m].tolist())
        out_coords.append(coords[:n][m].astype(float).tolist())
    return seqs, out_coords
