"""Build the CUDA kernels in `csrc/` into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for `sm_90a` into its own `build/kernels/<name>-<hash>.so` next to the
package; the hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. All sources compile in
parallel, one `nvcc` each. There is no fallback: a missing `nvcc` or a
failed build raises. The host C++ parser (`features/pdb_native.py`)
is keyed and compiled by the same `keyed_library`, `start_compile` and
`finish_compile`, with g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

SOURCES = ("trimul_project", "trimul_contract", "trimul_epilogue", "ipa_attention", "triangle_contract",
           "tri_att_flash", "pair_transition")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def keyed_library(build_dir: str, name: str, flags, files) -> str:
    """`build_dir/<name>-<hash>.so`, the hash over the flags and the bytes of
    `files`: an edited source or flag gets a library of its own."""
    h = hashlib.sha1(" ".join(flags).encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"{name}-{h.hexdigest()[:12]}.so")


def start_compile(cmd, source: str, target: str):
    """Start `cmd -o <tmp> source` for the library `target`, into a file of
    this process and thread that `finish_compile` moves into place, so that
    a reader never sees half a library. Returns (process, tmp)."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen([*cmd, "-o", tmp, source], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp


def finish_compile(proc, tmp: str, target: str):
    """Wait for a `start_compile`; on success move its library to `target`.
    Returns (exit code, the compiler's output)."""
    out, _ = proc.communicate()
    if proc.returncode == 0:
        os.replace(tmp, target)
    return proc.returncode, out.decode(errors="replace")


def library_path(name: str) -> str:
    """The path of csrc/<name>.cu's library, keyed by the source, the
    shared headers and the flags."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return keyed_library(BUILD_DIR, name, NVCC_FLAGS, [os.path.join(CSRC_DIR, f) for f in [f"{name}.cu", *headers]])


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every source that has no up-to-date library, all at once.
    Returns {name: seconds} for the sources compiled in this call."""
    pending = {name: library_path(name) for name in SOURCES if not os.path.isfile(library_path(name))}
    if not pending:
        return {}
    nvcc = find_nvcc()
    start = time.perf_counter()
    procs = {name: start_compile([nvcc, *NVCC_FLAGS], os.path.join(CSRC_DIR, f"{name}.cu"), target)
             for name, target in pending.items()}
    seconds, failures = {}, []
    for name, (proc, tmp) in procs.items():
        code, text = finish_compile(proc, tmp, pending[name])
        seconds[name] = time.perf_counter() - start
        if code != 0:
            failures.append(f"{name}.cu (exit {code}):\n{text}")
        elif verbose:
            print(f"[build] {name}.cu in {seconds[name]:.1f} s\n{text}", flush=True)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def override(name: str, path):
    """Take csrc/<name>.cu's entry points from the library at `path` (a
    variant built elsewhere, tools/torch_kernel_variants.py), or with None
    from the built one again."""
    with _lock:
        if path is None:
            _libs.pop(name, None)
        else:
            _libs[name] = ctypes.CDLL(path)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
