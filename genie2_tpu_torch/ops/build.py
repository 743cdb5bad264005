"""Build the CUDA kernels in `csrc/` into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for `sm_90a` into its own `build/kernels/<name>-<hash>.so` next to the
package; the hash covers the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. All sources compile in
parallel, one `nvcc` each. There is no fallback: a missing `nvcc` or a
failed build raises. Every `csrc/*.cu` is a kernel source (`SOURCES`).
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

SOURCES = tuple(sorted(f[:-len(".cu")] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")))

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


def library_path(name: str) -> str:
    """`build/kernels/<name>-<hash>.so`, the hash over the flags and the
    bytes of csrc/<name>.cu and the shared headers: an edited source or
    flag gets a library of its own."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every source that has no up-to-date library, all at once.
    Returns {name: seconds} for the sources compiled in this call."""
    pending = {name: library_path(name) for name in SOURCES if not os.path.isfile(library_path(name))}
    if not pending:
        return {}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    # Each library is written to a file of this process and thread and
    # moved into place once whole, so that a reader never sees half of one.
    procs = {}
    for name, target in pending.items():
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    seconds, failures = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, pending[name])
        if verbose:
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
