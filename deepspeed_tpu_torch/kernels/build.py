"""Build and load the port's CUDA kernels.

A source under `csrc/` is compiled by `nvcc` into a shared library with
a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

The build happens at first use, into `kernels/_build/` (git-ignored),
under a name that carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is loaded as it is.  Only
sources in this repository and the CUDA toolkit's headers are used.  A
missing `nvcc` or a failed build raises with nvcc's output; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per source built
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the port's CUDA kernels are compiled from source at first use")


def library_path(source: str) -> str:
    """The hash-named library a source builds into."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile `source` unless its library exists; returns the library
    path.  Raises with nvcc's output on failure."""
    path = library_path(source)
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                           os.path.join(CSRC, source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    BUILD_LOGS[source] = proc.stdout
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {source} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    # atomic: a concurrent builder sees no library or the whole one,
    # never a half-written one
    os.replace(tmp, path)
    return path


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = _LIBS[source] = ctypes.CDLL(build(source))
    return lib
