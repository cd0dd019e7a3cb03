"""Build and load the port's host-native C++ ops (the port of
deepspeed_tpu/ops/op_builder/builder.py).

The sources are the port's own copies under `ops/csrc/` (byte for byte
the JAX package's `csrc/adam/cpu_adam.cpp` and `csrc/aio/ds_aio.cpp`),
compiled with the JAX builder's command

    g++ -O3 -shared -fPIC -std=c++17 -march=native -fopenmp <src> -o <lib>

at first use into `ops/_build/` (git-ignored) and loaded with `ctypes`,
with the JAX builder's `argtypes` (builder.py:125-178).  The library's
name carries a hash of the source, the flags, the compiler's version and
the target `-march=native` resolves to on this host (`g++ -march=native
-Q --help=target`: the CPU name and every ISA switch), so a library
built for one host's instruction set is never loaded on another.  The
compiler is $CXX, else `g++`, the first that supports OpenMP.  A missing
`g++` or a failed build raises with the compiler's output; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
             "-fopenmp"]

_HOST_TARGET: Dict[str, str] = {}


def _has_openmp(cxx: str) -> bool:
    """True iff the compiler driver finds its `libgomp.spec` (what
    `-fopenmp` reads): a toolchain without it cannot build these ops."""
    proc = subprocess.run([cxx, "-print-file-name=libgomp.spec"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    return proc.returncode == 0 and os.path.isabs(proc.stdout.strip())


def find_cxx() -> str:
    """The C++ compiler: $CXX, else g++ on PATH, the first of them that
    supports OpenMP (a wrapper toolchain set in $CXX may lack libgomp)."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else []
    found = [c for c in (shutil.which(n) for n in names + ["g++"]) if c]
    if not found:
        raise RuntimeError(
            f"{' or '.join(names + ['g++'])} not found on PATH: the port's "
            f"host ops (the CPU Adam, the aio engine) are compiled from "
            f"source at first use")
    for cxx in found:
        if _has_openmp(cxx):
            return cxx
    raise RuntimeError(f"no compiler with OpenMP (libgomp.spec) among "
                       f"{found}: the host ops build with -fopenmp")


def host_target(cxx: str) -> str:
    """The compiler's version and what `-march=native` resolves to here."""
    if cxx not in _HOST_TARGET:
        out = []
        for args in (["--version"], ["-march=native", "-Q",
                                     "--help=target"]):
            proc = subprocess.run([cxx, *args], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} {' '.join(args)} failed:\n"
                                   f"{proc.stdout}")
            out.append(proc.stdout)
        _HOST_TARGET[cxx] = "\n".join(out)
    return _HOST_TARGET[cxx]


class OpBuilder:
    NAME = "base"

    def sources(self) -> List[str]:
        """Source paths relative to `ops/csrc/`."""
        raise NotImplementedError

    def extra_ldflags(self) -> List[str]:
        return []

    def lib_path(self, cxx: str) -> str:
        h = hashlib.sha256()
        for s in self.sources():
            with open(os.path.join(CSRC, s), "rb") as f:
                h.update(f.read())
        h.update(" ".join(CXX_FLAGS + self.extra_ldflags()).encode())
        h.update(host_target(cxx).encode())
        return os.path.join(BUILD_DIR, f"{self.NAME}-{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile unless the library exists; returns its path."""
        cxx = find_cxx()
        out = self.lib_path(cxx)
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cxx, *CXX_FLAGS,
               *[os.path.join(CSRC, s) for s in self.sources()],
               "-o", tmp, *self.extra_ldflags()]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"op {self.NAME} build failed: "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, out)   # atomic: a concurrent build loads either
        return out

    def load(self) -> ctypes.CDLL:
        lib = ctypes.CDLL(self.build())
        self._bind(lib)
        return lib

    def _bind(self, lib: ctypes.CDLL) -> None:
        """Set argtypes / restype (a 64-bit pointer passed without them is
        cut to 32 bits)."""


class CPUAdamBuilder(OpBuilder):
    NAME = "cpu_adam"

    def sources(self):
        return ["adam/cpu_adam.cpp"]

    def _bind(self, lib):
        f32p = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        hp = [ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
              ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        lib.ds_adam_step.restype = None
        lib.ds_adam_step.argtypes = [ctypes.c_int64, f32p, f32p, f32p,
                                     f32p, *hp]
        lib.ds_adam_step_bf16.restype = None
        lib.ds_adam_step_bf16.argtypes = [ctypes.c_int64, f32p, f32p, f32p,
                                          f32p, u16p, *hp]


class AsyncIOBuilder(OpBuilder):
    NAME = "async_io"

    def sources(self):
        return ["aio/ds_aio.cpp"]

    def extra_ldflags(self):
        return ["-lpthread"]

    def _bind(self, lib):
        lib.aio_handle_create.restype = ctypes.c_void_p
        lib.aio_handle_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
        lib.aio_handle_create2.restype = ctypes.c_void_p
        lib.aio_handle_create2.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int]
        lib.aio_uring_supported.restype = ctypes.c_int
        lib.aio_uring_supported.argtypes = []
        lib.aio_handle_engine.restype = ctypes.c_int
        lib.aio_handle_engine.argtypes = [ctypes.c_void_p]
        lib.aio_handle_destroy.restype = None
        lib.aio_handle_destroy.argtypes = [ctypes.c_void_p]
        common = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                  ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.aio_pwrite.restype = ctypes.c_int
        lib.aio_pwrite.argtypes = common
        lib.aio_pread.restype = ctypes.c_int
        lib.aio_pread.argtypes = common
        lib.aio_wait.restype = ctypes.c_int
        lib.aio_wait.argtypes = [ctypes.c_void_p]


ALL_OPS: Dict[str, type] = {CPUAdamBuilder.NAME: CPUAdamBuilder,
                            AsyncIOBuilder.NAME: AsyncIOBuilder}

_LOADED: Dict[str, ctypes.CDLL] = {}


def get_op(name: str) -> ctypes.CDLL:
    """The op's library, built if needed, loaded once a process."""
    if name not in _LOADED:
        _LOADED[name] = ALL_OPS[name]().load()
    return _LOADED[name]


def set_omp_threads(n: int) -> None:
    """The OpenMP thread count of the host ops' parallel loops, set on the
    calling thread through the `libgomp.so.1` they were loaded against.
    Where torch's wheel bundles a `libgomp.so.1` of that name, loaded
    first, it is one runtime with torch's intra-op pool, so callers pass
    `torch.get_num_threads()` and the two never disagree; the host ops
    run between torch calls on the same thread, never beside them."""
    get_op(CPUAdamBuilder.NAME)
    ctypes.CDLL("libgomp.so.1").omp_set_num_threads(int(n))
