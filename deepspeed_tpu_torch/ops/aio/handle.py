"""The native async file-I/O engine (the port of
deepspeed_tpu/ops/aio/handle.py) over `ops/csrc/aio/ds_aio.cpp`, the JAX
package's source byte for byte: a raw-syscall io_uring engine, or a
std::thread pread/pwrite pool.

The "auto" engine is JAX's run-time choice: io_uring where the kernel and
the seccomp policy let a ring be created, else the thread pool; the
handle's `engine` says which one was built.  A buffer is a C-contiguous
numpy array or a contiguous CPU tensor (pinned or not).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ..op_builder import AsyncIOBuilder, get_op


def uring_supported() -> bool:
    """True iff an io_uring ring can be created (kernel + seccomp)."""
    return bool(get_op(AsyncIOBuilder.NAME).aio_uring_supported())


def alloc_aligned(nbytes: int, dtype=np.uint8, align: int = 4096):
    """A buffer whose data pointer is `align`-aligned: O_DIRECT needs
    4 KiB-aligned addresses, lengths and offsets, or the engine does that
    op as buffered I/O."""
    dt = np.dtype(dtype)
    raw = np.empty(nbytes + align, np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes].view(dt)


def _addr(buf):
    if torch.is_tensor(buf):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio needs a contiguous CPU tensor")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("aio needs a C-contiguous buffer")
    return buf.ctypes.data, buf.nbytes


class AsyncIOHandle:
    """Asynchronous reads and writes of host buffers against files:

        h = AsyncIOHandle(n_threads=4)
        h.async_pwrite(arr, "/nvme/shard0.bin")
        ...                       # overlapped work
        h.wait()

    engine: "auto" (DSTPU_AIO_ENGINE steers only this default), "uring"
    or "threads"; n_threads doubles as the io_uring queue depth."""

    def __init__(self, n_threads: int = 4, block_size: int = 1 << 20,
                 o_direct: bool = False, engine: str = "auto"):
        self._lib = get_op(AsyncIOBuilder.NAME)
        self._h = None
        if engine == "auto":
            engine = os.environ.get("DSTPU_AIO_ENGINE", engine).lower()
        codes = {"auto": 0, "threads": 1, "uring": 2}
        if engine not in codes:
            raise ValueError(f"unknown aio engine {engine!r}; "
                             f"use auto | threads | uring")
        self._h = self._lib.aio_handle_create2(int(n_threads),
                                               int(block_size),
                                               1 if o_direct else 0,
                                               codes[engine])
        if not self._h:
            raise RuntimeError(f"aio engine {engine!r} unavailable "
                               f"(io_uring blocked by the kernel or "
                               f"seccomp?)")
        # what was built: "auto" may fall back during construction
        self.engine = {1: "threads",
                       2: "uring"}[self._lib.aio_handle_engine(self._h)]
        self._held = []   # submitted buffers, kept alive until wait()

    def _submit(self, fn, buf, path: str, file_offset: int, what: str):
        ptr, nbytes = _addr(buf)
        self._held.append(buf)
        if fn(self._h, ptr, path.encode(), nbytes, int(file_offset), 1):
            raise IOError(f"{what} submit failed for {path}")

    def async_pwrite(self, buf, path: str, file_offset: int = 0):
        self._submit(self._lib.aio_pwrite, buf, path, file_offset,
                     "aio_pwrite")

    def async_pread(self, buf, path: str, file_offset: int = 0):
        self._submit(self._lib.aio_pread, buf, path, file_offset,
                     "aio_pread")

    def sync_pwrite(self, buf, path: str, file_offset: int = 0):
        self.async_pwrite(buf, path, file_offset)
        self.wait()

    def sync_pread(self, buf, path: str, file_offset: int = 0):
        self.async_pread(buf, path, file_offset)
        self.wait()

    def wait(self):
        errors = self._lib.aio_wait(self._h)
        self._held.clear()
        if errors:
            raise IOError(f"aio: {errors} operation(s) failed")

    def close(self):
        if self._h is not None:
            self._lib.aio_handle_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_DEFAULT: Optional[AsyncIOHandle] = None


def _default() -> AsyncIOHandle:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = AsyncIOHandle()
    return _DEFAULT


def aio_write(buf, path: str):
    """Blocking write of a whole buffer."""
    _default().sync_pwrite(buf, path)


def aio_read(buf, path: str):
    """Blocking read into a whole buffer."""
    _default().sync_pread(buf, path)
