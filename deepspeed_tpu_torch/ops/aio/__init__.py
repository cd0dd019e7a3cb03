from ..op_builder import AsyncIOBuilder  # noqa: F401
from .handle import (AsyncIOHandle, aio_read, aio_write, alloc_aligned,
                     uring_supported)

__all__ = ["AsyncIOHandle", "aio_read", "aio_write", "AsyncIOBuilder",
           "alloc_aligned", "uring_supported"]
