from .builder import (ALL_OPS, AsyncIOBuilder, CPUAdamBuilder, OpBuilder,
                      get_op, set_omp_threads)

__all__ = ["ALL_OPS", "OpBuilder", "CPUAdamBuilder", "AsyncIOBuilder",
           "get_op", "set_omp_threads"]
