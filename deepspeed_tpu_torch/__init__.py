"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (`deepspeed_tpu/`) stays the reference; this package
keeps its module layout and names so each counterpart sits at the same
path, and imports neither `jax` nor anything of `deepspeed_tpu`.

What is ported so far is the serving slice: a dense GPT-2 served through
a paged KV cache (`serving/`), with paged attention as a CUDA C++ kernel
written for Hopper (`kernels/csrc/paged_attention.cu`).  Entry points
run on the card unless the caller passes `device="cpu"`.

Importing the package builds no kernel and touches no CUDA state: the
kernel library is compiled at first launch (`kernels/build.py`).
"""

__version__ = "0.1.0"
