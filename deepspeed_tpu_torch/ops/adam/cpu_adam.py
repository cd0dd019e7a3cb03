"""HostAdam — the native host Adam of optimizer-state offload (the port of
deepspeed_tpu/ops/adam/cpu_adam.py).

The fp32 master parameters and the Adam moments live in host memory;
`update_flat` runs `ds_adam_step` (or `ds_adam_step_bf16`, which also
writes the updated parameters as bf16, round to nearest even) of
`ops/csrc/adam/cpu_adam.cpp`, the JAX package's source byte for byte,
built with the same flags, so a step is bitwise JAX's on the same inputs.
A buffer is a C-contiguous numpy array or a contiguous CPU tensor (pinned
or not), passed by its data pointer; the moments are numpy arrays.  The
OpenMP loops run on torch's intra-op thread count, set before each
step's updates (`op_builder.set_omp_threads`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..op_builder import CPUAdamBuilder, get_op, set_omp_threads

_U16_TORCH = (torch.bfloat16, torch.int16, torch.uint16)


def _ptr(buf, ctype, what, dtypes):
    if torch.is_tensor(buf):
        if buf.device.type != "cpu" or not buf.is_contiguous() or \
                buf.dtype not in dtypes[1]:
            raise ValueError(f"{what}: a contiguous CPU tensor of "
                             f"{dtypes[1]}, got {buf.dtype} on {buf.device}")
        return ctypes.cast(buf.data_ptr(), ctypes.POINTER(ctype))
    if buf.dtype != dtypes[0] or not buf.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{what}: a C-contiguous {dtypes[0]} array, got "
                         f"{buf.dtype}")
    return buf.ctypes.data_as(ctypes.POINTER(ctype))


def _numel(buf) -> int:
    return buf.numel() if torch.is_tensor(buf) else buf.size


_F32 = (np.float32, (torch.float32,))
_U16 = (np.uint16, _U16_TORCH)


class HostAdam:
    """Flat-buffer host Adam (one buffer a parameter leaf), keyed by an
    int; it updates host state in place."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, bias_correction=True):
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.step_count = 0
        self._lib = get_op(CPUAdamBuilder.NAME)
        self._state: Dict[int, Dict[str, np.ndarray]] = {}

    def state_for(self, key: int, n: int):
        if key not in self._state:
            self._state[key] = {"m": np.zeros(n, np.float32),
                                "v": np.zeros(n, np.float32)}
        return self._state[key]

    def begin_step(self):
        """Count the step and fix its bias-correction terms (cpu_adam.py
        :52-58, in Python floats as there)."""
        self.step_count += 1
        if self.bias_correction:
            self._bc1 = 1.0 - self.betas[0] ** self.step_count
            self._bc2 = 1.0 - self.betas[1] ** self.step_count
        else:
            self._bc1 = self._bc2 = 1.0
        set_omp_threads(torch.get_num_threads())

    def update_flat(self, key: int, params, grads, lr=None, out_bf16=None):
        """In-place Adam on one flat fp32 buffer; with `out_bf16` (uint16
        array or a bf16 / 16-bit integer tensor of the same size) also the
        updated parameters as bf16."""
        n = _numel(params)
        if _numel(grads) != n:
            raise ValueError(f"leaf {key}: {_numel(grads)} gradients for "
                             f"{n} parameters")
        st = self.state_for(key, n)
        args = (n, _ptr(params, ctypes.c_float, "params", _F32),
                _ptr(grads, ctypes.c_float, "grads", _F32),
                _ptr(st["m"], ctypes.c_float, "m", _F32),
                _ptr(st["v"], ctypes.c_float, "v", _F32))
        hp = (ctypes.c_float(self.lr if lr is None else lr),
              ctypes.c_float(self.betas[0]), ctypes.c_float(self.betas[1]),
              ctypes.c_float(self.eps), ctypes.c_float(self.weight_decay),
              1 if self.adam_w_mode else 0,
              ctypes.c_float(self._bc1), ctypes.c_float(self._bc2))
        if out_bf16 is not None:
            if _numel(out_bf16) != n:
                raise ValueError(f"leaf {key}: a bf16 output of "
                                 f"{_numel(out_bf16)} for {n} parameters")
            u16 = _ptr(out_bf16, ctypes.c_uint16, "out_bf16", _U16)
            self._lib.ds_adam_step_bf16(*args, u16, *hp)
        else:
            self._lib.ds_adam_step(*args, *hp)

    # checkpointing ----------------------------------------------------
    def state_dict(self):
        # string keys: msgpack (the tag's encoding) takes no int map keys
        return {"step": self.step_count,
                "state": {str(k): {kk: vv.copy() for kk, vv in s.items()}
                          for k, s in self._state.items()}}

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        self._state = {int(k): {kk: np.array(vv, np.float32)
                                for kk, vv in s.items()}
                       for k, s in sd["state"].items()}
