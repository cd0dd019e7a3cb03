"""zero_to_fp32 — a checkpoint tag -> one fp32 state dict: the port of
deepspeed_tpu/utils/zero_to_fp32.py (:25-81; the reference's
utils/zero_to_fp32.py:21-151).

A tag written by either engine, at any ZeRO stage and world size, holds
the module's fp32 masters: whole, or at stage 3 as `model:` pieces in
the per-rank files, which `load_checkpoint_state` puts back together
(runtime/checkpointing.py).  This strips the training state, upcasts
every floating leaf to fp32 and writes one msgpack file in the
checkpoints' own encoding.

Usage:
    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output_file> [-t TAG]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _to_fp32(x):
    if isinstance(x, dict):
        return {k: _to_fp32(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_fp32(v) for v in x]
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if np.issubdtype(arr.dtype, np.floating) \
        else arr


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: str = None):
    """The tag's module tree (nested dicts and lists, as the JAX params
    tree) with fp32 numpy leaves (reference zero_to_fp32.py:70-121)."""
    from ..runtime import checkpointing as ckpt_io

    _dir, model_state, _optim = ckpt_io.load_checkpoint_state(
        checkpoint_dir, tag)
    return _to_fp32(model_state["module"])


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str,
                                               output_file: str,
                                               tag: str = None):
    """Write the fp32 state dict as msgpack to `output_file`
    (reference zero_to_fp32.py:124-141); returns it."""
    from ..runtime import checkpointing as ckpt_io

    state_dict = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    with open(output_file, "wb") as fh:
        fh.write(ckpt_io.msgpack_serialize(state_dict))
    print(f"saved fp32 state dict to {output_file}")
    return state_dict


def load_state_dict_from_zero_checkpoint(checkpoint_dir: str, tag: str = None):
    """The fp32 tree, ready for `models.load_jax_params` (JAX's parity
    helper)."""
    return get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_dir",
                        help="checkpoint dir (holds 'latest' + tag dirs)")
    parser.add_argument("output_file",
                        help="output msgpack path for the fp32 state dict")
    parser.add_argument("-t", "--tag", default=None,
                        help="checkpoint tag (default: read 'latest')")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.checkpoint_dir):
        print(f"no such checkpoint dir: {args.checkpoint_dir}")
        return 1
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, tag=args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
