"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (`deepspeed_tpu/`) stays the reference; this package
keeps its module layout and names so each counterpart sits at the same
path, and imports neither `jax` nor anything of `deepspeed_tpu`.

Ported so far:

* serving: a dense GPT-2 served through a paged KV cache (`serving/`),
  with paged attention as a CUDA C++ kernel written for Hopper
  (`kernels/csrc/paged_attention.cu`);
* single-process training: `initialize` -> `DeepSpeedEngine`
  (`runtime/`) with FusedAdam, the LR schedules and loss scaling, over the
  GPT forward and loss (`models/gpt.py`), with flash attention forward,
  dQ and dK/dV as CUDA C++ kernels (`kernels/csrc/flash_attention.cu`);
* the fused LM-head cross-entropy (`loss_impl="pallas"`: forward, dx and
  dW kernels, `kernels/csrc/fused_xent.cu`), and serving over an int8/int4
  KV cache (dequantized in the paged kernel) with speculative decoding;
* serving from int8/int4 blockwise-quantized weights (the codec kernels,
  `kernels/csrc/quant_codec.cu`) and Mixture-of-Experts training through
  the sorted dispatch (`moe/`, the dispatch and combine kernels,
  `kernels/csrc/moe_dispatch.cu`);
* BERT pretraining (MLM + NSP, `models/bert.py`) through the fused
  transformer layer (`ops/transformer/transformer.py`) with block-sparse
  attention (`ops/sparse_attention/`: the SparsityConfig layouts, the
  gather path, and the sparse flash forward, dQ and dK/dV as CUDA C++
  kernels, `kernels/csrc/flash_sparse.cu`);
* resumable training: `save_checkpoint` / `load_checkpoint` in the JAX
  engine's tag layout and msgpack encoding (`runtime/checkpointing.py`),
  and the engine-owned loader (`training_data`, `runtime/dataloader.py`);
* MoE dropless (the overflow bucket, `moe/dispatch.py`), and
  data-parallel training over `torch.distributed` (`comm/`,
  `init_distributed`) at ZeRO stage 0, 1 and 2 (`runtime/zero/`) with
  the implicit and the bucketed gradient wire (`runtime/comm/`);
* ZeRO stage 3 (parameters sharded over the data ranks, gathered a
  block at a time on use, `runtime/zero/stage3.py`) with the int8/int4
  weight gather (qwZ), and `zero.Init`, `zero.GatheredParameters`,
  `zero.TiledLinear` and `utils/zero_to_fp32.py`.

Entry points run on the card unless the caller passes `device="cpu"`.
Importing the package builds no kernel and touches no CUDA state: a
kernel library is compiled at its first launch (`kernels/build.py`).
"""

__version__ = "0.3.0"

from .comm import init_distributed  # noqa: F401,E402
from .runtime import zero  # noqa: F401,E402


class PipelineModule:
    """Placeholder for deepspeed_tpu's PipelineModule: pipelines are not
    ported yet, and building one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PipelineModule is not ported to deepspeed_tpu_torch yet "
            "(ROADMAP queue 1: pipeline)")


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               mpu=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               device="cuda"):
    """Initialize the training engine (deepspeed_tpu/__init__.py:37).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    `model` is an `nn.Module` whose call returns the training loss (the
    port's `models.GPT`); `model_parameters`, when given, is a JAX-style
    params tree loaded into it (`models.load_jax_params`);
    `training_data`, when given, is an indexable dataset of samples that
    the engine's own loader batches and shuffles (`train_batch()` with no
    iterator trains from it).  The engine runs on `device` — the card
    unless "cpu" is asked for."""
    from .runtime.engine import DeepSpeedEngine

    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config_params=config,
                             device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
