"""Boundaries of the PyTorch port: `deepspeed_tpu_torch`,
`chip_smoke.py`, `chip_ab.py`, `chip_profile_moe.py`,
`chip_dq_processes.py`, `chip_fleet_threads.py`, `chip_monitor_ab.py` and
`chip_cut_costs.py` load neither
JAX, flax, optax nor the JAX package, and the entry points run on the
card unless the CPU is asked for."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deepspeed_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _python_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_ab.py")
    yield os.path.join(REPO, "chip_profile_moe.py")
    yield os.path.join(REPO, "chip_dq_processes.py")
    yield os.path.join(REPO, "chip_fleet_threads.py")
    yield os.path.join(REPO, "chip_monitor_ab.py")
    yield os.path.join(REPO, "chip_cut_costs.py")


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """Every import statement, at any depth, of the port and of the
    chip scripts, including the code each chip_ab.py turn runs (parsed,
    not run)."""
    bad = []
    for path in _python_files():
        with open(path) as f:
            trees = [ast.parse(f.read(), filename=path)]
        if path.endswith("chip_ab.py"):
            sys.path.insert(0, REPO)
            try:
                import chip_ab
            finally:
                sys.path.remove(REPO)
            trees += [ast.parse(code) for code in chip_ab.TURNS.values()]
        for node in (n for t in trees for n in ast.walk(t)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest):
    JAX and the JAX package are made unimportable, then every module of
    the port is imported."""
    code = f"""
import importlib, pkgutil, sys
for name in list(sys.modules):
    if name.split(".")[0] in {FORBIDDEN!r}:
        del sys.modules[name]
for name in {FORBIDDEN!r}:
    sys.modules[name] = None     # any import of them now raises
sys.path.insert(0, {REPO!r})
import deepspeed_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    deepspeed_tpu_torch.__path__, prefix="deepspeed_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
assert not torch.cuda.is_initialized()
print(" ".join(mods))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = set(r.stdout.split())
    assert len(mods) >= 20
    # the modules of the quantized-weight serving and MoE slices
    assert {f"deepspeed_tpu_torch.{m}" for m in (
        "kernels.quant_codec", "kernels.moe_kernels", "moe.dispatch",
        "moe.layer", "runtime.comm.quant", "serving.programs",
        "runtime.checkpointing", "runtime.dataloader",
        "runtime.bs_schedules", "runtime.resilience",
        # HF interop, injection, the optimizer family, layer drop
        "models.hf", "module_inject.replace_module", "ops.lamb.fused_lamb",
        "runtime.comm.compressed", "runtime.fp16.onebit.adam",
        "runtime.fp16.onebit.lamb", "runtime.client_optimizer",
        "runtime.progressive_layer_drop",
        # the run monitor and the resilience runtime
        "monitor.config", "monitor.monitor", "monitor.spans",
        "monitor.report", "monitor.artifacts", "utils.timer",
        "utils.tensorboard", "profiling.config",
        "profiling.flops_profiler.profiler", "elasticity.elasticity",
        "elasticity.constants")} <= mods


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.kernels import flash, registry
    from deepspeed_tpu_torch.models import GPT, generate, gpt2_config
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.serving import ServeEngine

    cfg = gpt2_config("nano", num_layers=1)
    model = GPT(cfg, device="cpu")
    ds_config = {"train_batch_size": 2}
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GPT(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(model)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        generate(model, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        deepspeed_tpu_torch.initialize(model=model, config_params=ds_config)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DeepSpeedEngine(model=model, config_params=ds_config)
    # the flash ops: the kernels take CUDA tensors only; forcing them on
    # CPU tensors raises, and the CPU path is the plain version
    q = torch.zeros(2, 128, 64)
    opts = dict(causal=True, scale=0.125, block_q=128, block_k=128,
                rate=0.0, seed=0, bh_offset=0, n_heads=1)
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert registry.resolve_impl(name, "auto", q) == "torch"
        with pytest.raises(RuntimeError, match="impl='cuda'"):
            registry.resolve_impl(name, "cuda", q)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_dq_cuda(q, q, q, q, torch.zeros(2, 128),
                            torch.zeros(2, 128), None, **opts)
    # the codec and MoE ops likewise
    for name in ("quant_codec_quantize", "quant_codec_dequantize",
                 "moe_dispatch", "moe_combine"):
        assert registry.resolve_impl(name, "auto", q) == "torch"
        with pytest.raises(RuntimeError, match="impl='cuda'"):
            registry.resolve_impl(name, "cuda", q)
    # a CPU model on a CPU engine trains without asking for the card
    eng, *_ = deepspeed_tpu_torch.initialize(model=model,
                                             config_params=ds_config,
                                             device="cpu")
    assert eng.device.type == "cpu"


def test_engine_refuses_a_model_on_another_device(monkeypatch):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.serving import ServeEngine

    model = GPT(gpt2_config("nano", num_layers=1), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lives on cpu"):
        ServeEngine(model, device="cuda")
    with pytest.raises(ValueError, match="lives on cpu"):
        deepspeed_tpu_torch.initialize(model=model,
                                       config_params={"train_batch_size": 2},
                                       device="cuda")


def _run_smoke(cwd, fake_cuda):
    prelude = ("import torch; torch.cuda.is_available = lambda: True; "
               if fake_cuda else "")
    code = (prelude + "import runpy, sys; sys.argv = ['chip_smoke.py']; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    r = _run_smoke(REPO, fake_cuda=False)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone_without_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo
    fails before it prints any result, even where CUDA looks present."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), fake_cuda=True)
    assert r.returncode != 0
    assert "deepspeed_tpu_torch" in r.stderr
    assert '"ok"' not in r.stdout
