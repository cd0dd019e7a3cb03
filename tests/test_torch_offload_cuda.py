"""ZeRO-Offload and ZeRO-Infinity on the card (no JAX here: this file
runs on the GPU machine with `python -m pytest --noconftest -m cuda
tests/test_torch_offload_cuda.py`).  The overlapped host step (pinned
copies on a side stream, the host Adam between them) is held to the
synchronous numpy step bit for bit; the streamed engine to the resident
one within tests/test_torch_infinity.py's bounds (losses rtol 1e-4,
masters rtol 5e-3 + atol 1e-5), with the kernels' launches counted."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.kernels import flash, fused_xent  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.offload import \
    CPUOffloadRuntime  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_offload_cuda.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_overlapped_host_step_is_bitwise_the_synchronous_one(
        cuda_device, dtype):
    shapes = [(1600, 4800), (4800,), (6400, 1600), (1600,), (50, 7)]
    gen = torch.Generator().manual_seed(1)
    leaves = [torch.randn(s, generator=gen) * 0.02 for s in shapes]
    hp = {"lr": 1e-3, "weight_decay": 0.01}
    card = CPUOffloadRuntime(leaves, hp, param_dtype=dtype,
                             device=cuda_device)
    sync = CPUOffloadRuntime(leaves, hp, param_dtype=dtype)
    out = [torch.empty(s, dtype=dtype, device=cuda_device) for s in shapes]
    dgen = torch.Generator(device=cuda_device).manual_seed(2)
    for step in range(4):
        g = [torch.randn(s, device=cuda_device, generator=dgen) * 64
             for s in shapes]
        if step == 1:
            g[2].view(-1)[11] = float("nan")
        _, ov_c, n_c = card.step(g, 128.0, 1e-3, clip=1.0, out=out)
        host, ov_s, n_s = sync.step([t.cpu().numpy() for t in g], 128.0,
                                    1e-3, clip=1.0)
        torch.cuda.synchronize()
        assert (ov_c, n_c) == (ov_s, n_s) and ov_c == (step == 1)
        for a, b in zip(card.masters, sync.masters):
            assert np.array_equal(a.view(np.int32), b.view(np.int32))
        if not ov_s:
            for o, h in zip(out, host):
                h = h if torch.is_tensor(h) else torch.from_numpy(h)
                assert torch.equal(o.cpu(), h)
    assert card.pinned_bytes() > 0 and {"d2h_ms", "adam_ms", "h2d_ms"} <= \
        set(card.last_timing)


def _train(zero, steps=3, micro=4, seq=256):
    cfg = gpt2_config("nano", d_model=128, num_heads=2, max_seq_len=seq,
                      vocab_size=512, loss_impl="pallas")
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(3))
    eng, *_ = dt.initialize(model=model, config_params={
        "train_batch_size": micro, "train_micro_batch_size_per_gpu": micro,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "gradient_clipping": 1.0, "steps_per_print": 0,
        "zero_optimization": zero})
    n0 = {**dict(flash.LAUNCHES), **dict(fused_xent.LAUNCHES)}
    rng = np.random.RandomState(5)
    losses = []
    for _ in range(steps):
        t = rng.randint(0, 512, (micro, seq + 1))
        losses.append(float(eng.forward((t[:, :-1], t[:, 1:]))))
        eng.backward()
        eng.step()
    n1 = {**dict(flash.LAUNCHES), **dict(fused_xent.LAUNCHES)}
    masters = {n: t.detach().float().cpu() for n, t in eng.params.items()}
    return losses, masters, {k: n1[k] - n0[k] for k in n1}


@pytest.mark.cuda
def test_cuda_offload_and_infinity_track_zero0(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    lr_, mr, _ = _train({"stage": 0})
    for zero, fwd in (({"stage": 0, "offload_optimizer": {"device": "cpu"}},
                       1),
                      ({"stage": 3, "offload_param": {"device": "cpu"}}, 2)):
        lo, mo, n = _train(zero)
        np.testing.assert_allclose(lo, lr_, rtol=1e-4)
        for k in mr:
            np.testing.assert_allclose(mo[k], mr[k], rtol=5e-3, atol=1e-5)
        assert n == {"flash_attention_fwd": fwd * 3 * 3,
                     "flash_attention_dq": 3 * 3,
                     "flash_attention_dkv": 3 * 3,
                     "fused_xent_fwd": 3, "fused_xent_dx": 3,
                     "fused_xent_dw": 3}
