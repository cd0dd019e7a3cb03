"""Port parity: paged attention (deepspeed_tpu_torch/kernels/paged.py)
against the JAX package's plain version and its Pallas kernel.

The same numpy inputs go to both packages.  Tolerances:

* fp32 cache: atol 1e-5 — both sides compute fp32 scores, softmax and
  PV; they differ only in the order of fp32 sums (a few ulp of outputs
  of size ~1).
* bf16 cache: atol 2e-2 — both sides round probs to bf16 and return a
  bf16 output, so the bound is a few bf16 ulps (2^-8 relative) of
  outputs of size up to ~2.
* the CUDA kernel against the plain version, bf16: the per-element
  bound of `paged.bf16_tolerance` (the kernel keeps its probabilities in
  fp32), itself checked on the CPU against an emulation.

The CUDA kernel itself runs only on a card; its comparison against the
plain version is the `cuda`-marked test at the end (skipped here).  JAX
is imported inside the tests that compare with it, so that on a GPU
machine without JAX the `cuda` tests run alone:
`python -m pytest --noconftest -m cuda tests/test_torch_paged.py`."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import paged, registry  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.serving.kv_cache import \
    rows_for_tables  # noqa: E402

torch.set_num_threads(1)


def _inputs(T, Dh, R=2, H=2, bs=4, W=4, seed=0):
    """Random cache, scattered tables with repeats and the trash block,
    q positions anywhere in the table (numpy, shared by both sides)."""
    rng = np.random.RandomState(seed)
    nblocks = R * W + 1
    ck = rng.randn(nblocks * bs, H, Dh).astype(np.float32)
    cv = rng.randn(nblocks * bs, H, Dh).astype(np.float32)
    tables = rng.randint(0, nblocks, (R, W)).astype(np.int32)
    tables[0, 0] = 0                    # the trash block
    tables[0, 2] = tables[0, 1]         # a repeated block
    q = rng.randn(R, T, H, Dh).astype(np.float32)
    q_pos = rng.randint(0, W * bs, (R, T)).astype(np.int32)
    return q, ck, cv, tables, q_pos, bs


def _port(q, ck, cv, tables, q_pos, bs, dtype=torch.float32, impl="torch"):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    out = registry.dispatch("paged_attention", t(q), t(ck), t(cv), rows,
                            torch.from_numpy(q_pos).long(), impl=impl,
                            block_size=bs)
    return out.float().numpy()


@pytest.fixture
def jax_side():
    """The JAX package's paged attention: (jnp, its registry, its plain
    version, its rows_for_tables)."""
    jnp = pytest.importorskip("jax.numpy")
    from deepspeed_tpu.kernels import registry as jax_registry
    from deepspeed_tpu.kernels.paged import paged_attention_reference
    from deepspeed_tpu.serving.kv_cache import rows_for_tables as jax_rows

    return jnp, jax_registry, paged_attention_reference, jax_rows


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 3, 16])
def test_paged_reference_matches_jax_fp32(jax_side, T, Dh):
    jnp, _, jax_reference, jax_rows = jax_side
    q, ck, cv, tables, q_pos, bs = _inputs(T, Dh)
    want = jax_reference(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                         jax_rows(jnp.asarray(tables), bs),
                         jnp.asarray(q_pos), block_size=bs)
    got = _port(q, ck, cv, tables, q_pos, bs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 3, 16])
def test_paged_reference_matches_jax_pallas_kernel(jax_side, T, Dh):
    """The TPU kernel itself, run as the JAX package's tests run it on
    the CPU (the Pallas interpreter)."""
    jnp, jax_registry, _, jax_rows = jax_side
    q, ck, cv, tables, q_pos, bs = _inputs(T, Dh, seed=1)
    with jax_registry.kernel_config(interpret=True):
        want = jax_registry.dispatch(
            "paged_attention", jnp.asarray(q), jnp.asarray(ck),
            jnp.asarray(cv), jax_rows(jnp.asarray(tables), bs),
            jnp.asarray(q_pos), impl="pallas", kv_mode="dense",
            block_size=bs)
    got = _port(q, ck, cv, tables, q_pos, bs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_paged_reference_matches_jax_bf16_cache(jax_side):
    jnp, _, jax_reference, jax_rows = jax_side
    q, ck, cv, tables, q_pos, bs = _inputs(3, 64, seed=2)
    b = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jax_reference(b(q), b(ck), b(cv),
                         jax_rows(jnp.asarray(tables), bs),
                         jnp.asarray(q_pos), block_size=bs)
    assert want.dtype == jnp.bfloat16
    got = _port(q, ck, cv, tables, q_pos, bs, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


def test_kernel_wrapper_rejects_ragged_rows():
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    with pytest.raises(ValueError, match="whole cache blocks"):
        paged.paged_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            rows[:, :-1], torch.from_numpy(q_pos), block_size=bs)


def test_forced_cuda_on_cpu_tensors_raises():
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        _port(q, ck, cv, tables, q_pos, bs, impl="cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU tensor that reaches it
    directly is refused, never computed some other way."""
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    with pytest.raises(ValueError, match="not a CUDA device"):
        paged.paged_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            rows, torch.from_numpy(q_pos), block_size=bs)


def test_auto_on_cpu_runs_plain_version_and_counts_fallback():
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    launches = paged.LAUNCHES
    snap = COUNTERS.snapshot()
    auto = _port(q, ck, cv, tables, q_pos, bs, impl="auto")
    plain = _port(q, ck, cv, tables, q_pos, bs, impl="torch")
    d = COUNTERS.delta_since(snap)
    np.testing.assert_array_equal(auto, plain)
    assert d == {"kernel.fallbacks": {"calls": 2, "bytes": 0}}
    assert paged.LAUNCHES == launches
    with pytest.raises(ValueError, match="impl must be one of"):
        _port(q, ck, cv, tables, q_pos, bs, impl="pallas")


def test_quantized_kv_not_ported_yet():
    """The quantized branches are ported: kv_read gathers (payload,
    scales) rows and dequantizes them exactly as the row codec does, and
    an unknown mode is refused."""
    from deepspeed_tpu_torch.runtime.comm.quant import (dequantize_rows,
                                                        quantize_rows)

    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    for wire in ("int8", "int4"):
        pair = quantize_rows(torch.from_numpy(ck), wire)
        got = paged.kv_read(pair, rows, wire)
        want = dequantize_rows(pair[0], pair[1], wire)[rows]
        assert got.dtype == torch.float32 and got.shape == rows.shape + (2, 64)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int2"):
        paged.kv_read(torch.from_numpy(ck), rows, "int2")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_paged.py)")
    return torch.device("cuda")


def test_bf16_tolerance_holds_fp32_probabilities_and_catches_a_fault():
    """The bf16 bound of kernel vs plain version, checked on the CPU with
    the kernel's arithmetic emulated (fp32 probabilities into PV, one
    rounding of the output): the emulation stays inside it, and an output
    scaled by 1 + 2^-5 (a bf16-only fault of a few ulps) does not."""
    q, ck, cv, tables, q_pos, bs = _inputs(16, 64, R=3, H=4, bs=16, W=8)
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    qp = torch.from_numpy(q_pos).long()
    q_, ck_, cv_ = b(q), b(ck), b(cv)
    ref = paged.paged_attention_reference(q_, ck_, cv_, rows, qp)
    keys, vals = ck_[rows].float(), cv_[rows].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q_.float(), keys) * 64 ** -0.5
    mask = qp[:, :, None] >= torch.arange(rows.shape[1])[None, None, :]
    p = torch.softmax(torch.where(mask[:, None], s, paged.NEG_INF), dim=-1)
    emulated = torch.einsum("bhqk,bkhd->bqhd", p, vals).to(torch.bfloat16)
    tol = paged.bf16_tolerance(q_, ck_, cv_, rows, qp, ref)
    diff = (emulated.float() - ref.float()).abs()
    assert bool((diff <= tol).all())
    faulty = (emulated.float() * (1 + 2 ** -5)).to(torch.bfloat16)
    assert not bool(((faulty.float() - ref.float()).abs() <= tol).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_paged.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_layout", ["contiguous", "qkv_view", "fp32_q"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Dh", [(1, 64), (16, 64), (3, 128), (1, 16),
                                  (16, 256)])
def test_cuda_kernel_matches_plain_version(cuda_device, T, Dh, dtype,
                                           q_layout):
    """Kernel vs plain version on the card, with q contiguous, as the
    strided view of a fused QKV output (the serving layout), or in fp32
    over a narrower cache.  fp32: atol 1e-5 (fp32 sums in another
    order).  bf16: `paged.bf16_tolerance` — the kernel keeps the
    probabilities in fp32 while the plain version rounds them to bf16
    before PV, and each side rounds its output once."""
    q, ck, cv, tables, q_pos, bs = _inputs(T, Dh, R=3, H=4, bs=16, W=8)
    t = lambda a: torch.from_numpy(a).to(cuda_device, dtype)
    rows = rows_for_tables(torch.from_numpy(tables).long().to(cuda_device),
                           bs)
    qp = torch.from_numpy(q_pos).to(cuda_device)
    if q_layout == "qkv_view":
        R, _, H, _ = q.shape
        qkv = torch.cat([t(q).reshape(R, T, H * Dh)] * 3, dim=-1)
        qd = qkv[..., :H * Dh].view(R, T, H, Dh)
        assert not qd.is_contiguous()
    elif q_layout == "fp32_q":
        qd = torch.from_numpy(q).to(cuda_device)
    else:
        qd = t(q)
    args = (qd, t(ck), t(cv), rows, qp)
    n = paged.LAUNCHES
    out = registry.dispatch("paged_attention", *args, block_size=bs)
    ref = registry.dispatch("paged_attention", *args, impl="torch",
                            block_size=bs)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == n + 1
    diff = (out.float() - ref.float()).abs()
    tol = (torch.full_like(diff, 1e-5) if dtype == torch.float32 else
           paged.bf16_tolerance(*args, ref))
    assert bool((diff <= tol).all()), float((diff / tol).max())


# -- the build (kernels/build.py), exercised with stand-in compilers ---------


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(0o755)
    return str(path)


def test_build_raises_when_nvcc_is_missing(monkeypatch):
    from deepspeed_tpu_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.kernels import build

    nvcc = _fake_nvcc(tmp_path, 'echo "error: no sm_90a here"; exit 2')
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.build("paged_attention.cu")
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_build_is_keyed_by_the_source_hash(monkeypatch, tmp_path):
    """A library is built once per source hash and reused; the nvcc
    command carries the sm_90a target."""
    from deepspeed_tpu_torch.kernels import build

    log = tmp_path / "calls"
    # the stand-in writes its output file (the argument after -o)
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\n'
                      'while [ "$1" != "-o" ]; do shift; done; touch "$2"')
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    path = build.build("paged_attention.cu")
    assert os.path.basename(path).startswith("paged_attention-")
    assert os.path.exists(path)
    assert build.build("paged_attention.cu") == path  # cached: no recompile
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert path == build.library_path("paged_attention.cu")


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a header in csrc/ (which every source includes)
    renames the library, so the next use rebuilds it."""
    from deepspeed_tpu_torch.kernels import build

    for name in ("paged_attention.cu", "common.cuh"):
        shutil.copy(os.path.join(build.CSRC, name), tmp_path / name)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = build.library_path("paged_attention.cu")
    with open(tmp_path / "common.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("paged_attention.cu") != before
