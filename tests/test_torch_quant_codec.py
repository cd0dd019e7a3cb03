"""Port parity: the blockwise int8/int4 codec
(deepspeed_tpu_torch/runtime/comm/quant.py, kernels #11 and #12) against
the JAX package's `quantize_blockwise_ref` / `dequantize_blockwise_ref`
and its Pallas codec, which JAX runs in interpret mode on the CPU
through `registry.dispatch(..., impl="pallas")` under
`kernel_config(interpret=True)`, as tests/test_kernels.py does.

The same numpy inputs go to both packages.  The contract is bitwise:
payload bytes, fp16 scale bits, and dequantized values (NaN at the same
places), at fp32 and bf16 input, int8 and int4, blocks 2 and 256, over
the edge cases the codec's range rules name: fp32 subnormals (flushed),
±inf and NaN (the marker), an all-zero block, a block whose amax is above
qmax·65504 (its fp16 scale overflows: it dequantizes non-finite), one
below qmax·2^-24 (its scale underflows: zeros), exact .5 ties (round half
to even) and a ragged tail block.

The kernels run only on a card: the `cuda`-marked tests at the end hold
them bitwise against the plain versions there, on both of the quantize
kernel's routes (`python -m pytest --noconftest -m cuda
tests/test_torch_quant_codec.py`); the route rule itself is tested here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import quant_codec, registry  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import quant  # noqa: E402

torch.set_num_threads(1)


def edge_cases(n=1000, seed=3):
    """fp32 [n]: scaled normals with every edge case of the codec."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(n) * 10.0).astype(np.float32)
    x[5], x[77], x[400] = np.inf, -np.inf, np.nan
    x[6] = 1e-40                                  # fp32 subnormal
    x[7] = -3e-39
    x[512:768] = 0.0                              # an all-zero block (256)
    x[768] = 127 * 65504 * 2.0                    # scale overflows fp16
    x[256:512] *= 1e-9                            # scale underflows fp16
    x[300] = 1.5e-7
    x[0] = 127.0       # block 0's amax: scale 1, so .5 codes are ties
    x[20:40] = np.arange(-10, 10) + 0.5           # ties: half to even
    return x


def _jax_codec(x_np, dtype, block, wire):
    """(payload, scales, dequantized) of the JAX oracle and of its Pallas
    codec in interpret mode."""
    import jax.numpy as jnp

    from deepspeed_tpu.kernels import kernel_config
    from deepspeed_tpu.kernels import registry as jregistry
    from deepspeed_tpu.runtime.comm.quant import (dequantize_blockwise_ref,
                                                  quantize_blockwise_ref)

    x = jnp.asarray(x_np)
    if dtype == torch.bfloat16:
        x = x.astype(jnp.bfloat16)
    out = {}
    p, s = quantize_blockwise_ref(x, block, wire)
    out["ref"] = (np.asarray(p), np.asarray(s),
                  np.asarray(dequantize_blockwise_ref(p, s, wire, x.size)))
    with kernel_config(interpret=True):
        pk, sk = jregistry.dispatch("quant_codec", x, block, wire,
                                    variant="quantize", impl="pallas")
        yk = jregistry.dispatch("quant_codec", pk, sk, wire, x.size,
                                variant="dequantize", impl="pallas")
    out["pallas"] = (np.asarray(pk), np.asarray(sk), np.asarray(yk))
    return out


@pytest.mark.parametrize("block", [2, 256])
@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_is_bitwise_with_the_jax_oracle_and_pallas_codec(dtype, wire,
                                                               block):
    x_np = edge_cases()
    x = torch.from_numpy(x_np).to(dtype)
    p, s = quant.quantize_blockwise(x, block, wire)
    y = quant.dequantize_blockwise(p, s, wire, x.numel())
    assert p.dtype == (torch.int8 if wire == "int8" else torch.uint8)
    assert s.dtype == torch.float16 and y.dtype == torch.float32
    for side, (jp, js, jy) in _jax_codec(x_np, dtype, block, wire).items():
        assert np.array_equal(p.numpy().view(np.uint8),
                              jp.view(np.uint8)), side
        assert np.array_equal(s.numpy().view(np.uint16),
                              js.view(np.uint16)), side
        assert np.array_equal(y.numpy(), jy, equal_nan=True), side
    # the edge cases took their paths: markers, an inf scale, a zero scale
    assert bool(torch.isnan(y[[5, 77, 400]]).all())
    assert y[6] == 0 and bool(torch.isinf(s.float()).any())
    assert bool((s[(512 // block):(768 // block)] == 0).all())


def test_dequantize_keeps_leading_batch_dims_and_rounds_to_the_leaf_dtype():
    """A gathered [world, nb, w] payload comes back [world, n]; an
    out_dtype is the fp32 result rounded once (the JAX program's
    `.astype(dtype)` after its dequantize)."""
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.comm.quant import dequantize_blockwise_ref

    x = torch.from_numpy(edge_cases())
    for wire in ("int8", "int4"):
        p, s = quant.quantize_blockwise_ref(x, 128, wire)
        pw, sw = torch.stack([p, p.flip(0)]), torch.stack([s, s.flip(0)])
        y = quant.dequantize_blockwise_ref(pw, sw, wire, 1000)
        jy = np.asarray(dequantize_blockwise_ref(
            jnp.asarray(pw.numpy()), jnp.asarray(sw.numpy()), wire, 1000))
        assert y.shape == (2, 1000)
        assert np.array_equal(y.numpy(), jy, equal_nan=True)
        yb = quant.dequantize_blockwise_ref(pw, sw, wire, 1000,
                                            out_dtype=torch.bfloat16)
        jb = np.asarray(jnp.asarray(jy).astype(jnp.bfloat16).astype(
            jnp.float32))
        assert np.array_equal(yb.float().numpy(), jb, equal_nan=True)


def test_block_size_rules_and_byte_counts_match_jax():
    from deepspeed_tpu.runtime.comm import quant as jquant

    for bad in (0, 3, -2, 2.0, True):
        with pytest.raises(ValueError, match="positive even int"):
            quant.validate_block_size(bad)
    for n, wire, block, padded in ((1000, "int8", 256, True),
                                   (1000, "int4", 256, False),
                                   (7, "int4", 2, True), (0, "int8", 4, False)):
        assert quant.payload_bytes(n, wire, block, padded=padded) == \
            jquant.payload_bytes(n, wire, block, padded=padded)
        assert quant.padded_elems(n, block) == jquant.padded_elems(n, block)


def test_cpu_tensors_take_the_plain_versions():
    x = torch.from_numpy(edge_cases())
    snap = COUNTERS.snapshot()
    n0 = dict(quant_codec.LAUNCHES)
    p, s = quant.quantize_blockwise(x, 256, "int8")
    quant.dequantize_blockwise(p, s, "int8", 1000)
    assert COUNTERS.delta_since(snap)["kernel.fallbacks"]["calls"] == 2
    assert quant_codec.LAUNCHES == n0
    with pytest.raises(RuntimeError, match="only on a CUDA device"):
        registry.dispatch("quant_codec_quantize", x, 256, "int8",
                          impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        quant_codec.quantize_blockwise_cuda(x, 256, "int8")
    with pytest.raises(ValueError, match="not a CUDA device"):
        quant_codec.quantize_route(x, 256)


# blocks the card tests run, with the quantize route each takes on a
# 16-byte-aligned input: "vector" where block / 8 is a power of two up to
# 32 or a multiple of 32 (768 and 4096 take its two-pass kernel)
ROUTE_BLOCKS = {2: "generic", 8: "vector", 16: "vector", 64: "vector",
                100: "generic", 256: "vector", 512: "vector",
                768: "vector", 2048: "vector", 4096: "vector"}


@pytest.mark.parametrize("block", sorted(ROUTE_BLOCKS))
def test_quantize_route_is_a_function_of_block_dtype_and_alignment(block):
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert quant_codec.route_of(block, dtype, 4096) == \
            ROUTE_BLOCKS[block]
        # an input that starts off a 16-byte boundary (a view offset by
        # an element) takes the generic route at every block
        assert quant_codec.route_of(block, dtype, 4096 + 2) == "generic"
        assert quant_codec.route_of(block, dtype, 4096 + 8) == "generic"
    # block / 8 neither a power of two up to 32 nor a multiple of 32
    assert quant_codec.route_of(block * 3, torch.float32, 0) == (
        "vector" if block * 3 % 256 == 0 else "generic")
    with pytest.raises(ValueError, match="dtype"):
        quant_codec.route_of(block, torch.int8, 0)


# -- the kernels on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_quant_codec.py)")
    return torch.device("cuda")


def same_bits(a, b):
    """Bitwise equality, NaN compared by position (its payload bits are
    the producer's choice)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        a, b = a.masked_fill(na, 0), b.masked_fill(nb, 0)
        iview = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(iview), b.view(iview))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("block", sorted(ROUTE_BLOCKS))
@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_kernels_are_bitwise_with_the_plain_versions(cuda_device, dtype,
                                                          wire, block):
    """Every route: the edge cases (4000 elements: a ragged last block at
    blocks 64, 256, 512, 768, 2048 and 4096), 3 x 257 x 129 random
    elements (no multiple of the block, nor of 8), and the edge cases as
    a view offset by one element (the generic route)."""
    g = torch.Generator().manual_seed(1)
    buf = torch.from_numpy(edge_cases(4097)).to(dtype).to(cuda_device)
    xs = [(buf[:4000], ROUTE_BLOCKS[block]),
          (torch.randn(3, 257, 129, generator=g).to(dtype).to(cuda_device),
           ROUTE_BLOCKS[block]),
          (buf[1:], "generic")]
    for t, route in xs:
        assert quant_codec.quantize_route(t, block) == route
        n0 = dict(quant_codec.LAUNCHES)
        r0 = dict(quant_codec.LAUNCHES_BY_ROUTE)
        pk, sk = registry.dispatch("quant_codec_quantize", t, block, wire,
                                   impl="cuda")
        pp, sp = registry.dispatch("quant_codec_quantize", t, block, wire,
                                   impl="torch")
        assert same_bits(pk, pp) and same_bits(sk, sp)
        for out_dtype in (torch.float32, torch.bfloat16, t.dtype):
            yk = registry.dispatch("quant_codec_dequantize", pp, sp, wire,
                                   t.numel(), impl="cuda",
                                   out_dtype=out_dtype)
            yp = registry.dispatch("quant_codec_dequantize", pp, sp, wire,
                                   t.numel(), impl="torch",
                                   out_dtype=out_dtype)
            assert same_bits(yk, yp), out_dtype
        # leading batch dims: rows of a gathered payload
        yk = registry.dispatch("quant_codec_dequantize", pp[None].repeat(
            2, 1, 1), sp[None].repeat(2, 1), wire, t.numel(), impl="cuda")
        assert same_bits(yk[1], registry.dispatch(
            "quant_codec_dequantize", pp, sp, wire, t.numel(), impl="torch"))
        torch.cuda.synchronize()
        assert quant_codec.LAUNCHES["quant_codec_quantize"] == \
            n0["quant_codec_quantize"] + 1
        assert quant_codec.LAUNCHES_BY_ROUTE[route] == r0[route] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("block", [256, 64, 2048])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_cuda_vector_quantize_is_bitwise_repeatable(cuda_device, wire,
                                                    block):
    """The vector route 50 times on the same bf16 input (2^20 + 100
    elements, a ragged tail): the same payload and scales every time."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((1 << 20) + 100, generator=g, device=cuda_device).to(
        torch.bfloat16) * 30
    assert quant_codec.quantize_route(x, block) == "vector"
    p0, s0 = quant_codec.quantize_blockwise_cuda(x, block, wire)
    for _ in range(50):
        p, s = quant_codec.quantize_blockwise_cuda(x, block, wire)
        assert torch.equal(p, p0) and same_bits(s, s0)
