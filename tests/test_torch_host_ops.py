"""The port's host-native ops (deepspeed_tpu_torch/ops/op_builder,
ops/adam/cpu_adam.py, ops/aio) against the JAX package's on the same
inputs.  Both build the same C++ sources with the same flags, so the
host Adam is held to JAX's bit for bit, and to a plain torch Adam within
fp32 rounding (rtol 1e-5, atol 1e-6 after five steps on parameters of
order 1: torch applies the bias corrections and the decay in another
order, a few ulps of each parameter, 1e-6 being about 8 ulps at 1.0).  The aio
engines are held to byte equality of what they read and write."""

import ctypes
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu.ops.adam.cpu_adam import HostAdam as JaxHostAdam  # noqa: E402
from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxAIO  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.adam import HostAdam  # noqa: E402
from deepspeed_tpu_torch.ops.aio import (AsyncIOHandle, aio_read,  # noqa: E402
                                         aio_write, alloc_aligned,
                                         uring_supported)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("src", ["adam/cpu_adam.cpp", "aio/ds_aio.cpp"])
def test_host_op_sources_are_the_jax_packages_byte_for_byte(src):
    with open(os.path.join(REPO, "csrc", src), "rb") as f:
        jax_src = f.read()
    with open(os.path.join(op_builder.builder.CSRC, src), "rb") as f:
        assert f.read() == jax_src


def _draws(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("adam_w,wd,bf16", [
    (True, 0.0, False), (True, 0.1, False), (False, 0.1, False),
    (True, 0.1, True), (False, 0.0, True)])
def test_host_adam_is_bitwise_jax(adam_w, wd, bf16):
    shapes = [(33, 17), (1001,)]
    params = _draws(0, shapes)
    mine = [p.ravel().copy() for p in params]
    theirs = [p.ravel().copy() for p in params]
    ta = HostAdam(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
    ja = JaxHostAdam(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
    for step in range(5):
        grads = [g.ravel() for g in _draws(10 + step, shapes)]
        ta.begin_step()
        ja.begin_step()
        for i, (p, q, g) in enumerate(zip(mine, theirs, grads)):
            lr = 1e-2 * (step + 1) / 5
            if bf16:
                out_t = torch.empty(p.size, dtype=torch.bfloat16)
                out_j = np.empty(p.size, np.uint16)
                # a CPU tensor buffer on the port's side, by data_ptr
                pt = torch.from_numpy(p)
                ta.update_flat(i, pt, torch.from_numpy(g.copy()), lr=lr,
                               out_bf16=out_t)
                ja.update_flat(i, q, g.copy(), lr=lr, out_bf16=out_j)
                assert np.array_equal(out_t.view(torch.int16).numpy()
                                      .view(np.uint16), out_j)
                # the wire is the RNE cast of the new masters
                assert torch.equal(out_t, pt.to(torch.bfloat16))
            else:
                ta.update_flat(i, p, g.copy(), lr=lr)
                ja.update_flat(i, q, g.copy(), lr=lr)
            assert np.array_equal(p.view(np.int32), q.view(np.int32))
    ts, js = ta.state_dict(), ja.state_dict()
    assert ts["step"] == js["step"] == 5 and set(ts["state"]) == {"0", "1"}
    for k in js["state"]:
        for m in ("m", "v"):
            assert np.array_equal(ts["state"][k][m], js["state"][k][m])
    fresh = HostAdam()
    fresh.load_state_dict(ts)
    assert fresh.step_count == 5 and \
        np.array_equal(fresh._state[1]["v"], ts["state"]["1"]["v"])


@pytest.mark.parametrize("adam_w,wd", [(True, 0.0), (True, 0.1),
                                       (False, 0.1)])
def test_host_adam_tracks_plain_torch_adam(adam_w, wd):
    shapes = [(40, 30), (7,)]
    params = _draws(1, shapes)
    host = [p.ravel().copy() for p in params]
    ref = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    cls = torch.optim.AdamW if adam_w else torch.optim.Adam
    opt = cls(ref, lr=1e-2, weight_decay=wd, eps=1e-8)
    ha = HostAdam(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
    for step in range(5):
        grads = _draws(20 + step, shapes)
        ha.begin_step()
        for i, (p, g) in enumerate(zip(host, grads)):
            ha.update_flat(i, p, g.ravel().copy())
        for t, g in zip(ref, grads):
            t.grad = torch.from_numpy(g)
        opt.step()
    for p, t in zip(host, ref):
        np.testing.assert_allclose(p, t.detach().numpy().ravel(),
                                   rtol=1e-5, atol=1e-6)


def test_host_adam_refuses_bad_buffers():
    ha = HostAdam()
    ha.begin_step()
    with pytest.raises(ValueError, match="float32"):
        ha.update_flat(0, np.zeros(4, np.float64), np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="gradients"):
        ha.update_flat(0, np.zeros(4, np.float32), np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="contiguous"):
        ha.update_flat(0, torch.zeros(4, 2).t(), torch.zeros(8))


def test_builder_raises_without_a_compiler_and_on_a_failed_build(
        tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="not found"):
        op_builder.builder.find_cxx()
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")

    class Bad(op_builder.OpBuilder):
        NAME = "bad"

        def sources(self):
            return [str(bad)]       # absolute: os.path.join keeps it

    monkeypatch.setattr(op_builder.builder, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="build failed(.|\n)*error"):
        Bad().build()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_library_name_carries_the_host_target(monkeypatch):
    b = op_builder.CPUAdamBuilder()
    cxx = op_builder.builder.find_cxx()
    here = b.lib_path(cxx)
    assert os.path.dirname(here) == op_builder.builder.BUILD_DIR
    assert "-march=" in op_builder.builder.host_target(cxx)
    monkeypatch.setitem(op_builder.builder._HOST_TARGET, cxx,
                        "another host's -march=native")
    assert b.lib_path(cxx) != here


def test_omp_threads_are_set_through_the_ops_runtime():
    op_builder.set_omp_threads(2)
    gomp = ctypes.CDLL("libgomp.so.1")
    assert gomp.omp_get_max_threads() == 2
    op_builder.set_omp_threads(torch.get_num_threads())


def _engines():
    kinds = ["threads"] + (["uring"] if uring_supported() else [])
    return kinds


@pytest.mark.parametrize("engine", _engines())
def test_aio_round_trip_offsets_and_chunks_against_jax(tmp_path, engine):
    h = AsyncIOHandle(n_threads=3, block_size=4096, engine=engine)
    assert h.engine == engine
    rng = np.random.RandomState(2)
    data = rng.randint(0, 255, 3 * 4096 + 123).astype(np.uint8)
    path = str(tmp_path / "f.bin")
    # written in pieces at offsets (one a CPU tensor), read whole by JAX
    h.async_pwrite(data[:5000].copy(), path, 0)
    h.async_pwrite(torch.from_numpy(data[5000:].copy()), path, 5000)
    h.wait()
    got = np.empty_like(data)
    JaxAIO(engine=engine).sync_pread(got, path)
    assert np.array_equal(got, data)
    # written by JAX, read back in chunks at offsets by the port
    path2 = str(tmp_path / "g.bin")
    JaxAIO(engine=engine).sync_pwrite(data, path2)
    out = alloc_aligned(data.size)
    assert out.ctypes.data % 4096 == 0
    for off in range(0, data.size, 4096):
        h.async_pread(out[off:off + 4096], path2, off)
    h.wait()
    assert np.array_equal(out, data)
    aio_write(data, path)
    back = np.zeros_like(data)
    aio_read(back, path)
    assert np.array_equal(back, data)
    h.close()


def test_aio_missing_file_and_bad_engine_raise(tmp_path):
    h = AsyncIOHandle(engine="threads")
    buf = np.empty(16, np.uint8)
    h.async_pread(buf, str(tmp_path / "missing.bin"))
    with pytest.raises(IOError, match="failed"):
        h.wait()
    with pytest.raises(ValueError, match="unknown aio engine"):
        AsyncIOHandle(engine="bogus")
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pwrite(np.zeros((4, 4))[:, 0], str(tmp_path / "x"))
