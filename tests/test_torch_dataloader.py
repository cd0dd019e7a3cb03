"""Port parity: the data loader and the engine-owned input pipeline
(deepspeed_tpu_torch/runtime/dataloader.py, bs_schedules.py, the
engine's `training_data`, `train_batch()` and `_DeviceFeed`) against the
JAX package on the same numpy datasets.

* Batches: byte-equal to the JAX package's DeepSpeedDataLoader (the same
  numpy shuffle, `RandomState(seed + epoch)`), over epochs through
  RepeatingLoader, with and without PrefetchLoader, and after a sample
  cursor written by the JAX loader is restored into the port's.
* The engine-owned `train_batch()`: the JAX engine's curve within
  tests/test_torch_train.py's fp32 tolerance (per-step loss atol 1e-5:
  the same fp32 arithmetic, sums in another order), and the same losses,
  bitwise, with the input pipeline on and off.
* BatchSizeScheduler and the data_pipeline config: equal to JAX's.

The `cuda` test holds the pinned, side-stream `_DeviceFeed` against the
plain placement on the card (`python -m pytest --noconftest -m cuda
tests/test_torch_dataloader.py`).
"""

import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.runtime import dataloader as tdl  # noqa: E402
from deepspeed_tpu_torch.runtime.bs_schedules import \
    BatchSizeScheduler  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402
from deepspeed_tpu_torch.runtime.engine import _DeviceFeed, _place  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from convergence_common import synthetic_batches  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import importlib

    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(
        jax=jax,
        dl=importlib.import_module("deepspeed_tpu.runtime.dataloader"),
        bs=importlib.import_module("deepspeed_tpu.runtime.bs_schedules"),
        cfg=importlib.import_module("deepspeed_tpu.runtime.config"),
        ds=importlib.import_module("deepspeed_tpu"),
        models=importlib.import_module("deepspeed_tpu.models"))


def _dataset(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randint(0, 50, (5,)).astype(np.int32),
             "y": (rs.rand(3).astype(np.float32), np.int64(i))}
            for i in range(n)]


def _flat(batch):
    if isinstance(batch, dict):
        return [a for k in sorted(batch) for a in _flat(batch[k])]
    if isinstance(batch, (list, tuple)):
        return [a for v in batch for a in _flat(v)]
    return [np.asarray(batch)]


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(fa, fb))


def _loaders(pkg, **kw):
    return pkg.DeepSpeedDataLoader(_dataset(), batch_size=4, shuffle=True,
                                   seed=3, data_parallel_world_size=1,
                                   data_parallel_rank=0, **kw)


@pytest.mark.parametrize("workers", [None, 1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_equal_jax_over_epochs(jx, workers, drop_last):
    """Two and a half epochs through RepeatingLoader (the shuffle is
    redrawn each epoch), the port's loader optionally under
    PrefetchLoader with 1 or 3 collate workers."""
    jl = _loaders(jx.dl, drop_last=drop_last)
    tl = _loaders(tdl, drop_last=drop_last)
    assert len(jl) == len(tl) == (5 if drop_last else 6)
    src = tl if workers is None else tdl.PrefetchLoader(
        tl, prefetch_depth=2, num_workers=workers)
    jit, tit = jx.dl.RepeatingLoader(jl), tdl.RepeatingLoader(src)
    n = len(tl) * 5 // 2
    for i in range(n):
        assert _equal(next(tit), next(jit)), i
    if workers is not None:
        src.close()


def test_sample_cursor_from_jax_restores_the_next_batch(jx):
    """The JAX loader's cursor after 7 consumed batches (epoch 1,
    batch 2) restores the port's loader to the JAX loader's next
    batch, and the cursors agree from then on."""
    jl, tl = _loaders(jx.dl), _loaders(tdl)
    jit = jx.dl.RepeatingLoader(jl)
    for _ in range(7):
        next(jit)
    jl.record_consumed(7)
    cursor = jl.sample_cursor()
    assert cursor["epoch"] == 1 and cursor["position"] == 2
    tl.load_sample_cursor(dict(cursor))
    tit = tdl.RepeatingLoader(tdl.PrefetchLoader(tl, num_workers=2))
    for i in range(8):
        assert _equal(next(tit), next(jit)), i
    tl.record_consumed(8)
    jl.record_consumed(8)
    assert tl.sample_cursor() == jl.sample_cursor()
    with pytest.raises(ValueError, match="malformed"):
        tl.load_sample_cursor({"epoch": "x"})


def test_prefetch_worker_respawns_at_the_batch_it_died_on(jx):
    """A collate that fails once: the worker is respawned at that batch
    and the stream is unchanged; a dataset that always fails re-raises
    after the respawn budget."""
    class Flaky(list):
        failed = False

        def __getitem__(self, i):
            if i == 9 and not Flaky.failed:
                Flaky.failed = True
                raise OSError("transient read error")
            return list.__getitem__(self, i)

    want = list(_loaders(tdl))
    loader = tdl.DeepSpeedDataLoader(Flaky(_dataset()), batch_size=4,
                                     shuffle=True, seed=3)
    snap = COUNTERS.snapshot()
    got = list(tdl.PrefetchLoader(loader, num_workers=2,
                                  respawn_backoff_s=0.0))
    assert Flaky.failed
    assert COUNTERS.delta_since(snap)["input.worker_respawns"]["calls"] == 1
    assert len(got) == len(want) and all(map(_equal, got, want))

    class Broken(list):
        def __getitem__(self, i):
            raise KeyError(i)

    bad = tdl.PrefetchLoader(tdl.DeepSpeedDataLoader(Broken(_dataset()), 4),
                             respawn_backoff_s=0.0)
    with pytest.raises(KeyError):
        list(bad)


def test_timed_next_counts_the_host_wait():
    snap = COUNTERS.snapshot()
    it = iter([1, 2])
    assert tdl.timed_next(it) == 1 and tdl.timed_next(it) == 2
    assert COUNTERS.delta_since(snap)["input.host_wait_ms"]["calls"] == 2
    with pytest.raises(StopIteration):
        tdl.timed_next(it)


@pytest.mark.parametrize("args", [(64, 0.01, 100, 4), (48, 0.25, 10, 3),
                                  (8, 0.5, 5, 5)])
def test_batch_size_scheduler_matches_jax(jx, args):
    js, ts = jx.bs.BatchSizeScheduler(*args), BatchSizeScheduler(*args)
    assert ts.schedule == js.schedule
    for _ in range(args[2] + 3):
        js.step()
        ts.step()
        assert ts.current_batch_size == js.current_batch_size
    assert ts.state_dict() == js.state_dict()
    fresh = BatchSizeScheduler(*args)
    fresh.load_state_dict(js.state_dict())
    assert fresh.get_current_batch_size() == js.get_current_batch_size()


@pytest.mark.parametrize("section,match", [
    ({"bogus": 1}, "unknown key"),
    ({"prefetch_depth": -1}, "prefetch_depth"),
    ({"num_workers": 0}, "num_workers"),
    ({"num_workers": True}, "num_workers"),
])
def test_data_pipeline_config_errors_match_jax(jx, section, match):
    base = {"train_batch_size": 8, "data_pipeline": section}
    with pytest.raises(ValueError, match=match):
        jx.cfg.DeepSpeedConfig(dict(base))
    with pytest.raises(ValueError, match=match):
        DeepSpeedConfig(dict(base))


def test_data_pipeline_config_defaults_match_jax(jx):
    for section in ({}, {"enabled": False}, {"prefetch_depth": 0},
                    {"device_prefetch": False, "num_workers": 3}):
        pd = {"train_batch_size": 8, "data_pipeline": section}
        j = jx.cfg.DeepSpeedConfig(dict(pd)).data_pipeline_config
        t = DeepSpeedConfig(dict(pd)).data_pipeline_config
        for k in ("enabled", "prefetch_depth", "num_workers",
                  "device_prefetch", "host_prefetch", "device_feed"):
            assert getattr(t, k) == getattr(j, k), (section, k)


# -- the engine-owned loader --------------------------------------------------------


def _token_dataset(n=160, seed=77):
    return [(x[i], y[i]) for x, y in synthetic_batches(n // 16, 16, 32, 64,
                                                       seed)
            for i in range(16)]


def _engine_cfg(micro, **extra):
    return {"train_batch_size": 64, "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "zero_optimization": {"stage": 0}, "steps_per_print": 0,
            "gradient_clipping": 1.0, **extra}


def test_engine_train_batch_from_training_data_follows_jax(jx):
    """initialize(training_data=...) then train_batch() with no iterator:
    the JAX engine (8 devices, micro 8 each) and the port (micro 64) draw
    the same shuffled global batches and follow one curve over 5 steps,
    crossing an epoch (2 batches an epoch)."""
    cfg = jx.models.gpt2_config("nano", max_seq_len=32, vocab_size=64,
                                shard_activations=False)
    jmodel = jx.models.GPT(cfg)
    tree = jx.jax.tree_util.tree_map(
        np.asarray, jmodel.init(jx.jax.random.PRNGKey(5)))
    data = _token_dataset()
    je, _, jloader, _ = jx.ds.initialize(
        model=jmodel, model_parameters=tree, training_data=data,
        config_params=_engine_cfg(64 // jx.jax.device_count()))
    te, _, tloader, _ = dt.initialize(
        model=GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                  device="cpu"),
        model_parameters=tree, training_data=data,
        config_params=_engine_cfg(64), device="cpu")
    assert len(jloader) == len(tloader) == 2
    losses = np.asarray([[float(je.train_batch()), float(te.train_batch())]
                         for _ in range(5)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], atol=1e-5, rtol=0)
    assert tloader.sample_cursor() == jloader.sample_cursor()
    assert tloader.sample_cursor()["epoch"] == 2
    te.finalize_monitoring()
    je.finalize_monitoring()


def test_engine_losses_are_the_same_with_the_pipeline_off():
    def run(section):
        eng, *_ = dt.initialize(
            model=GPT(gpt2_config("nano", num_layers=1, max_seq_len=32,
                                  vocab_size=64), device="cpu"),
            training_data=_token_dataset(64), device="cpu",
            config_params=_engine_cfg(
                16, train_batch_size=32, gradient_accumulation_steps=2,
                data_pipeline=section))
        out = [float(eng.train_batch()) for _ in range(3)]
        # gas 2 a step: 6 batches of the 4 an epoch were consumed
        cursor = eng.training_dataloader.sample_cursor()
        assert (cursor["epoch"], cursor["position"]) == (1, 2)
        eng.finalize_monitoring()
        return out

    on = run({})
    assert run({"enabled": False}) == on
    assert run({"prefetch_depth": 0}) == on
    assert run({"num_workers": 3, "device_prefetch": False}) == on


def test_train_batch_without_an_iterator_or_training_data_raises():
    eng, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", num_layers=1), device="cpu"),
        config_params={"train_batch_size": 2}, device="cpu")
    with pytest.raises(ValueError, match="training_data"):
        eng.train_batch()


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_dataloader.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_device_feed_equals_the_plain_placement(cuda_device):
    """Batches copied from pinned memory on the feed's side stream, while
    work is queued on the compute stream, equal the plain placement."""
    host = [{"ids": np.random.RandomState(i).randint(0, 50257, (8, 1024)),
             "y": (np.random.RandomState(i).rand(8, 7).astype(np.float32),)}
            for i in range(6)]
    it = iter(host)
    feed = _DeviceFeed(it, lambda: next(it), cuda_device)
    busy = torch.randn(2048, 2048, device=cuda_device)
    got = []
    for _ in range(len(host)):
        b = feed.next()
        busy = busy @ busy / 2048.0          # keep the compute stream busy
        feed.schedule()
        got.append({"ids": b["ids"].clone(), "y": (b["y"][0].clone(),)})
    assert feed._stream is not None
    torch.cuda.synchronize()
    for g, h in zip(got, host):
        w = _place(h, cuda_device)
        assert torch.equal(g["ids"], w["ids"])
        assert torch.equal(g["y"][0], w["y"][0])
