"""Port parity: checkpointing (deepspeed_tpu_torch/runtime/checkpointing.py,
the engine's save_checkpoint / load_checkpoint) against the JAX package's
encoding, tag layout and engine.

* Encoding: the port writes flax's msgpack bytes without flax; the bytes
  are compared for equality, and flax's bytes decode to equal values.
* Layout: file names, marker keys, meta keys, the sample cursor and the
  model/optimizer trees of a port tag equal those of a JAX tag of the
  same nano engine at ZeRO 0.
* Same-engine resume is bitwise: a fresh port engine that loads the tag
  taken at step 3 runs steps 4-6 with exactly the losses, weights and
  optimizer state of the run that never stopped (dense GPT in fp32,
  bf16 and fp16 after a skipped step, small MoE, small BERT with dropout
  on).
* Cross-engine resume: the engine that loads the other's tag continues on
  the other's curve within tests/test_torch_train.py's tolerances, for
  the same reasons: fp32 per-step loss atol 1e-5 (the same fp32
  arithmetic with sums in another order), bf16 atol 5e-3 (bf16 roundings
  at places that differ between XLA and PyTorch).  A sharded JAX tag's
  pieces reassemble into exactly the JAX engine's arrays.
* The optimizer family and layer drop: LAMB, 1-bit Adam / LAMB past
  the freeze, the client optimizer (optax names, a client
  torch.optim.AdamW) and the PLD theta resume bitwise within the port;
  LAMB, 1-bit Adam and optax:adamw tags cross both engines within the
  fp32 bound above; at world 2 each rank's 1-bit errors are pieces of
  the tag and resume bitwise.
* Integrity, async save and refusals: exact (files, tags, errors).

The tests marked `cuda` hold the pinned-memory async snapshot on the card
(`python -m pytest --noconftest -m cuda tests/test_torch_checkpoint.py`).
"""

import glob
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.models import GPT, Bert, bert_config, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.ops import sparse_attention as tsa  # noqa: E402
from deepspeed_tpu_torch.runtime import checkpointing as ck  # noqa: E402
from deepspeed_tpu_torch.runtime.engine import TORCH_RNG_STATE  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from convergence_common import synthetic_batches  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    import importlib

    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy,
        ser=importlib.import_module("flax.serialization"),
        ds=importlib.import_module("deepspeed_tpu"),
        models=importlib.import_module("deepspeed_tpu.models"))


def _np(x):
    """A decoded leaf as numpy (bf16 tensors as their fp32 values)."""
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- the encoding ----------------------------------------------------------------


def _trees(jnp):
    rs = np.random.RandomState(0)
    return {
        "arrays": {"f32": rs.randn(3, 4).astype(np.float32),
                   "f16": rs.randn(5).astype(np.float16),
                   "bf16": rs.randn(2, 3).astype(jnp.bfloat16),
                   "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "i64": np.arange(4, dtype=np.int64),
                   "b": np.array([True, False]),
                   "empty": np.zeros((0, 2), np.float32),
                   "zero_d": np.asarray(7, np.int32)},
        "scalars": {"np_f32": np.float32(1.5), "np_i64": np.int64(-3),
                    "np_bool": np.bool_(True),
                    "np_bf16": np.array(2.5, jnp.bfloat16)[()],
                    "none": None, "s": "tag", "i": 12, "f": 0.25, "t": True},
        "nested": {"z": [{"w": rs.randn(2).astype(np.float32), "k": None},
                         [np.int32(1), "x", [np.zeros(1, np.float64)]]],
                   "a": {"c": {"b": 1}, "B": [], "_": {}}},
        # every header width: bin/ext 8, 16 and 32, a 16-byte fixext
        # payload, maps and arrays of 16 entries and more
        "sizes": {"big": rs.randn(70000).astype(np.float32),
                  "mid": rs.randn(100).astype(np.float32),
                  "tiny": rs.randn(3).astype(np.float16),
                  "fix16": np.arange(5, dtype=np.uint8),
                  "strided": rs.randn(6, 4).astype(np.float32).T,
                  "many": {f"k{i:02d}": np.float32(i) for i in range(20)},
                  "long": [np.int32(i) for i in range(20)]},
    }


@pytest.mark.parametrize("case", ["arrays", "scalars", "nested", "sizes"])
def test_msgpack_bytes_equal_flax(jx, case):
    tree = _trees(jx.jnp)[case]
    assert ck.msgpack_serialize(tree) == jx.ser.msgpack_serialize(tree)


@pytest.mark.parametrize("case", ["arrays", "scalars", "nested", "sizes"])
def test_flax_bytes_decode_to_the_same_values(jx, case):
    tree = _trees(jx.jnp)[case]
    got = ck.msgpack_restore(jx.ser.msgpack_serialize(tree))
    want = jx.ser.msgpack_restore(jx.ser.msgpack_serialize(tree))
    gf, wf = flatten_tree(got), flatten_tree(want)
    assert set(gf) == set(wf)
    for k, w in wf.items():
        g = gf[k]
        if isinstance(w, (np.ndarray, np.generic)) and \
                np.asarray(w).dtype.name == "bfloat16":
            # decoded into torch.bfloat16 by viewing the bytes
            assert torch.is_tensor(g) and g.dtype == torch.bfloat16, k
            assert np.array_equal(_np(g), np.asarray(w, np.float32)), k
        elif isinstance(w, (np.ndarray, np.generic)):
            assert type(g) is type(w) and g.dtype == w.dtype, k
            assert np.array_equal(g, w), k
        else:
            assert g == w and type(g) is type(w), k


def test_torch_tensors_encode_as_their_arrays(jx):
    rs = np.random.RandomState(1)
    a = rs.randn(3, 5).astype(jx.jnp.bfloat16)
    t = {"bf16": torch.from_numpy(a.view(np.int16)).view(torch.bfloat16),
         "f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "step": torch.tensor(4, dtype=torch.int32),
         "mask": torch.tensor([True, False, True])}
    n = {"bf16": a, "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
         "step": np.asarray(4, np.int32),
         "mask": np.array([True, False, True])}
    assert ck.msgpack_serialize(t) == jx.ser.msgpack_serialize(n)


def test_chunked_arrays_match_flax(jx, monkeypatch):
    """An array above the chunk limit becomes flax's chunked dict (in a
    dict; flax never chunks inside a list): both limits lowered to 64
    bytes."""
    monkeypatch.setattr(jx.ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(2)
    tree = {"w": rs.randn(10, 7).astype(np.float32),
            "deep": {"v": rs.randn(50).astype(jx.jnp.bfloat16)},
            "in_list": [rs.randn(40).astype(np.float32)],
            "small": rs.randn(3).astype(np.float32)}
    blob = jx.ser.msgpack_serialize(tree)
    assert ck.msgpack_serialize(tree) == blob
    assert b"__msgpack_chunked_array__" in blob
    got = ck.msgpack_restore(blob)
    assert np.array_equal(got["w"], tree["w"])
    assert got["deep"]["v"].dtype == torch.bfloat16
    assert np.array_equal(_np(got["deep"]["v"]),
                          np.asarray(tree["deep"]["v"], np.float32))
    assert np.array_equal(got["in_list"][0], tree["in_list"][0])
    # and flax reads the port's chunked bytes back
    back = jx.ser.msgpack_restore(ck.msgpack_serialize(tree))
    assert np.array_equal(back["w"], tree["w"])


# -- engines ---------------------------------------------------------------------


def _cfg(prec="fp32", micro=8, **extra):
    fp = {"fp32": {}, "bf16": {"bf16": {"enabled": True}},
          "fp16": {"fp16": {"enabled": True, "loss_scale": 0,
                            "initial_scale_power": 32, "hysteresis": 1}}}
    return {"train_batch_size": micro,
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 5}},
            **fp[prec], **extra}


def _gpt_data(n=20, seq=16, vocab=64, seed=0):
    toks = np.random.RandomState(seed).randint(0, vocab, (n, seq + 1))
    return [(t[:-1].astype(np.int64), t[1:].astype(np.int64)) for t in toks]


def _bert_data(n=20, seq=64, vocab=128, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (seq,)).astype(np.int64)
        out.append({"input_ids": ids,
                    "token_type_ids": (np.arange(seq) >= seq // 2)
                    .astype(np.int64),
                    "mlm_labels": np.where(rs.rand(seq) < 0.15, ids,
                                           -100).astype(np.int64),
                    "nsp_labels": np.int64(rs.randint(0, 2))})
    return out


def _model(kind, seed):
    gen = torch.Generator().manual_seed(seed)
    if kind == "moe":
        return GPT(gpt2_config("nano", num_layers=2, num_experts=4,
                               moe_top_k=2, vocab_size=64, max_seq_len=16,
                               dropout=0.1), device="cpu", generator=gen)
    if kind == "bert":
        torch.manual_seed(seed)
        return Bert(bert_config(
            "bert-base", num_layers=2, num_heads=2, d_model=64,
            vocab_size=128, max_seq_len=64, attn_dropout=0.1,
            hidden_dropout=0.1,
            sparsity_config=tsa.FixedSparsityConfig(
                num_heads=2, block=16, num_local_blocks=2,
                num_global_blocks=1)), device="cpu")
    return GPT(gpt2_config("nano", num_layers=2, vocab_size=64,
                           max_seq_len=16, dropout=0.1), device="cpu",
               generator=gen)


RESUME_CASES = {"gpt-fp32": ("gpt", "fp32"), "gpt-bf16": ("gpt", "bf16"),
                "gpt-fp16": ("gpt", "fp16"), "moe-fp32": ("moe", "fp32"),
                "bert-fp32": ("bert", "fp32")}


def _port_engine(kind, prec, seed=0, **extra):
    data = _bert_data() if kind == "bert" else _gpt_data()
    eng, _, loader, _ = dt.initialize(model=_model(kind, seed),
                                      config_params=_cfg(prec, **extra),
                                      training_data=data, device="cpu")
    assert loader is eng.training_dataloader and len(loader) == 2
    return eng


def _state(eng):
    opt = {k: [t.clone() for t in v] if isinstance(v, (list, tuple))
           else v.clone() for k, v in eng._opt_state.items()}
    return ({n: p.detach().clone() for n, p in eng.params.items()}, opt,
            {k: v.clone() for k, v in eng._scaler_state.items()})


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_same_engine_resume_is_bitwise(case, tmp_path):
    """Save at step 3 (mid-epoch: the loader holds 2 batches an epoch,
    shuffled per epoch), resume in a fresh engine built from other
    weights, and run steps 4-6 from the engine-owned loader."""
    kind, prec = RESUME_CASES[case]
    eng = _port_engine(kind, prec)
    ref = [float(eng.train_batch()) for _ in range(3)]
    if prec == "fp16":
        # the scaler state after skipped steps is what goes into the tag
        assert eng.skipped_steps >= 1 and eng.loss_scale < 2.0 ** 32
    skipped = eng.skipped_steps
    eng.save_checkpoint(str(tmp_path), client_state={"note": "mid-run"})
    assert os.path.isdir(tmp_path / "global_step3")
    ref += [float(eng.train_batch()) for _ in range(3)]
    want = _state(eng)

    fresh = _port_engine(kind, prec, seed=7)
    ckpt_dir, client = fresh.load_checkpoint(str(tmp_path))
    assert ckpt_dir == str(tmp_path / "global_step3")
    assert client["note"] == "mid-run" and client["global_steps"] == 3
    assert fresh.global_steps == 3 and fresh.skipped_steps == skipped
    got = [float(fresh.train_batch()) for _ in range(3)]
    assert got == ref[3:], (got, ref[3:])
    assert all(_same(a, b) for a, b in zip(_state(fresh), want))
    assert fresh.global_steps == eng.global_steps == 6
    assert fresh.skipped_steps == eng.skipped_steps
    assert fresh.get_lr() == eng.get_lr()


# -- the tag layout against the JAX engine ----------------------------------------


def _engine_pair(jx, prec="fp32", training_data=None, zero_stage=0,
                 init_seed=1234):
    """The JAX nano engine over the harness's 8 CPU devices (micro 8 each)
    and the port's single process at the same global micro batch of 64,
    from one JAX init (tests/test_torch_train.py's setup)."""
    jcfg = jx.models.gpt2_config("nano", max_seq_len=32, vocab_size=64,
                                 shard_activations=False)
    jmodel = jx.models.GPT(jcfg)
    tree = jx.jax.tree_util.tree_map(
        np.asarray, jmodel.init(jx.jax.random.PRNGKey(init_seed)))
    jc = _cfg(prec, micro=64 // jx.jax.device_count(),
              zero_optimization={"stage": zero_stage})
    jc["train_batch_size"] = 64
    je, *_ = jx.ds.initialize(model=jmodel, model_parameters=tree,
                              config_params=jc, training_data=training_data)
    te, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                  device="cpu"),
        model_parameters=tree, config_params=_cfg(prec, micro=64),
        training_data=training_data, device="cpu")
    return je, te


def _step(eng, batch):
    loss = float(eng.forward(batch))
    eng.backward()
    eng.step()
    return loss


def _tree_sig(tree):
    """{leaf name: (shape, dtype name)} (the decoder gives torch tensors
    for bf16 only)."""
    return {k: (tuple(np.shape(v)), "bfloat16" if torch.is_tensor(v)
                else np.asarray(v).dtype.name)
            for k, v in flatten_tree(tree).items()}


def test_tag_layout_matches_the_jax_engine(jx, tmp_path):
    data = [(x[i], y[i]) for x, y in synthetic_batches(2, 64, 32, 64, 5)
            for i in range(64)]
    je, te = _engine_pair(jx, training_data=data)
    je.train_batch()
    te.train_batch()
    je.save_checkpoint(str(tmp_path / "jax"), tag="step1")
    te.save_checkpoint(str(tmp_path / "port"), tag="step1")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == \
        ["latest", "step1"]
    assert sorted(os.listdir(jdir / "step1")) == \
        sorted(os.listdir(tdir / "step1")) == [
            ".ckpt_commit.json", "mp_rank_00_model_states.msgpack",
            "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"]
    assert (jdir / "latest").read_text() == (tdir / "latest").read_text()
    jm, tm = ck.read_tag_meta(str(jdir), "step1"), \
        ck.read_tag_meta(str(tdir), "step1")
    assert set(jm) == set(tm) == {"schema_version", "tag", "committed_unix",
                                  "world_size", "nbytes_rank0", "meta"}
    assert set(jm["meta"]) == set(tm["meta"])
    assert jm["meta"]["sample_cursor"] == tm["meta"]["sample_cursor"]
    assert jm["meta"]["zero_stage"] == tm["meta"]["zero_stage"] == 0
    assert tm["nbytes_rank0"] == sum(
        os.path.getsize(p) for p in glob.glob(str(tdir / "step1" / "*.msgpack")))

    def read(d, f):
        with open(d / "step1" / f, "rb") as fh:
            return ck.msgpack_restore(fh.read())

    jms = read(jdir, "mp_rank_00_model_states.msgpack")
    tms = read(tdir, "mp_rank_00_model_states.msgpack")
    assert set(jms) == set(tms) - {TORCH_RNG_STATE}
    assert _tree_sig(jms["module"]) == _tree_sig(tms["module"])
    assert _tree_sig(jms["loss_scaler"]) == _tree_sig(tms["loss_scaler"])
    assert jms["lr_scheduler"] == tms["lr_scheduler"]
    jos = read(jdir, "zero_pp_rank_0_mp_rank_00_optim_states.msgpack")
    tos = read(tdir, "zero_pp_rank_0_mp_rank_00_optim_states.msgpack")
    assert set(jos) == set(tos) == {"__dstpu_ckpt_v2__", "pieces", "state"}
    assert set(jos["state"]) == set(tos["state"])
    assert _tree_sig(jos["state"]["optimizer_state"]) == \
        _tree_sig(tos["state"]["optimizer_state"])
    assert jos["state"]["optimizer_hparams"] == \
        tos["state"]["optimizer_hparams"]


# -- cross-engine resume -------------------------------------------------------------


@pytest.mark.parametrize("prec,tol", [("fp32", 1e-5), ("bf16", 5e-3)])
def test_jax_tag_restores_into_the_port(jx, prec, tol, tmp_path):
    """The JAX engine trains 3 steps, saves and goes on; a fresh port
    engine loads the tag and follows the JAX engine's steps 4-6.  The
    port's next tag carries the JAX PRNG key through unchanged."""
    je, te = _engine_pair(jx, prec)
    batches = list(synthetic_batches(6, 64, 32, 64, 1234))
    for b in batches[:3]:
        _step(je, b)
    je.save_checkpoint(str(tmp_path / "jax"))
    want = [_step(je, b) for b in batches[3:]]
    te.load_checkpoint(str(tmp_path / "jax"))
    assert te.global_steps == 3 and te.loaded_checkpoint_tag == "global_step3"
    got = [_step(te, b) for b in batches[3:]]
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert te.global_steps == je.global_steps == 6
    te.save_checkpoint(str(tmp_path / "port"))
    with open(tmp_path / "jax" / "global_step3" /
              "mp_rank_00_model_states.msgpack", "rb") as f:
        jkey = ck.msgpack_restore(f.read())["rng_key"]
    with open(tmp_path / "port" / "global_step6" /
              "mp_rank_00_model_states.msgpack", "rb") as f:
        tkey = ck.msgpack_restore(f.read())["rng_key"]
    assert jkey.dtype == tkey.dtype and np.array_equal(jkey, tkey)


@pytest.mark.parametrize("prec,tol", [("fp32", 1e-5), ("bf16", 5e-3)])
def test_port_tag_restores_into_the_jax_engine(jx, prec, tol, tmp_path):
    je, te = _engine_pair(jx, prec)
    batches = list(synthetic_batches(6, 64, 32, 64, 4321))
    for b in batches[:3]:
        _step(te, b)
    te.save_checkpoint(str(tmp_path))
    want = [_step(te, b) for b in batches[3:]]
    ckpt_dir, client = je.load_checkpoint(str(tmp_path))
    assert ckpt_dir is not None and je.global_steps == 3
    got = [_step(je, b) for b in batches[3:]]
    np.testing.assert_allclose(want, got, atol=tol, rtol=0)
    if prec == "fp32":
        jp = flatten_tree(jx.jax.tree_util.tree_map(np.asarray, je.params))
        for n, v in te.module_state_dict().items():
            np.testing.assert_allclose(v, jp[n], atol=1e-4, rtol=0,
                                       err_msg=n)


def test_sharded_jax_tag_reassembles_in_the_port(jx, tmp_path):
    """A ZeRO-1 JAX tag at dp 8 keeps its optimizer moments as pieces in
    per-device rank files (the v2 layout); the port puts them back
    together into exactly the JAX engine's arrays."""
    je, te = _engine_pair(jx, zero_stage=1)
    for b in synthetic_batches(2, 64, 32, 64, 9):
        _step(je, b)
    je.save_checkpoint(str(tmp_path), tag="z1")
    assert len(glob.glob(str(tmp_path / "z1" / "zero_pp_rank_*"))) > 1
    te.load_checkpoint(str(tmp_path), tag="z1")
    jp = flatten_tree(jx.jax.tree_util.tree_map(np.asarray, je.params))
    for n, v in te.module_state_dict().items():
        assert np.array_equal(v, jp[n]), n
    jo = jx.jax.tree_util.tree_map(np.asarray, je._opt_state)
    for key in ("exp_avg", "exp_avg_sq"):
        flat = flatten_tree(jo[key])
        for n, t in zip(te._param_names, te._opt_state[key]):
            assert np.array_equal(t.numpy(), flat[n]), (key, n)
    assert int(te._opt_state["step"]) == int(jo["step"]) == 2


# -- integrity -------------------------------------------------------------------


def _tiny_engine(**extra):
    eng, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", num_layers=1, vocab_size=64,
                              max_seq_len=16), device="cpu"),
        config_params=_cfg(**extra), training_data=_gpt_data(), device="cpu")
    return eng


def test_interrupted_save_is_invisible_and_skipped_back(tmp_path,
                                                        monkeypatch):
    eng = _tiny_engine()
    eng.train_batch()
    eng.save_checkpoint(str(tmp_path), tag="A")
    eng.train_batch()
    with monkeypatch.context() as m:
        m.setattr(ck, "_commit", lambda *a, **k: None)   # writer dies
        eng.save_checkpoint(str(tmp_path), tag="B")
    assert (tmp_path / "B" / "mp_rank_00_model_states.msgpack").exists()
    assert not ck.is_tag_committed(str(tmp_path), "B")
    assert (tmp_path / "latest").read_text() == "A"
    assert ck.read_latest_tag(str(tmp_path)) == "A"
    # a `latest` that names the uncommitted tag skips back to A
    (tmp_path / "latest").write_text("B")
    snap = COUNTERS.snapshot()
    assert ck.read_latest_tag(str(tmp_path)) == "A"
    assert COUNTERS.delta_since(snap)["ckpt.skipped_tags"]["calls"] == 1
    fresh = _tiny_engine()
    ckpt_dir, _ = fresh.load_checkpoint(str(tmp_path))
    assert ckpt_dir == str(tmp_path / "A") and fresh.global_steps == 1
    with pytest.raises(ck.CheckpointIntegrityError, match="no commit marker"):
        fresh.load_checkpoint(str(tmp_path), tag="B")
    # a committed tag with a file missing is incomplete, not "nothing"
    os.remove(tmp_path / "A" / "mp_rank_00_model_states.msgpack")
    with pytest.raises(ck.CheckpointIntegrityError, match="incomplete"):
        fresh.load_checkpoint(str(tmp_path), tag="A")


def test_nothing_to_resume_from_and_refused_tags(tmp_path):
    eng = _tiny_engine()
    assert eng.load_checkpoint(str(tmp_path / "none")) == (None, {})
    assert eng.load_checkpoint(str(tmp_path), tag="missing") == (None, {})
    assert eng.global_steps == 0
    eng.train_batch()
    eng.save_checkpoint(str(tmp_path), tag="S")
    # ZeRO-Infinity stream groups load now: a stray group file beside a
    # tag without stream markers is not read ...
    open(tmp_path / "S" / "stream_group_g0.msgpack", "wb").close()
    assert eng.load_checkpoint(str(tmp_path), tag="S")[0] is not None
    # ... and a streamed tag missing a group file is incomplete
    inf, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", num_layers=1, vocab_size=64,
                              max_seq_len=16), device="cpu"),
        config_params=_cfg(zero_optimization={
            "stage": 3, "offload_param": {
                "device": "nvme", "nvme_path": str(tmp_path / "nvme")}}),
        device="cpu")
    inf.save_checkpoint(str(tmp_path), tag="T")
    os.remove(tmp_path / "T" / "stream_group_block_0.msgpack")
    with pytest.raises(ck.CheckpointIntegrityError,
                       match="stream_group_block_0"):
        eng.load_checkpoint(str(tmp_path), tag="T")


def test_tag_validation_and_checkpoint_config():
    eng = _tiny_engine(checkpoint={"tag_validation": "fail"})
    with pytest.raises(ValueError, match="whitespace"):
        eng.save_checkpoint("unused", tag="a tag")
    with pytest.raises(ValueError, match="commit_timeout_ms"):
        _tiny_engine(checkpoint={"commit_timeout_ms": 0})
    assert _tiny_engine()._config.checkpoint_async_save is False


def test_async_save_equals_a_sync_save_and_ignores_later_steps(tmp_path):
    """The async tag is byte-equal to a sync tag of a twin engine at the
    same step, although the async engine trains on while it is written;
    a load from the directory waits for the writer."""
    a = _tiny_engine(checkpoint={"async_save": True})
    s = _tiny_engine()
    for _ in range(2):
        a.train_batch()
        s.train_batch()
    snap = COUNTERS.snapshot()
    a.save_checkpoint(str(tmp_path / "async"), tag="t")
    for _ in range(2):
        a.train_batch()
    s.save_checkpoint(str(tmp_path / "sync"), tag="t")
    fresh = _tiny_engine()
    fresh.load_checkpoint(str(tmp_path / "async"))   # flushes first
    assert fresh.global_steps == 2
    d = COUNTERS.delta_since(snap)
    assert d["ckpt.stall_ms"]["calls"] == 2 and d["ckpt.bytes"]["calls"] == 2
    for f in ("mp_rank_00_model_states.msgpack",
              "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"):
        assert (tmp_path / "async" / "t" / f).read_bytes() == \
            (tmp_path / "sync" / "t" / f).read_bytes(), f
    a.finalize_monitoring()
    assert ck.pending_count() == 0


def test_atomic_write_retries_a_transient_fault_only(tmp_path, monkeypatch):
    """EIO on the rename retries with a fresh tmp file and lands the file
    whole; ENOSPC re-raises at once; no tmp file is left behind."""
    import errno

    real = os.replace
    faults = [OSError(errno.EIO, "storage hiccup")]

    def flaky(src, dst):
        if faults:
            raise faults.pop()
        real(src, dst)

    monkeypatch.setattr(ck.os, "replace", flaky)
    snap = COUNTERS.snapshot()
    assert ck._atomic_write(str(tmp_path / "f"), b"payload") == 7
    assert (tmp_path / "f").read_bytes() == b"payload"
    assert COUNTERS.delta_since(snap)["fault.retried"]["calls"] == 1
    faults.append(OSError(errno.ENOSPC, "disk full"))
    with pytest.raises(OSError, match="disk full"):
        ck._atomic_write(str(tmp_path / "g"), b"x")
    assert sorted(os.listdir(tmp_path)) == ["f"]


def test_async_saves_commit_in_call_order(tmp_path):
    """Six async saves of one directory in flight at once, with a short
    thread switch interval: every tag commits, and `latest` names the
    last one saved."""
    eng = _tiny_engine(checkpoint={"async_save": True})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i in range(6):
            eng.train_batch()
            eng.save_checkpoint(str(tmp_path), tag=f"t{i}")
        ck.flush_pending(str(tmp_path))
    finally:
        sys.setswitchinterval(old)
    assert ck.pending_count() == 0
    assert ck.committed_tags(str(tmp_path)) == [f"t{i}" for i in range(6)]
    assert (tmp_path / "latest").read_text() == "t5"
    fresh = _tiny_engine()
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.global_steps == 6


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_checkpoint.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_async_snapshot_right_after_a_step_equals_a_sync_save(
        cuda_device, tmp_path):
    """The pinned snapshot is taken on a side stream while the next steps
    are already enqueued: its tag equals a sync tag of a twin engine, and
    the async engine's later steps equal the twin's (the wait before the
    in-place update changes no result)."""
    def engine(**extra):
        model = GPT(gpt2_config("nano", num_layers=2, vocab_size=64,
                                max_seq_len=16, dropout=0.1),
                    device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(0))
        eng, *_ = dt.initialize(model=model, config_params=_cfg(**extra),
                                training_data=_gpt_data(),
                                device=cuda_device)
        return eng

    a, s = engine(checkpoint={"async_save": True}), engine()
    la = [float(a.train_batch()) for _ in range(2)]
    ls = [float(s.train_batch()) for _ in range(2)]
    a.save_checkpoint(str(tmp_path / "async"), tag="t")
    la += [a.train_batch() for _ in range(3)]
    s.save_checkpoint(str(tmp_path / "sync"), tag="t")
    ls += [float(s.train_batch()) for _ in range(3)]
    a.finalize_monitoring()
    assert [float(x) for x in la] == ls
    for f in ("mp_rank_00_model_states.msgpack",
              "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"):
        assert (tmp_path / "async" / "t" / f).read_bytes() == \
            (tmp_path / "sync" / "t" / f).read_bytes(), f


# -- ZeRO-1/2 tags across world sizes ---------------------------------------------


def test_world2_zero2_tags_in_pieces_and_across_world_sizes(jx, tmp_path):
    """A world-2 ZeRO-2 port tag holds its Adam moments as two
    `zero_pp_rank_*` pieces files in JAX's format; the JAX engine reads
    it at dp 8, and the port's single process resumes it, each going on
    with the same sample stream (the cursor counts global batches) and
    the loss curve of the world-2 run; the port reads the JAX engine's
    dp-8 ZeRO-2 tag at world 2.  Tolerances: cross-engine fp32 1e-5 a
    step (above); the port across world sizes 1e-6 relative
    (tests/test_torch_dp.py's fp32 wire bound)."""
    from test_torch_dp import spawn_world

    data = [(x[i].astype(np.int64), y[i].astype(np.int64))
            for x, y in synthetic_batches(8, 64, 32, 64, 11)
            for i in range(64)]
    je, _ = _engine_pair(jx, training_data=data, zero_stage=2)
    tree = flatten_tree(jx.jax.tree_util.tree_map(np.asarray, je.params))
    tree = {k: np.array(v) for k, v in tree.items()}
    for _ in range(2):
        je.train_batch()
    je.save_checkpoint(str(tmp_path / "jax"), tag="jz2")
    want_j = [float(je.train_batch()) for _ in range(2)]
    assert len(glob.glob(str(tmp_path / "jax" / "jz2" /
                             "zero_pp_rank_*"))) == 8

    w2 = _cfg(micro=32, train_batch_size=64,
              zero_optimization={"stage": 2},
              comm={"gradient_reduction": "bucketed",
                    "reduce_bucket_size": 5000})
    jobs = {"save": {"run": "resume", "cfg": w2, "tree": tree, "data": data,
                     "steps": 6, "save_at": 3,
                     "save": (str(tmp_path / "port"), "w2")},
            "load-jax": {"run": "resume", "cfg": w2, "tree": tree,
                         "data": data, "steps": 2,
                         "load": (str(tmp_path / "jax"), "jz2")}}
    ranks = spawn_world(2, jobs, tmp_path)
    for res in ranks:
        np.testing.assert_allclose(res["load-jax"]["losses"], want_j,
                                   atol=1e-5, rtol=0)
    stream = ranks[0]["save"]["losses"]
    assert ranks[1]["save"]["losses"] == stream

    # the tag: two piece files, rank 0's holding the state with markers
    tag = tmp_path / "port" / "w2"
    files = sorted(os.path.basename(p) for p in
                   glob.glob(str(tag / "zero_pp_rank_*")))
    assert files == ["zero_pp_rank_0_mp_rank_00_optim_states.msgpack",
                     "zero_pp_rank_1_mp_rank_00_optim_states.msgpack"]
    with open(tag / files[1], "rb") as f:
        r1 = ck.msgpack_restore(f.read())
    assert set(r1) == {"__dstpu_ckpt_v2__", "pieces"} and r1["pieces"]
    meta = ck.read_tag_meta(str(tmp_path / "port"), "w2")
    assert (meta["world_size"], meta["meta"]["dp_world_size"],
            meta["meta"]["zero_stage"],
            meta["meta"]["sample_cursor"]["position"]) == (2, 2, 2, 3)

    # the JAX engine reads it at dp 8 and follows the stream
    je2, _ = _engine_pair(jx, training_data=data, zero_stage=2)
    je2.load_checkpoint(str(tmp_path / "port"), tag="w2")
    _, _, optim = ck.load_checkpoint_state(str(tmp_path / "port"), "w2")
    jo = flatten_tree(jx.jax.tree_util.tree_map(
        np.asarray, je2._opt_state["exp_avg"]))
    po = flatten_tree(optim["optimizer_state"]["exp_avg"])
    assert set(jo) == set(po)
    for n in jo:
        assert np.array_equal(jo[n], np.asarray(po[n])), n
    got_j = [float(je2.train_batch()) for _ in range(3)]
    np.testing.assert_allclose(got_j, stream[3:], atol=1e-5, rtol=0)

    # the port's single process resumes it on the same stream
    te = dt.initialize(model=GPT(gpt2_config("nano", max_seq_len=32,
                                             vocab_size=64), device="cpu"),
                       model_parameters=tree, training_data=data,
                       config_params=_cfg(micro=64,
                                          zero_optimization={"stage": 2}),
                       device="cpu")[0]
    te.load_checkpoint(str(tmp_path / "port"), tag="w2")
    assert te.global_steps == 3
    got = [float(te.train_batch()) for _ in range(3)]
    np.testing.assert_allclose(got, stream[3:], rtol=1e-6, atol=0)
    for n, v in te.module_state_dict().items():
        np.testing.assert_allclose(v, ranks[0]["save"]["masters"][n],
                                   atol=1e-5, rtol=0, err_msg=n)


# -- the optimizer family, progressive layer drop ----------------------------------

OPT_FAMILY = {
    "lamb": {"type": "Lamb", "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "onebit-adam": {"type": "OneBitAdam",
                    "params": {"lr": 3e-3, "freeze_step": 2}},
    "onebit-lamb-int8": {"type": "OneBitLamb",
                         "params": {"lr": 3e-3, "freeze_step": 2,
                                    "wire": "int8"}},
    "optax-adamw": {"type": "optax:adamw", "params": {"lr": 3e-3}},
    "optax-sgd": {"type": "optax:sgd", "params": {"lr": 3e-2,
                                                  "momentum": 0.9}},
}


def _family_engine(case, seed=0, pld=False):
    extra = {}
    if pld:
        extra["progressive_layer_drop"] = {"enabled": True, "theta": 0.5,
                                           "gamma": 0.2}
    model = _model("gpt", seed)
    client = None
    if case == "client-adamw":
        client = torch.optim.AdamW(model.parameters(), lr=3e-3,
                                   weight_decay=0.05)
    else:
        extra["optimizer"] = OPT_FAMILY[case]
    eng, *_ = dt.initialize(model=model, optimizer=client,
                            config_params=_cfg("fp32", **extra),
                            training_data=_gpt_data(), device="cpu")
    return eng


@pytest.mark.parametrize("case,pld", [(c, False) for c in OPT_FAMILY] +
                         [("client-adamw", False), ("lamb", True)])
def test_optimizer_family_and_pld_resume_is_bitwise(case, pld, tmp_path):
    """LAMB, 1-bit Adam / LAMB past the freeze (their worker and server
    errors), the client-optimizer state (optax names and a client
    torch.optim.AdamW) and the layer-drop theta: save at step 3, resume
    in a fresh engine from other weights, steps 4-6 bitwise (under
    deterministic algorithms: the embedding backward's row sums)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _family_resume(case, pld, tmp_path)
    finally:
        torch.use_deterministic_algorithms(prev)


def _family_resume(case, pld, tmp_path):
    eng = _family_engine(case, pld=pld)
    ref = [float(eng.train_batch()) for _ in range(3)]
    theta = eng.get_pld_theta()
    eng.save_checkpoint(str(tmp_path))
    ref += [float(eng.train_batch()) for _ in range(3)]
    want = _state(eng)
    fresh = _family_engine(case, seed=7, pld=pld)
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.get_pld_theta() == theta
    if pld:
        assert theta < 1.0
    got = [float(fresh.train_batch()) for _ in range(3)]
    assert got == ref[3:], (got, ref[3:])
    assert all(_same(a, b) for a, b in zip(_state(fresh), want))
    if case.startswith("onebit"):
        assert float(want[1]["worker_error"][0].abs().max()) > 0


@pytest.mark.parametrize("case", ["lamb", "onebit-adam", "optax-adamw"])
def test_optimizer_family_tags_cross_both_engines(jx, case, tmp_path):
    """A JAX tag of each optimizer restores into the port, and a port tag
    into the JAX engine, each going on with the other's curve (fp32 1e-5
    a step, as above).  1-bit runs stay before the freeze here: the JAX
    engine's dp-8 compressed path and the port's world 1 compress
    different (local against averaged) momenta after it.  (1-bit LAMB's
    per-leaf scalars take the same tree layout; its JAX engine compiles
    for a minute, so it is held to the port's own resume above.)"""
    opt = dict(OPT_FAMILY[case])
    if case.startswith("onebit"):
        opt["params"] = dict(opt["params"], freeze_step=100)
    batches = list(synthetic_batches(6, 64, 32, 64, 99))
    jmodel = jx.models.GPT(jx.models.gpt2_config(
        "nano", max_seq_len=32, vocab_size=64, shard_activations=False))
    tree = jx.jax.tree_util.tree_map(
        np.asarray, jmodel.init(jx.jax.random.PRNGKey(1234)))
    jc = _cfg(micro=64 // jx.jax.device_count(), optimizer=opt,
              gradient_clipping=0.0)
    jc["train_batch_size"] = 64
    je, *_ = jx.ds.initialize(model=jmodel, model_parameters=tree,
                              config_params=jc)

    def port():
        return dt.initialize(
            model=GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                      device="cpu"), model_parameters=tree,
            config_params=_cfg(micro=64, optimizer=opt,
                               gradient_clipping=0.0), device="cpu")[0]

    # JAX saves at 3 and goes on; a fresh port engine follows from the tag
    for b in batches[:3]:
        _step(je, b)
    je.save_checkpoint(str(tmp_path / "jax"))
    want = [_step(je, b) for b in batches[3:]]
    te = port()
    te.load_checkpoint(str(tmp_path / "jax"))
    assert te.global_steps == 3
    got = [_step(te, b) for b in batches[3:]]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a fresh port run saves at 3; the JAX engine resumes from its tag
    te = port()
    for b in batches[:3]:
        _step(te, b)
    te.save_checkpoint(str(tmp_path / "port"))
    want = [_step(te, b) for b in batches[3:]]
    je.load_checkpoint(str(tmp_path / "port"))
    assert je.global_steps == 3
    got = [_step(je, b) for b in batches[3:]]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_world2_onebit_rank_errors_resume_bitwise(tmp_path):
    """1-bit Adam on the compressed path at world 2: each rank's worker
    and server errors go into the tag as pieces ([dp, *leaf], a row a
    rank), and fresh ranks that load it continue bitwise."""
    from test_torch_dp import spawn_world

    jmodel_tree = flatten_tree({n: p.detach().numpy().copy() for n, p in
                                GPT(gpt2_config("nano", vocab_size=64,
                                                max_seq_len=32),
                                    device="cpu").named_parameters()})
    tree = {k: np.array(v) for k, v in jmodel_tree.items()}
    data = [(x[i].astype(np.int64), y[i].astype(np.int64))
            for x, y in synthetic_batches(6, 16, 32, 64, 3)
            for i in range(16)]
    cfg = _cfg(micro=8, train_batch_size=16, gradient_clipping=0.0,
               optimizer={"type": "OneBitAdam",
                          "params": {"lr": 3e-3, "freeze_step": 2}})
    d = (str(tmp_path / "ob"), "ob4")
    jobs = {"save": {"run": "resume", "cfg": cfg, "tree": tree,
                     "data": data, "steps": 6, "save_at": 4, "save": d},
            "load": {"run": "resume", "cfg": cfg, "tree": tree,
                     "data": data, "steps": 2, "load": d}}
    ranks = spawn_world(2, jobs, tmp_path)
    for res in ranks:
        assert res["load"]["losses"] == res["save"]["losses"][4:]
        for n, v in res["save"]["masters"].items():
            assert np.array_equal(res["load"]["masters"][n], v), n
    _, _, optim = ck.load_checkpoint_state(*d)
    rows = flatten_tree(optim["onebit_rank_errors"]["worker_error"])
    assert all(np.shape(v)[0] == 2 for v in rows.values())
    w = rows["wte"]
    assert not np.array_equal(np.asarray(w[0]), np.asarray(w[1]))
