"""Checkpoint save/load in the JAX package's tag layout and encoding —
the single-process port of deepspeed_tpu/runtime/checkpointing.py.

Layout (checkpointing.py:1-52), file for file the JAX engine's:

    <save_dir>/<tag>/mp_rank_00_model_states.msgpack
    <save_dir>/<tag>/zero_pp_rank_0_mp_rank_00_optim_states.msgpack
    <save_dir>/<tag>/.ckpt_commit.json    (commit marker)
    <save_dir>/latest                     (text file holding the tag)

Encoding: flax's msgpack format (flax/serialization.py:249-390), written
with plain `msgpack` because the port imports neither flax nor JAX:
arrays (numpy or torch) are ExtType 1 holding
`packb((shape, dtype name, C-order bytes))`, numpy scalars ExtType 3,
dict keys in sorted order (what flax's `jax.tree_util` copy of the tree
gives it), and an array above `MAX_CHUNK_SIZE` bytes (2^30) a
`__msgpack_chunked_array__` dict of flat pieces.  bf16 travels under the
name "bfloat16" and is decoded into a `torch.bfloat16` tensor by viewing
its bytes (numpy has no bfloat16 without ml_dtypes); every other dtype
decodes into a numpy array.  Either engine reads the other's tags.

Crash consistency (two-phase commit): every file lands as tmp + fsync +
rename (`_atomic_write`), and a tag is COMMITTED only when its
`.ckpt_commit.json` lands, after all its files; `latest` is rewritten
after the marker.  `read_latest_tag` skips an uncommitted tag back to the
newest committed one.  Over several ranks the commit waits on
`CommitBarrier` (checkpointing.py:207), a rendezvous over the process
group's key-value store: every rank posts a done-key once its files have
landed, rank 0 waits for all of them, publishes the marker and `latest`,
and releases the others; at one rank the barrier is a direct call.  "Nothing to resume from" raises FileNotFoundError; a tag
that exists but is uncommitted or incomplete raises
CheckpointIntegrityError.

Async saves: `async_save=True` returns once the caller's host snapshot
is taken; serialize + write + commit run on a background pool, commits
chained per directory in save-call order.  `flush_pending()` blocks on
them; a re-save of a tag and any load from the directory flush first.
Counters: `ckpt.stall_ms` (µs of blocked training per save, in the bytes
slot), `ckpt.bytes` (bytes per committed tag), `ckpt.pending` (writer
queue depth sampled per save), `ckpt.skipped_tags`.

Pieces: the optimizer file is the v2 layout (`__dstpu_ckpt_v2__`,
`pieces`, `state`).  A sharded leaf (ZeRO 1-3) is a marker in the state
(`shard_marker`: its key, shape, dtype and piece count) and its pieces
(`index` + `piece`) lie in the `zero_pp_rank_<r>` files, one a rank that
owns a distinct piece (checkpointing.py:334-420); load puts the pieces
back together into whole arrays, whatever world wrote them.  Tags with
pipeline layer files raise NotImplementedError naming their ROADMAP item.

ZeRO-Infinity (checkpointing.py:424-490): a tag of NVMe-paged masters
holds one `stream_group_<group>.msgpack` file a stream group, and its
model and optimizer files hold string markers (`stream_marker`) in their
place; `load_checkpoint_state` resolves them into arrays unless asked
not to (a paged engine reads the group files one at a time).
"""

from __future__ import annotations

import datetime
import glob
import hashlib
import io
import itertools
import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import msgpack
import numpy as np
import torch

from ..monitor.counters import COUNTERS
from ..utils.logging import logger
from .resilience import (active_plan, fault_filter, fault_point,
                         retry_transient)

_SHARD_MARKER = "__dstpu_sharded_leaf__"


def shard_key(prefix: str, path) -> str:
    """A sharded leaf's key: `prefix` + `jax.tree_util.keystr` of its
    path (list indices as [i], dict keys as ['k'])."""
    return prefix + "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                            for p in path)


def shard_marker(key: str, shape, dtype: str, num_pieces: int) -> dict:
    """The state's stand-in for a sharded leaf (`_split_sharded`)."""
    return {_SHARD_MARKER: True, "key": key, "shape": [int(n) for n in shape],
            "dtype": dtype, "num_pieces": int(num_pieces)}
_V2_MARKER = "__dstpu_ckpt_v2__"
_STREAM_PREFIX = "__dstpu_stream__:"
COMMIT_MARKER = ".ckpt_commit.json"
COMMIT_SCHEMA_VERSION = 1


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint tag exists but is incomplete, uncommitted, or
    corrupt.  Distinct from FileNotFoundError ("nothing to resume
    from"): training from scratch over a damaged checkpoint would lose
    the run, so engines let this propagate."""


# ---------------------------------------------------------------------------
# flax's msgpack encoding (flax/serialization.py:249-390)
# ---------------------------------------------------------------------------

# msgpack's limit is 2^31 - 1 bytes an object; flax chunks above 2^30
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

_TORCH_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or torch.is_tensor(x)


def _nbytes(x) -> int:
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + n.to_bytes(1, "big")
    if n < 1 << 16:
        return b"\xc5" + n.to_bytes(2, "big")
    return b"\xc6" + n.to_bytes(4, "big")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes([fixed[n], code])
    if n < 1 << 8:
        return bytes([0xc7, n, code])
    if n < 1 << 16:
        return b"\xc8" + n.to_bytes(2, "big") + bytes([code])
    return b"\xc9" + n.to_bytes(4, "big") + bytes([code])


def _container_header(n: int, fix: int, b16: bytes, b32: bytes) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < 1 << 16:
        return b16 + n.to_bytes(2, "big")
    return b32 + n.to_bytes(4, "big")


def _array_parts(x):
    """An array's ExtType payload as (packed prefix, memoryview of its
    C-order bytes): `packb((shape, dtype name, bytes))` without copying
    the bytes.  A CUDA tensor is copied to the host here."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_DTYPE_NAMES:
            raise ValueError(f"cannot serialize a {t.dtype} tensor")
        shape = tuple(int(s) for s in t.shape)
        name = _TORCH_DTYPE_NAMES[t.dtype]
        data = t.reshape(-1).view(torch.uint8).numpy()
    else:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name = x.shape, x.dtype.name
        data = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    prefix = (b"\x93" + msgpack.packb(shape) + msgpack.packb(name)
              + _bin_header(data.nbytes))
    return prefix, memoryview(data)


def _array_to_bytes(x) -> bytes:
    """(shape, dtype name, C-order bytes), msgpack-packed."""
    prefix, data = _array_parts(x)
    return prefix + data.tobytes()


def _array_from_bytes(data: bytes):
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        # viewed from its bytes: no ml_dtypes needed
        flat = (torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
                if buf else torch.empty(0, dtype=torch.bfloat16))
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext_pack(x):
    if _is_array(x):
        return msgpack.ExtType(_EXT_NDARRAY, _array_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_to_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    return x


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        a = _array_from_bytes(data)
        return a if torch.is_tensor(a) else a[()]
    return msgpack.ExtType(code, data)


def _canonical(tree):
    """The copy flax's `jax.tree_util.tree_map(lambda x: x, tree)` makes:
    the same nesting, every dict's keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_canonical(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_canonical(v) for v in tree)
    return tree


def _chunk(arr) -> Dict[str, Any]:
    itemsize = arr.element_size() if torch.is_tensor(arr) else \
        arr.dtype.itemsize
    size = arr.numel() if torch.is_tensor(arr) else arr.size
    n = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + n]
                       for j, i in enumerate(range(0, size, n))}}


def _chunk_leaves(d):
    """flax's `_chunk_array_leaves_in_place`: dicts only (an array in a
    list is never chunked)."""
    if isinstance(d, dict):
        for k, v in d.items():
            if _is_array(v):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _is_array(d) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _unchunk(data):
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    if torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def _emit(write, x) -> int:
    """Write flax's encoding of the canonical tree `x` piece by piece:
    container headers, then each leaf; an array's bytes go to `write` as
    a view of its own memory, so a file write copies them once, without
    holding the interpreter lock."""
    if type(x) is dict:
        n = write(_container_header(len(x), 0x80, b"\xde", b"\xdf"))
        for k, v in x.items():
            n += write(msgpack.packb(k, strict_types=True))
            n += _emit(write, v)
        return n
    if type(x) is list:
        n = write(_container_header(len(x), 0x90, b"\xdc", b"\xdd"))
        return n + sum(_emit(write, v) for v in x)
    if _is_array(x):
        prefix, data = _array_parts(x)
        return (write(_ext_header(_EXT_NDARRAY, len(prefix) + data.nbytes))
                + write(prefix) + write(data))
    return write(msgpack.packb(x, default=_ext_pack, strict_types=True))


def write_tree(write, tree) -> int:
    """`msgpack_serialize(tree)` into `write` (a file's write); returns
    the bytes written."""
    return _emit(write, _chunk_leaves(_canonical(tree)))


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize, byte for byte: nested dicts,
    lists, None, str, Python scalars, numpy arrays and scalars, and torch
    tensors (encoded as arrays of their dtype)."""
    buf = io.BytesIO()
    write_tree(buf.write, tree)
    return buf.getvalue()


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore, with bf16 as torch tensors."""
    return _unchunk_leaves(
        msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False))


# ---------------------------------------------------------------------------
# background writer + per-(dir, tag) pending bookkeeping (:86-148)
# ---------------------------------------------------------------------------

_writer = ThreadPoolExecutor(max_workers=4)
_pending_lock = threading.Lock()
_pending: Dict[Tuple[str, str], List[Future]] = {}
# last commit-bearing future per save_dir: async commits chain on it so
# `latest` lands in save-call order with several tags in flight
_dir_chain: Dict[str, Future] = {}
# saves per (save_dir, tag): the commit barrier's key round
_tag_seq: Dict[Tuple[str, str], int] = {}


def _pending_key(save_dir: str, tag) -> Tuple[str, str]:
    return (os.path.realpath(save_dir), str(tag))


def pending_count() -> int:
    """Async checkpoint jobs not yet finished (writer-queue depth)."""
    with _pending_lock:
        return sum(1 for fs in _pending.values() for f in fs
                   if not f.done())


def flush_pending(save_dir: Optional[str] = None, tag=None) -> None:
    """Block until async checkpoint writes have landed and committed:
    all of them, or those of `save_dir` (and `tag`).  Re-raises the first
    failure after waiting for every job."""
    with _pending_lock:
        if save_dir is None:
            keys = list(_pending)
        else:
            root = os.path.realpath(save_dir)
            keys = [k for k in _pending
                    if k[0] == root and (tag is None or k[1] == str(tag))]
        grabbed = [_pending.pop(k) for k in keys]
    errs = []
    for futures in grabbed:
        for f in futures:
            try:
                f.result()
            except Exception as e:  # surface the FIRST failure, flush all
                errs.append(e)
    if errs:
        raise errs[0]


# ---------------------------------------------------------------------------
# atomic file plumbing (:150-204)
# ---------------------------------------------------------------------------


def _fsync_dir(path: str) -> None:
    """fsync a directory so a completed rename is durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_TMP_SEQ = itertools.count()


def _atomic_write(path: str, blob) -> int:
    """tmp + fsync + rename: readers never observe a torn file.  `blob` is
    bytes or a function that writes the content into the open file and
    returns its length.  The tmp name carries the pid and a process-local
    sequence number, so two background commits of one target never share
    a tmp file; transient storage faults retry, each attempt with a fresh
    tmp file.

    Chaos sites (checkpointing.py:179-199): `ckpt.atomic_write.payload`
    filters the bytes once before the retried op (a `corrupt` rule
    truncates them, the torn write the commit marker and the integrity
    errors exist to catch) and `ckpt.atomic_write` fires inside each
    attempt.  A streamed payload is first written into memory only when a
    rule of the installed plan targets the payload site, so the filter
    sees the bytes; otherwise it streams, as without a plan."""
    plan = active_plan()
    if callable(blob) and plan is not None and \
            plan.targets("ckpt.atomic_write.payload"):
        buf = io.BytesIO()
        blob(buf)
        blob = buf.getvalue()
    if not callable(blob):
        blob = fault_filter("ckpt.atomic_write.payload", blob)

    def op() -> int:
        fault_point("ckpt.atomic_write")
        tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
        try:
            with open(tmp, "wb") as f:
                n = blob(f) if callable(blob) else f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n

    return retry_transient(op, site=f"ckpt.atomic_write {path}")


# ---------------------------------------------------------------------------
# file naming
# ---------------------------------------------------------------------------


def model_ckpt_name(ckpt_dir: str, mp_rank: int = 0) -> str:
    return os.path.join(ckpt_dir,
                        f"mp_rank_{mp_rank:02d}_model_states.msgpack")


def optim_ckpt_name(ckpt_dir: str, dp_rank: int = 0, mp_rank: int = 0) -> str:
    return os.path.join(
        ckpt_dir,
        f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}_optim_states.msgpack")


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what}: not ported to deepspeed_tpu_torch yet (ROADMAP queue 1: "
        f"{item})")


# ---------------------------------------------------------------------------
# commit markers / tag state (:540-640)
# ---------------------------------------------------------------------------


def commit_marker_path(load_dir: str, tag) -> str:
    return os.path.join(load_dir, str(tag), COMMIT_MARKER)


def is_tag_committed(load_dir: str, tag) -> bool:
    return os.path.isfile(commit_marker_path(load_dir, tag))


def read_tag_meta(load_dir: str, tag) -> Optional[Dict[str, Any]]:
    """The commit marker's payload, or None for an uncommitted tag."""
    path = commit_marker_path(load_dir, tag)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        logger.warning(f"unreadable commit marker {path}: {e}")
        return None


def _partition_tags(load_dir: str) -> Tuple[List[str], List[str]]:
    """(committed tags oldest -> newest commit time, uncommitted tag
    dirs sorted by name), from one scan."""
    committed, uncommitted = [], []
    try:
        entries = os.listdir(load_dir)
    except OSError:
        return [], []
    for name in entries:
        if not os.path.isdir(os.path.join(load_dir, name)):
            continue
        marker = read_tag_meta(load_dir, name)
        if marker is not None:
            committed.append((float(marker.get("committed_unix", 0.0)),
                              name))
        else:
            uncommitted.append(name)
    return [name for _, name in sorted(committed)], sorted(uncommitted)


def committed_tags(load_dir: str) -> List[str]:
    return _partition_tags(load_dir)[0]


def _dir_has_markers(load_dir: str) -> bool:
    try:
        return any(os.path.isfile(os.path.join(load_dir, d, COMMIT_MARKER))
                   for d in os.listdir(load_dir))
    except OSError:
        return False


def write_commit_marker(save_dir: str, tag,
                        meta: Optional[Dict[str, Any]] = None,
                        world_size: int = 1, nbytes: int = 0) -> None:
    """Publish the commit marker for `tag` (JAX's schema and keys)."""
    marker = {
        "schema_version": COMMIT_SCHEMA_VERSION,
        "tag": str(tag),
        "committed_unix": time.time(),
        "world_size": int(world_size),
        "nbytes_rank0": int(nbytes),
        "meta": dict(meta or {}),
    }
    _atomic_write(commit_marker_path(save_dir, tag),
                  json.dumps(marker, indent=2, sort_keys=True,
                             default=str).encode())
    _fsync_dir(os.path.join(save_dir, str(tag)))


class CommitBarrier:
    """Two-phase commit rendezvous for one tag over the process group's
    key-value store (checkpointing.py:207): every rank posts a done-key
    after its files have landed; rank 0 waits for all of them, runs the
    commit action (marker + latest), then posts a committed-key the
    other ranks wait for — so once any rank's save returns, the tag is
    committed.  Keys are scoped by the save directory (`scope`) and a
    per-tag sequence number (`seq`), so a re-save of a tag never sees
    the previous round's keys.  One rank: the action runs directly."""

    def __init__(self, tag: str, timeout_ms: int = 300_000, seq: int = 0,
                 scope: str = ""):
        from ..comm import dist

        self.store = dist.store()
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.tag, self.seq, self.scope = str(tag), int(seq), str(scope)
        self.timeout = datetime.timedelta(milliseconds=int(timeout_ms))

    def _key(self, kind: str, rank: Optional[int] = None) -> str:
        scope = f"{self.scope}/" if self.scope else ""
        base = f"dstpu-ckpt/{scope}{self.tag}/{self.seq}/{kind}"
        return base if rank is None else f"{base}/{rank}"

    def commit(self, commit_fn) -> None:
        if self.world <= 1 or self.store is None:
            commit_fn()
            return
        st = self.store
        st.set(self._key("done", self.rank), "1")
        if self.rank == 0:
            try:
                st.wait([self._key("done", r) for r in range(self.world)],
                        self.timeout)
            except Exception as e:
                raise CheckpointIntegrityError(
                    f"checkpoint tag {self.tag!r}: commit barrier timed out "
                    f"waiting for rank done-keys ({e}); the tag was NOT "
                    f"committed") from e
            commit_fn()
            st.set(self._key("committed"), "1")
        else:
            try:
                st.wait([self._key("committed")], self.timeout)
            except Exception as e:
                raise CheckpointIntegrityError(
                    f"checkpoint tag {self.tag!r}: commit barrier timed out "
                    f"waiting for rank 0's commit marker ({e})") from e


def _barrier_scope(save_dir: str) -> str:
    """The commit barrier's per-directory key namespace: a hash of the
    save_dir argument every rank passes (checkpointing.py:614)."""
    return hashlib.md5(str(save_dir).encode()).hexdigest()[:12]


def _commit(save_dir: str, tag, meta: Optional[Dict[str, Any]],
            save_latest: bool, nbytes: int, commit_timeout_ms: int = 300_000,
            seq: int = 0) -> None:
    """Phase 2: rendezvous every rank, then (rank 0) the commit marker and
    `latest` — both atomic renames, in that order, so `latest` never
    names an uncommitted tag.  Module-level so crash tests can patch it
    away (a writer killed between its files and the commit).
    `ckpt.commit` is a chaos site (checkpointing.py:633)."""
    fault_point("ckpt.commit")
    barrier = CommitBarrier(str(tag), timeout_ms=commit_timeout_ms, seq=seq,
                            scope=_barrier_scope(save_dir))

    def publish():
        write_commit_marker(save_dir, tag, meta, world_size=barrier.world,
                            nbytes=nbytes)
        if save_latest:
            _atomic_write(os.path.join(save_dir, "latest"),
                          str(tag).encode())
            _fsync_dir(save_dir)

    barrier.commit(publish if barrier.rank == 0 else (lambda: None))
    COUNTERS.add("ckpt.bytes", int(nbytes))


# ---------------------------------------------------------------------------
# save / load (:656-924)
# ---------------------------------------------------------------------------


def save_checkpoint_state(save_dir: str, tag: str, model_state: Dict[str, Any],
                          optim_state: Optional[Dict[str, Any]] = None,
                          save_latest: bool = True, mp_rank: int = 0,
                          async_save: bool = False,
                          meta: Optional[Dict[str, Any]] = None,
                          ready: Optional[Callable[[], None]] = None,
                          pieces: Optional[Dict[str, Any]] = None,
                          rank: int = 0,
                          commit_timeout_ms: int = 300_000) -> str:
    """Write one tag: files -> commit barrier -> marker -> latest.  Every
    rank calls it: rank 0 writes the model file and the optimizer state
    (sharded leaves as `shard_marker`s) in its `zero_pp_rank_0` file,
    and each rank holding `pieces` ({key: {"index", "piece"}}) writes
    them to its own `zero_pp_rank_<rank>` file.  `meta` goes into the
    marker.  With `async_save` the trees must be snapshots no later step
    writes (the engine's pinned host copies); `ready`, when given, is
    called on the writer before it reads them (the snapshot's
    device-to-host copies are then complete).  Returns the tag
    directory."""
    t0 = time.perf_counter()
    # a re-save of a tag never races the previous writer over its files
    flush_pending(save_dir, tag)
    ckpt_dir = os.path.join(save_dir, str(tag))
    os.makedirs(ckpt_dir, exist_ok=True)
    with _pending_lock:
        key = _pending_key(save_dir, tag)
        seq = _tag_seq[key] = _tag_seq.get(key, -1) + 1

    def build_and_write(parallel: bool) -> int:
        jobs = []
        if rank == 0:
            jobs.append((model_ckpt_name(ckpt_dir, mp_rank), model_state))
            if optim_state is not None:
                # the v2 layout the JAX engine writes
                jobs.append((optim_ckpt_name(ckpt_dir, 0, mp_rank),
                             {_V2_MARKER: True, "pieces": pieces or {},
                              "state": optim_state}))
        elif pieces:
            jobs.append((optim_ckpt_name(ckpt_dir, rank, mp_rank),
                         {_V2_MARKER: True, "pieces": pieces}))

        def write(path, payload) -> int:
            return _atomic_write(path,
                                 lambda f: write_tree(f.write, payload))

        if parallel:
            futures = [_writer.submit(write, p, s) for p, s in jobs]
            return sum(f.result() for f in futures)
        return sum(write(p, s) for p, s in jobs)

    def finish(parallel: bool, chain_after: Optional[Future]):
        # chaos site of the writer, sync or background (:769)
        fault_point("ckpt.background_write")
        if ready is not None:
            ready()
        nbytes = build_and_write(parallel)
        if chain_after is not None:
            try:
                chain_after.result()
            except Exception:
                pass   # its own flush surfaces the error
        _commit(save_dir, tag, meta, save_latest, nbytes,
                commit_timeout_ms=commit_timeout_ms, seq=seq)

    root = os.path.realpath(save_dir)
    with _pending_lock:
        prev = _dir_chain.get(root)
    if async_save:
        done = _writer.submit(finish, False, prev)
        with _pending_lock:
            _dir_chain[root] = done
            _pending.setdefault(_pending_key(save_dir, tag), []).append(done)
        COUNTERS.add("ckpt.pending", pending_count())
    else:
        finish(True, prev)
        COUNTERS.add("ckpt.pending", 0)
    COUNTERS.add("ckpt.stall_ms", int((time.perf_counter() - t0) * 1e6))
    logger.info(f"saved checkpoint {tag} to {ckpt_dir}"
                + (" (async)" if async_save else ""))
    return ckpt_dir


def read_latest_tag(load_dir: str) -> Optional[str]:
    """The tag to resume from: `latest` when its tag is committed (or the
    directory predates commit markers), else the newest committed tag.
    Every uncommitted tag skipped is logged and counted in
    `ckpt.skipped_tags`."""
    tag = None
    latest = os.path.join(load_dir, "latest")
    if os.path.isfile(latest):
        with open(latest) as f:
            tag = f.read().strip() or None
    if tag is not None and is_tag_committed(load_dir, tag):
        return tag
    if not _dir_has_markers(load_dir):
        return tag    # legacy layout: latest is authoritative
    fallback, skipped = _partition_tags(load_dir)
    if skipped:
        COUNTERS.add("ckpt.skipped_tags", calls=len(skipped))
        for name in skipped:
            logger.warning(
                f"checkpoint tag {name!r} in {load_dir} has no commit "
                f"marker (interrupted or corrupt save) — skipped as a "
                f"resume candidate")
    if fallback:
        newest = fallback[-1]
        if tag is not None:
            logger.warning(
                f"checkpoint tag {tag!r} in {load_dir} was never "
                f"committed (interrupted save?); falling back to the "
                f"newest committed tag {newest!r}")
        return newest
    return None


def _is_marker(x) -> bool:
    return isinstance(x, dict) and bool(x.get(_SHARD_MARKER, False))


def _reassemble(tree, pieces_by_key: Dict[str, list], tag=None):
    """Sharded-leaf markers -> whole arrays from their pieces (the
    inverse of the JAX writer's `_split_sharded`)."""
    if _is_marker(tree):
        key = tree["key"]
        got = pieces_by_key.get(key, [])
        if len(got) != int(tree["num_pieces"]):
            raise CheckpointIntegrityError(
                f"checkpoint tag {tag!r}: sharded leaf {key} has "
                f"{len(got)} of {tree['num_pieces']} pieces (missing or "
                f"truncated zero_pp_rank_* rank files?)")
        shape = [int(s) for s in tree["shape"]]
        if tree["dtype"] == "bfloat16":
            full = torch.empty(shape, dtype=torch.bfloat16)
        else:
            full = np.empty(shape, dtype=np.dtype(tree["dtype"]))
        for entry in got:
            sl = tuple(slice(int(a), int(b)) for a, b in entry["index"])
            full[sl] = entry["piece"]
        return full
    if isinstance(tree, dict):
        return {k: _reassemble(v, pieces_by_key, tag) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_reassemble(v, pieces_by_key, tag) for v in tree]
    return tree


def _read(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _load_rank_pieces(ckpt_dir: str, mp_rank: int) -> Dict[str, list]:
    pieces: Dict[str, list] = {}
    pattern = os.path.join(
        ckpt_dir, f"zero_pp_rank_*_mp_rank_{mp_rank:02d}_optim_states"
        f".msgpack")
    for path in sorted(glob.glob(pattern)):
        payload = _read(path)
        for key, entry in (payload.get("pieces") or {}).items():
            pieces.setdefault(key, []).append(entry)
    return pieces


# ---------------------------------------------------------------------------
# ZeRO-Infinity stream-group files (checkpointing.py:424-490)
# ---------------------------------------------------------------------------


def stream_group_ckpt_name(ckpt_dir: str, group: str) -> str:
    """A stream group's file (its masters, Adam moments and sink
    entries): the unit of the streamed, RAM-bounded writer."""
    safe = group.replace(":", "_").replace("/", "_")
    return os.path.join(ckpt_dir, f"stream_group_{safe}.msgpack")


def stream_marker(group: str, slot: str) -> str:
    """A leaf standing in for streamed data: slot 'leaf:<j>' (the group's
    master leaf j), 'optim:<key>' (the Adam moments of leaf <key>) or
    'acc:<key>' (a mid-accumulation sink entry)."""
    return f"{_STREAM_PREFIX}{group}|{slot}"


def write_stream_group(ckpt_dir: str, group: str, payload) -> str:
    path = stream_group_ckpt_name(ckpt_dir, group)
    _atomic_write(path, lambda f: write_tree(f.write, payload))
    return path


def read_stream_group(ckpt_dir: str, group: str):
    path = stream_group_ckpt_name(ckpt_dir, group)
    if not os.path.isfile(path):
        raise CheckpointIntegrityError(
            f"checkpoint at {ckpt_dir} is incomplete: streamed group file "
            f"not found: {path}")
    return _read(path)


def resolve_streamed(tree, ckpt_dir: str):
    """Stream markers -> their data, reading the group files (one cached
    at a time: markers come in group order).  A paged engine skips this
    and walks the files itself (`InfinityRuntime.load_streamed`)."""
    cache: Dict[str, Any] = {}

    def lookup(marker: str):
        group, slot = marker[len(_STREAM_PREFIX):].split("|", 1)
        if group not in cache:
            cache.clear()
            cache[group] = read_stream_group(ckpt_dir, group)
        payload = cache[group]
        kind, _, idx = slot.partition(":")
        if kind == "leaf":
            return payload["leaves"][idx]
        if kind == "optim":
            return dict(payload["optim"][idx])
        if kind == "acc":
            return payload["acc"][idx]
        raise ValueError(f"unknown stream marker slot {slot!r}")

    def visit(node):
        if isinstance(node, str) and node.startswith(_STREAM_PREFIX):
            return lookup(node)
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node

    return visit(tree)


def has_stream_markers(tree) -> bool:
    if isinstance(tree, str):
        return tree.startswith(_STREAM_PREFIX)
    if isinstance(tree, dict):
        return any(has_stream_markers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_stream_markers(v) for v in tree)
    return False


def load_checkpoint_state(load_dir: str, tag: Optional[str] = None,
                          mp_rank: int = 0, dp_rank: int = 0,
                          resolve_streams: bool = True):
    """Returns (ckpt_dir, model_state, optim_state_or_None).

    Raises FileNotFoundError when there is nothing to resume from,
    CheckpointIntegrityError when the requested tag exists but is
    uncommitted or incomplete, and NotImplementedError for a pipeline
    tag.  resolve_streams=False leaves ZeRO-Infinity stream markers in
    place, for an engine that walks the group files itself."""
    flush_pending(load_dir)   # never race an in-flight save of the dir
    explicit = tag is not None
    if tag is None:
        tag = read_latest_tag(load_dir)
        if tag is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {load_dir}; pass an explicit "
                f"tag")
    ckpt_dir = os.path.join(load_dir, str(tag))
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"checkpoint tag not found: {ckpt_dir}")
    if explicit and not is_tag_committed(load_dir, tag) and \
            _dir_has_markers(load_dir):
        newest = committed_tags(load_dir)
        raise CheckpointIntegrityError(
            f"checkpoint tag {tag!r} in {load_dir} exists but has no "
            f"commit marker ({COMMIT_MARKER}) — the save was interrupted "
            f"before commit and the tag may be missing files"
            + (f"; newest committed tag is {newest[-1]!r}" if newest
               else ""))
    if glob.glob(os.path.join(ckpt_dir, "layer_*-model_states.msgpack")):
        _refuse(f"checkpoint tag {tag!r} holds pipeline layer files",
                "pipeline")
    path = model_ckpt_name(ckpt_dir, mp_rank)
    if not os.path.isfile(path):
        raise CheckpointIntegrityError(
            f"checkpoint tag {tag!r} at {ckpt_dir} is incomplete: "
            f"missing model states file {os.path.basename(path)}")
    model_state = _read(path)
    module = model_state.get("module")
    if isinstance(module, dict) and "num_layers" in module:
        _refuse(f"checkpoint tag {tag!r} is a pipeline tag", "pipeline")

    pieces = _load_rank_pieces(ckpt_dir, mp_rank)
    if pieces:
        model_state = _reassemble(model_state, pieces, tag=tag)

    optim_state = None
    opath = optim_ckpt_name(ckpt_dir, dp_rank, mp_rank)
    if os.path.isfile(opath):
        optim_state = _read(opath)
        if isinstance(optim_state, dict) and optim_state.get(_V2_MARKER):
            optim_state = _reassemble(optim_state.get("state"), pieces,
                                      tag=tag)
    if resolve_streams:
        if has_stream_markers(model_state):
            model_state = resolve_streamed(model_state, ckpt_dir)
        if has_stream_markers(optim_state):
            optim_state = resolve_streamed(optim_state, ckpt_dir)
    return ckpt_dir, model_state, optim_state
