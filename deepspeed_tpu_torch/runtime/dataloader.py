"""Data loading — the port of deepspeed_tpu/runtime/dataloader.py:
DeepSpeedDataLoader, RepeatingLoader, PrefetchLoader and `timed_next`,
as the same numpy code (the batches are byte-equal to the JAX package's
for the same dataset, batch size, seed and shuffle).

The loader yields numpy batches; the engine places them on the card
(`runtime/engine.py` `_DeviceFeed`).  The shuffle is
`np.random.RandomState(seed + epoch)` over the sample order, padded by
wrapping to equal shards (DistributedSampler semantics; one shard in a
single process).  The sample cursor (`record_consumed`, `sample_cursor`,
`load_sample_cursor`) counts the batches the training loop consumed, not
those a prefetch worker produced ahead; the engine checkpoints it in the
commit marker's meta and a restored loader resumes one batch past the
last trained one.

PrefetchLoader runs fetch + collate on background threads feeding
bounded queues, in a deterministic order whatever the worker count; a
worker that dies is respawned at the batch it died on, up to a budget
(`input.worker_respawns` counts them), after which its exception
re-raises at the consumer.  Both producers carry the JAX module's chaos
site, `dataloader.worker` (runtime/resilience.py `fault_point`), before
each batch: a transient `raise` rule there kills a worker, which the
consumer respawns, and the batches stay byte-identical.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Optional

import numpy as np

from ..monitor.counters import COUNTERS
from ..utils.logging import logger
from .resilience import fault_point

# a dead prefetch worker no longer kills training: the consumer
# respawns it (resuming at the exact failed batch, so order and content
# are unchanged) up to MAX_RESPAWNS times per epoch, with doubling
# backoff between respawns.  After the budget the original exception
# re-raises — a deterministically failing dataset must still surface.
WORKER_MAX_RESPAWNS = 2
WORKER_RESPAWN_BACKOFF_S = 0.05


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference :10-31).
    Advances the wrapped loader's epoch on each wrap so shuffling loaders
    re-shuffle instead of replaying one permutation.  The counter seeds
    from the wrapped loader's CURRENT epoch (when it exposes one), so a
    loader restored mid-run from a sample cursor keeps its shuffle
    schedule instead of snapping back to epoch 1 on the first wrap."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)
        self._epoch = int(getattr(loader, "epoch", 0) or 0)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self._epoch += 1
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(self._epoch)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def _default_collate(items):
    """Stack a list of samples into a batch pytree of numpy arrays."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([it[i] for it in items])
                           for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class DeepSpeedDataLoader:
    """Batched, optionally shuffled, optionally sharded loader
    (dataloader.py:86).

    dataset: any indexable (len + __getitem__) of samples (arrays, tuples,
    dicts). Yields batches as numpy pytrees.

    drop_last=False pads the tail batch to full size by WRAPPING around
    this shard's sample order (DistributedSampler-style), so every batch
    has the step's shape.  The duplicates slightly overweight the wrapped
    samples in that batch's loss — acceptable for training; for exact
    evaluation sums, account for `len(dataset)` yourself.
    """

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 local_rank: int = -1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, data_parallel_world_size: Optional[int] = None,
                 data_parallel_rank: Optional[int] = None,
                 row_slice: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # one process: the whole batch unless shards are asked for
        self.num_shards = (data_parallel_world_size
                           if data_parallel_world_size is not None else 1)
        self.shard_id = (data_parallel_rank if data_parallel_rank is not None
                         else 0)
        self.epoch = 0
        # (start, stop): the rows of every batch this reader materializes —
        # a data-parallel rank's contiguous slice of the global batch;
        # the batch stream and the cursor stay the global batches'
        self.row_slice = row_slice
        if self.batch_size % max(1, self.num_shards) == 0:
            self._per_shard = self.batch_size // max(1, self.num_shards)
        else:
            raise ValueError(
                f"batch_size {batch_size} not divisible by data shards "
                f"{self.num_shards}")
        # every shard sees the SAME number of samples (wraparound padding,
        # DistributedSampler-style) — unequal counts would desync lockstep
        # SPMD processes and hang collectives
        import math

        self._samples_per_shard = math.ceil(len(dataset) /
                                            max(1, self.num_shards))
        self.len = self._samples_per_shard // self._per_shard
        if not self.drop_last and self._samples_per_shard % self._per_shard:
            self.len += 1
        # sample cursor (elastic exactly-once stream): the CONSUMED-side
        # position — batches the training loop actually trained on, NOT
        # batches a prefetch worker produced ahead.  The engine advances
        # it per trained batch (record_consumed), checkpoints it in the
        # commit marker's meta (sample_cursor), and a restored loader —
        # possibly at a DIFFERENT shard count after an elastic shrink —
        # resumes the epoch at `_start_batch`.  Positions count GLOBAL
        # batches, which are width-independent: at any shard count W,
        # batch k of an epoch consumes exactly positions [k*B, (k+1)*B)
        # of the epoch's padded sample order (rank-strided slicing
        # commutes with the per-shard batch boundaries), so skipping k
        # batches at a new width skips exactly the samples the old
        # width already consumed.
        self._consumed_epoch = 0
        self._consumed_position = 0
        self._start_batch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.len

    # -- sample cursor (elastic exactly-once stream) -------------------

    def record_consumed(self, n: int = 1) -> None:
        """Advance the consumed-side cursor by `n` trained batches
        (engine-called at train_batch boundaries)."""
        per_epoch = max(1, self.len)
        self._consumed_position += int(n)
        while self._consumed_position >= per_epoch:
            self._consumed_position -= per_epoch
            self._consumed_epoch += 1

    def sample_cursor(self) -> dict:
        """The checkpointable cursor: everything a restoring run (at
        any shard count) needs to regenerate the exact remaining sample
        stream."""
        return {
            "epoch": self._consumed_epoch,
            "position": self._consumed_position,
            "seed": int(self.seed),
            "shuffle": bool(self.shuffle),
            "batch_size": int(self.batch_size),
            "drop_last": bool(self.drop_last),
            "dataset_len": len(self.dataset),
        }

    def load_sample_cursor(self, cursor: dict) -> None:
        """Shard-aware restore of a `sample_cursor()` snapshot, possibly
        at a different shard count / global batch size than it was saved
        at.  The saving run's (seed, shuffle) are ADOPTED — the epoch
        permutation must match or samples would drop/duplicate — and a
        position in old-batch units converts through the sample count
        (loud error when the old progress doesn't land on a new batch
        boundary).  A position past this width's epoch length (padding
        differences across widths) rolls into the next epoch."""
        try:
            epoch = int(cursor["epoch"])
            position = int(cursor["position"])
            saved_bs = int(cursor.get("batch_size", self.batch_size))
        except (KeyError, TypeError, ValueError):
            raise ValueError(
                f"sample cursor is malformed (needs integer epoch/"
                f"position): {cursor!r}")
        if epoch < 0 or position < 0 or saved_bs < 1:
            raise ValueError(f"sample cursor out of range: {cursor!r}")
        if "seed" in cursor and int(cursor["seed"]) != self.seed:
            logger.warning(
                f"sample cursor: adopting the saving run's shuffle seed "
                f"{cursor['seed']} (this loader was built with "
                f"{self.seed}) — the epoch permutation must match for "
                f"an exactly-once stream")
            self.seed = int(cursor["seed"])
        if "shuffle" in cursor and bool(cursor["shuffle"]) != self.shuffle:
            logger.warning(
                f"sample cursor: adopting the saving run's "
                f"shuffle={bool(cursor['shuffle'])} (this loader was "
                f"built with {self.shuffle})")
            self.shuffle = bool(cursor["shuffle"])
        if cursor.get("dataset_len") is not None and \
                int(cursor["dataset_len"]) != len(self.dataset):
            logger.warning(
                f"sample cursor: dataset length changed "
                f"({cursor['dataset_len']} -> {len(self.dataset)}) — "
                f"the exactly-once guarantee only holds over an "
                f"unchanged dataset")
        if saved_bs != self.batch_size:
            samples = position * saved_bs
            if samples % self.batch_size:
                raise ValueError(
                    f"sample cursor: {position} batches of {saved_bs} "
                    f"({samples} samples) do not land on a batch "
                    f"boundary of the new global batch size "
                    f"{self.batch_size} — keep the global batch "
                    f"constant across elastic transitions (or resume "
                    f"at a divisible point)")
            position = samples // self.batch_size
        per_epoch = max(1, self.len)
        if position >= per_epoch:
            # a different width's padding gave the saved epoch more
            # batches than this width has: the overflow is the next
            # epoch's head
            epoch += position // per_epoch
            position %= per_epoch
        self.epoch = epoch
        self._consumed_epoch = epoch
        self._consumed_position = position
        self._start_batch = position

    def _batch_indices(self):
        """Yield this shard's per-batch sample-index arrays for the
        CURRENT epoch, skipping the first `_start_batch` batches after
        a sample-cursor restore (consumed once; later epochs start at
        0).  Pure numpy (cheap) — the expensive part (dataset[j] +
        collate) lives in _materialize, so PrefetchLoader workers can
        collate different batches in parallel while this generator
        fixes the deterministic order."""
        start, self._start_batch = self._start_batch, 0
        for i, ids in enumerate(self._epoch_batch_indices()):
            if i >= start:
                yield (ids if self.row_slice is None
                       else ids[self.row_slice[0]:self.row_slice[1]])

    def _epoch_batch_indices(self):
        """The full epoch's batch-index stream (no cursor skip)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        # DistributedSampler semantics: pad to equal length by wrapping, then
        # rank-strided slice — all shards yield the same batch count
        total = self._samples_per_shard * self.num_shards
        if total > n:
            order = np.concatenate([order, order[:total - n]])
        shard_idx = order[self.shard_id::self.num_shards]
        for i in range(0, len(shard_idx) - self._per_shard + 1, self._per_shard):
            yield shard_idx[i:i + self._per_shard]
        if not self.drop_last:
            tail = len(shard_idx) % self._per_shard
            if tail:
                # wraparound pad to _per_shard: a full-size tail keeps the
                # batch on the sharded (not replicated) engine path.
                # np.resize TILES the shard order, so even a shard with
                # fewer samples than _per_shard pads to full size
                ids = shard_idx[len(shard_idx) - tail:]
                pad = np.resize(shard_idx, self._per_shard - tail)
                yield np.concatenate([ids, pad])

    def _materialize(self, batch_ids):
        """Sample fetch + collate for one index array (the per-batch unit
        of work PrefetchLoader parallelizes)."""
        return self.collate_fn([self.dataset[int(j)] for j in batch_ids])

    def __iter__(self):
        for batch_ids in self._batch_indices():
            yield self._materialize(batch_ids)


# ---------------------------------------------------------------------------
# PrefetchLoader — background fetch+collate with a bounded queue
# ---------------------------------------------------------------------------

_DONE = object()   # producer sentinel: the underlying stream is exhausted


class _WorkerError:
    """Exception carrier: re-raised at the consumer, in order."""

    def __init__(self, exc):
        self.exc = exc


def _shutdown(stop: threading.Event, queues, threads) -> None:
    """Module-level so weakref.finalize holds no reference to the
    iterator: signal stop, drain the queues (unblocking producers stuck
    on a full put), and join the threads."""
    stop.set()
    for q in queues:
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
    me = threading.current_thread()
    for t in threads:
        if t is not me:  # GC may run the finalizer on a producer itself
            t.join(timeout=5.0)


def _bounded_put(stop: threading.Event, q: queue.Queue, item) -> bool:
    """Bounded put that aborts promptly on shutdown."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


# producer bodies are MODULE-LEVEL: a bound-method thread target would
# keep the iterator alive from its own worker threads (a cycle that
# defers GC teardown and can run the finalizer on a producer)

def _index_producer(stop, loader, tasks, worker_id, n_workers, q,
                    start=0):
    """`start` skips this worker's first `start` tasks — a RESPAWNED
    worker resumes at exactly the batch its predecessor died on (the
    consumer counts what each queue delivered), so the batch stream
    stays byte-identical through a worker death."""
    try:
        for i in range(worker_id + n_workers * start, len(tasks),
                       n_workers):
            if stop.is_set():
                return
            fault_point("dataloader.worker")
            if not _bounded_put(stop, q, loader._materialize(tasks[i])):
                return
    except BaseException as e:  # noqa: BLE001 — carried to the consumer
        _bounded_put(stop, q, _WorkerError(e))
        return
    _bounded_put(stop, q, _DONE)


def _stream_producer(stop, it, q):
    try:
        while not stop.is_set():
            fault_point("dataloader.worker")
            try:
                item = next(it)
            except StopIteration:
                break
            if not _bounded_put(stop, q, item):
                return
    except BaseException as e:  # noqa: BLE001
        _bounded_put(stop, q, _WorkerError(e))
        return
    _bounded_put(stop, q, _DONE)


class _PrefetchIterator:
    """One epoch of prefetched batches.  Two producer layouts:

    * index mode (the wrapped loader exposes _batch_indices/_materialize,
      i.e. DeepSpeedDataLoader): batch i is collated by worker
      i % num_workers, each worker feeding its own bounded queue; the
      consumer pops queue i % num_workers — parallel collate, identical
      order.
    * stream mode (any other iterable): iteration is inherently serial,
      so ONE producer thread pulls next() into a single bounded queue.
    """

    def __init__(self, loader, depth: int, num_workers: int,
                 max_respawns: int = WORKER_MAX_RESPAWNS,
                 respawn_backoff_s: float = WORKER_RESPAWN_BACKOFF_S):
        self._stop = threading.Event()
        self._exhausted = False
        indexable = (hasattr(loader, "_batch_indices")
                     and hasattr(loader, "_materialize"))
        workers = max(1, int(num_workers)) if indexable else 1
        depth = max(1, int(depth))
        if num_workers > 1 and not indexable:
            logger.warning(
                "PrefetchLoader: num_workers > 1 needs an index-protocol "
                "loader (DeepSpeedDataLoader); falling back to one "
                "producer thread for a generic iterable")
        # total buffered batches across workers stays ~depth
        per_q = max(1, -(-depth // workers))
        self._queues = [queue.Queue(maxsize=per_q) for _ in range(workers)]
        self._next_q = 0
        # worker-death recovery (index mode only: a stream iterator's
        # position dies with its thread): budget + doubling backoff,
        # plus the per-queue delivered counts a respawn resumes from
        self._loader = loader if indexable else None
        self._tasks = None
        self._n_workers = workers
        self._delivered = [0] * workers
        self._respawns_left = max(0, int(max_respawns))
        self._respawns_done = 0
        self._respawn_backoff_s = float(respawn_backoff_s)
        if indexable:
            # snapshot the epoch's batch order ONCE (cheap numpy) so every
            # worker agrees on the task list even if set_epoch races later
            tasks = list(loader._batch_indices())
            self._tasks = tasks
            self._threads = [
                threading.Thread(
                    target=_index_producer,
                    args=(self._stop, loader, tasks, w, workers,
                          self._queues[w]),
                    name=f"dstpu-prefetch-{w}", daemon=True)
                for w in range(workers)]
        else:
            self._threads = [threading.Thread(
                target=_stream_producer,
                args=(self._stop, iter(loader), self._queues[0]),
                name="dstpu-prefetch-0", daemon=True)]
        for t in self._threads:
            t.start()
        self._finalizer = weakref.finalize(
            self, _shutdown, self._stop, self._queues, self._threads)

    def _respawn_worker(self, w: int, exc: BaseException) -> bool:
        """Replace dead index-mode worker `w` with a fresh thread that
        resumes at the batch it died on.  Returns False when recovery
        is off the table (stream mode / budget exhausted / shut down)."""
        if self._loader is None or self._respawns_left <= 0 or \
                self._stop.is_set():
            return False
        self._respawns_left -= 1
        backoff = self._respawn_backoff_s * (2 ** self._respawns_done)
        self._respawns_done += 1
        COUNTERS.add("input.worker_respawns")
        logger.warning(
            f"PrefetchLoader: worker {w} died ({type(exc).__name__}: "
            f"{exc}); respawning at batch offset {self._delivered[w]} in "
            f"{backoff * 1000:.0f} ms ({self._respawns_left} respawn(s) "
            f"left)")
        time.sleep(backoff)
        t = threading.Thread(
            target=_index_producer,
            args=(self._stop, self._loader, self._tasks, w,
                  self._n_workers, self._queues[w]),
            kwargs={"start": self._delivered[w]},
            name=f"dstpu-prefetch-{w}r", daemon=True)
        self._threads[w] = t
        # the finalizer must join the CURRENT thread set
        self._finalizer.detach()
        self._finalizer = weakref.finalize(
            self, _shutdown, self._stop, self._queues, self._threads)
        t.start()
        return True

    # -- consumer ----------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        q = self._queues[self._next_q]
        # observability: queue depth at pop time — how far ahead the
        # producers are running (input.queue_depth mean = bytes/calls)
        COUNTERS.add("input.queue_depth", sum(x.qsize()
                                              for x in self._queues))
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = q.get(timeout=0.5)
                break
            except queue.Empty:
                # producer may have died without a sentinel (interpreter
                # teardown): fail closed instead of hanging forever —
                # with one last non-blocking pop to close the window
                # where the item landed between timeout and the check
                if not any(t.is_alive() for t in self._threads):
                    try:
                        item = q.get_nowait()
                        break
                    except queue.Empty:
                        self.close()
                        raise StopIteration
        if item is _DONE:
            # round-robin invariant: the FIRST _DONE (always on the queue
            # owning the next batch index) means no later batch exists on
            # any other queue — drain and stop
            self.close()
            raise StopIteration
        if isinstance(item, _WorkerError):
            # a dead worker stops at its failed batch with everything
            # before it already delivered in order — respawn it to
            # RETRY that batch (bounded budget + doubling backoff) so
            # one transient worker death no longer kills training
            if self._respawn_worker(self._next_q, item.exc):
                return self.__next__()
            self.close()
            raise item.exc
        self._delivered[self._next_q] += 1
        self._next_q = (self._next_q + 1) % len(self._queues)
        return item

    def close(self):
        """Idempotent: stop producers, drain queues, join threads."""
        self._exhausted = True
        if self._finalizer.alive:
            self._finalizer()


class PrefetchLoader:
    """Run a loader's fetch+collate on background thread(s) with a
    bounded queue (`prefetch_depth` batches buffered, `num_workers`
    parallel collate threads when the wrapped loader supports it).

    Transparent: same batches, same order, same dtypes — `train_batch`
    parity with the unwrapped loader is pinned byte-exact in
    tests/test_torch_dataloader.py.  Forwards len()/set_epoch so it can
    wrap DeepSpeedDataLoader under RepeatingLoader unchanged."""

    def __init__(self, loader: Iterable[Any], prefetch_depth: int = 2,
                 num_workers: int = 1,
                 max_respawns: int = WORKER_MAX_RESPAWNS,
                 respawn_backoff_s: float = WORKER_RESPAWN_BACKOFF_S):
        if prefetch_depth < 1:
            raise ValueError(
                f"PrefetchLoader: prefetch_depth must be >= 1, "
                f"got {prefetch_depth}")
        if num_workers < 1:
            raise ValueError(
                f"PrefetchLoader: num_workers must be >= 1, "
                f"got {num_workers}")
        self.loader = loader
        self.prefetch_depth = int(prefetch_depth)
        self.num_workers = int(num_workers)
        self.max_respawns = int(max_respawns)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self._live_iter: Optional[weakref.ReferenceType] = None

    def __len__(self):
        return len(self.loader)

    @property
    def epoch(self):
        """The wrapped loader's current epoch (RepeatingLoader seeds
        its wrap counter from this, so a cursor-restored loader keeps
        its shuffle schedule through the prefetch wrapper)."""
        return getattr(self.loader, "epoch", 0)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self):
        # one live epoch at a time: iterating again tears the previous
        # iterator's threads down first (RepeatingLoader re-iters per epoch)
        prev = self._live_iter() if self._live_iter is not None else None
        if prev is not None:
            prev.close()
        it = _PrefetchIterator(self.loader, self.prefetch_depth,
                               self.num_workers,
                               max_respawns=self.max_respawns,
                               respawn_backoff_s=self.respawn_backoff_s)
        self._live_iter = weakref.ref(it)
        return it

    def close(self):
        prev = self._live_iter() if self._live_iter is not None else None
        if prev is not None:
            prev.close()


def timed_next(data_iter, tracer=None, step=None):
    """next(data_iter) with the host-blocked wall time recorded as
    `input.host_wait_ms` (integer microseconds in the bytes slot).  Every
    engine-side pull from a host iterator goes through here, so the
    prefetch-on and -off runs measure the same thing.  `tracer` (a
    monitor/tracing.py TraceRecorder, already gated by the engine's
    per-step sampling) also lands the wait as an `input_wait` span on the
    trace timeline (dataloader.py:590)."""
    t0 = time.perf_counter()
    batch = next(data_iter)
    dt_us = int((time.perf_counter() - t0) * 1e6)
    COUNTERS.add("input.host_wait_ms", dt_us)
    if tracer is not None:
        tracer.add_complete("input_wait", "input", dur_us=dt_us,
                            **({} if step is None else {"step": step}))
    return batch
