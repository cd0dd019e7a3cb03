"""The continuous-batching serving engine — the port of
deepspeed_tpu/serving/engine.py.

One `ServeEngine` owns a `PagedKVCache` (block pool + free list), a
`Scheduler` (admission + slots) and the prefill/decode programs of
`programs.py`.  `step()` is the whole serving loop body — admit, prefill
one chunk round, decode one token for every running slot (or, with
`draft_len > 0`, verify a drafted run of them) — and `run()` /
`generate()` drive it.

Quantized KV (`kv_dtype="int8" | "int4"`) stores the cache's rows as
codes plus one fp16 scale per row and head; the paged-attention kernel
dequantizes them in its gather.  Speculative decoding (`draft_len > 0`)
drafts up to `draft_len` tokens per running request from its own context
(the n-gram self-drafter `_propose_draft`) and scores them in one verify
pass; the emitted stream is token for token the non-speculative one at
the same kv_dtype.

Prefix caching and pinned sessions: admission aliases the request's
already-cached full prompt blocks so prefill starts at the first
non-cached position, and a request submitted with a `session_id` keeps
its blocks resident after finishing (`SessionPin`, TTL + released under
pressure) so the next turn re-prefills only its new tokens.

`request_shed()` (safe from any thread) makes the next step finish the
in-flight batch in state "error" with its blocks reclaimed
(`kv.evictions`); waiting requests proceed.

Counters: `serve.requests`, `serve.tokens`, `serve.decode_steps`,
`serve.prefill_chunks`, `serve.ttft_ms` (µs in the bytes slot),
`serve.shed`, `serve.draft_tokens` and `serve.accepted_tokens` (calls),
`kv.dequant_ms` (µs in the bytes slot: the host time of each decode or
verify dispatch against a quantized cache), and the cache's `kv.*`
family.

Not ported yet: quantized weights (NotImplementedError), fault points,
tracing and SLO telemetry, the watchdog, `ServeWorker` and the fleet
router.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np

from ..models.gpt import GPT
from ..monitor.counters import COUNTERS
from ..utils.device import check_same_device, resolve_device
from ..utils.logging import logger
from . import programs
from .kv_cache import TRASH_BLOCK, PagedKVCache
from .programs import ServeSchedule
from .scheduler import (ADMISSION_POLICIES, ERROR, FINISHED, RUNNING,
                        Request, Scheduler)


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (validated at construction)."""

    block_size: int = 16              # tokens per KV block
    num_blocks: int = 64              # pool size INCLUDING the trash block
    max_batch: int = 8                # decode slots
    prefill_chunk: int = 32           # prompt tokens per prefill call
    max_seq_len: Optional[int] = None  # per-request cap; default model's
    admission: str = "continuous"     # "continuous" | "static"
    max_prefill_chunks_per_step: int = 1
    quantized_weights: Any = False    # False only (qwZ is not ported)
    kv_dtype: Any = None              # None (param dtype) | "bf16" |
    #                                   "int8" | "int4" | a torch dtype
    draft_len: int = 0                # speculative candidates per step
    spec_ngram: int = 3               # suffix n-gram the drafter matches
    prefix_cache: bool = True         # block-level prefix sharing
    prefix_min_match_blocks: int = 1  # shortest chain worth aliasing
    session_ttl_s: float = 120.0      # pinned-session residency window

    def __post_init__(self):
        for name in ("block_size", "max_batch", "prefill_chunk",
                     "max_prefill_chunks_per_step"):
            if int(getattr(self, name)) < 1:
                raise ValueError(
                    f"serving {name} must be >= 1, got "
                    f"{getattr(self, name)}")
        if int(self.num_blocks) < 2:
            raise ValueError(
                f"serving num_blocks must be >= 2 (block 0 is reserved), "
                f"got {self.num_blocks}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"serving admission must be one of {ADMISSION_POLICIES}, "
                f"got {self.admission!r}")
        q = self.quantized_weights
        if q not in (False, None, "int8", "int4"):
            raise ValueError(
                f"serving quantized_weights must be False, 'int8' or "
                f"'int4', got {q!r}")
        if q:
            raise NotImplementedError(
                f"serving quantized_weights={q!r}: qwZ weights are not "
                f"ported yet (ROADMAP: qwZ, kernels 11-12)")
        if self.kv_dtype is not None:
            from .kv_cache import resolve_kv_dtype

            resolve_kv_dtype(self.kv_dtype)  # raises on typos, loudly
        if int(self.draft_len) < 0:
            raise ValueError(
                f"serving draft_len must be >= 0, got {self.draft_len}")
        if int(self.spec_ngram) < 1:
            raise ValueError(
                f"serving spec_ngram must be >= 1, got {self.spec_ngram}")
        if int(self.prefix_min_match_blocks) < 1:
            raise ValueError(
                f"serving prefix_min_match_blocks must be >= 1, got "
                f"{self.prefix_min_match_blocks}")
        if float(self.session_ttl_s) <= 0:
            raise ValueError(
                f"serving session_ttl_s must be > 0, got "
                f"{self.session_ttl_s}")

    @property
    def quant_mode(self) -> str:
        return self.quantized_weights if self.quantized_weights else "none"


@dataclasses.dataclass
class SessionPin:
    """One resident session: a finished request's KV blocks held by an
    extra reference.  `tokens` is the full history (prompt + output) the
    pin's blocks encode; `cached_len` the rows actually written (the
    final emitted token's K/V never is)."""

    sid: Any
    owner: Any                        # the kv allocator's owner key
    tokens: List[int]
    cached_len: int
    blocks: int
    expires: float


class ServeEngine:
    """Continuous-batching decode engine over a paged KV cache on
    `device` (the card by default; the model must live there).  One
    thread drives `step()`; `submit()` is safe from any thread."""

    def __init__(self, model: GPT, config: Optional[ServeConfig] = None,
                 device="cuda", clock=time.monotonic):
        self.device = resolve_device(device)
        check_same_device("model", model.device, self.device)
        self.model = model
        self.config = config or ServeConfig()
        self.clock = clock
        cfg = model.config
        c = self.config
        self.max_seq_len = int(c.max_seq_len or cfg.max_seq_len)
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError(
                f"serving max_seq_len {self.max_seq_len} exceeds the "
                f"model's positional table ({cfg.max_seq_len})")
        table_width = -(-self.max_seq_len // c.block_size)
        # the chain-hash salt: anything that changes K/V block CONTENT
        # for the same token ids keys the prefix cache (the JAX package's
        # string, so both packages hash blocks alike)
        prefix_salt = (f"{cfg.num_layers}|{cfg.num_heads}|{cfg.head_dim}|"
                       f"{cfg.vocab_size}|{cfg.max_seq_len}|{c.quant_mode}")
        self.kv = PagedKVCache(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            head_dim=cfg.head_dim, num_blocks=c.num_blocks,
            block_size=c.block_size, table_width=table_width,
            dtype=(cfg.param_dtype if c.kv_dtype is None else c.kv_dtype),
            device=self.device, prefix_cache=c.prefix_cache,
            min_match_blocks=c.prefix_min_match_blocks,
            prefix_salt=prefix_salt)
        self.scheduler = Scheduler(self.kv, c.max_batch,
                                   admission=c.admission, clock=clock,
                                   draft_len=int(c.draft_len))
        # resident sessions (sid -> SessionPin), insertion-ordered so
        # pressure release walks oldest-pinned first
        self._sessions: "dict[Any, SessionPin]" = {}
        if c.prefix_cache:
            self.scheduler.session_lookup = self._session_lookup
            self.scheduler.session_consumed = self._session_consumed
        self.schedule = ServeSchedule(
            max_batch=c.max_batch, prefill_chunk=c.prefill_chunk,
            block_size=c.block_size, num_blocks=c.num_blocks,
            table_width=table_width,
            kv_dtype=(self.kv.quant_wire or "dense"),
            draft_len=int(c.draft_len))
        logger.info(f"serving engine up: {self.schedule.describe()}; "
                    f"{self.kv.describe()}")
        # packed decode-batch state (one row per slot), host-side
        R, W = c.max_batch, table_width
        self._tokens = np.zeros((R,), np.int64)
        self._positions = np.zeros((R,), np.int64)
        self._active = np.zeros((R,), bool)
        self._tables = np.full((R, W), TRASH_BLOCK, np.int64)
        self._temps = np.zeros((R,), np.float32)
        self._topks = np.zeros((R,), np.int64)
        self._seeds = np.zeros((R,), np.int64)
        self.steps = 0
        self.peak_blocks_in_use = 0
        self._shed_reason: Optional[str] = None

    # -- submission ---------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               eos_token: Optional[int] = None,
               session_id: Optional[Any] = None) -> Request:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + int(max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} "
                f"exceeds the engine's max_seq_len {self.max_seq_len}")
        if int(top_k) < 0 or float(temperature) < 0.0:
            raise ValueError(
                f"top_k must be >= 0 and temperature >= 0, got "
                f"{top_k}, {temperature}")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      seed=int(seed), eos_token=eos_token,
                      session_id=session_id)
        self.scheduler.submit(req)
        return req

    # -- pinned sessions ----------------------------------------------

    @property
    def resident_sessions(self) -> int:
        return len(self._sessions)

    def _session_lookup(self, req: Request):
        """Scheduler hook: the pin `req` can adopt, or None.  A pin is
        served only when its history is a PREFIX of the new prompt;
        anything else releases it and falls back to chain-hash matching."""
        s = self._sessions.get(req.session_id)
        if s is None:
            return None
        n = len(s.tokens)
        if (s.expires <= self.clock() or n > len(req.prompt)
                or req.prompt[:n] != s.tokens):
            self.release_session(s.sid)
            return None
        return s

    def _session_consumed(self, req: Request, pin: SessionPin) -> None:
        """Scheduler hook: the pin's blocks now belong to `req`."""
        self._sessions.pop(pin.sid, None)

    def _pin_session(self, req: Request) -> None:
        """Keep a naturally-finished session request's blocks resident
        (one extra reference each).  Called BEFORE scheduler.finish drops
        the request's own references."""
        sid = req.session_id
        old = self._sessions.pop(sid, None)
        if old is not None:
            self.kv.free(old.owner)
        owner = ("session", sid, req.rid)
        n = self.kv.pin(owner, req.rid)
        if not n:
            return
        self._sessions[sid] = SessionPin(
            sid=sid, owner=owner, tokens=req.prompt + req.out,
            cached_len=req.cached_len, blocks=n,
            expires=self.clock() + float(self.config.session_ttl_s))
        COUNTERS.add("kv.session_pins", nbytes=n)

    def release_session(self, sid) -> bool:
        """Drop a session's pin.  Returns True if held."""
        s = self._sessions.pop(sid, None)
        if s is None:
            return False
        self.kv.free(s.owner)
        return True

    def _expire_sessions(self) -> None:
        now = self.clock()
        for sid in [sid for sid, s in self._sessions.items()
                    if s.expires <= now]:
            self.release_session(sid)

    def _session_pressure_release(self) -> None:
        """While admission starves the queue head with a decode slot free
        (the shortfall is blocks, not slots), release pinned sessions
        oldest-first and retry."""
        sch = self.scheduler
        while (sch.n_waiting and self._sessions
               and any(s is None for s in sch.slots)
               and not (sch.admission == "static"
                        and any(s is not None for s in sch.slots))):
            oldest = next(iter(self._sessions))
            self.release_session(oldest)
            if sch.admit():
                break

    # -- shedding -----------------------------------------------------

    def request_shed(self, reason: str = "shed requested") -> None:
        """Flag the in-flight batch for shedding; safe from any thread.
        Consumed at the next point the engine thread is live."""
        self._shed_reason = str(reason)

    def _check_shed(self) -> bool:
        reason = self._shed_reason
        if reason is None:
            return False
        self._shed_reason = None
        victims = self.scheduler.occupied()
        for req in victims:
            slot = req.slot
            self.scheduler.finish(req, ERROR, error=reason)
            if slot is not None:
                self._active[slot] = False
                self._tables[slot] = TRASH_BLOCK
        if victims:
            COUNTERS.add("serve.shed", calls=len(victims))
            logger.error(
                f"serving: SHED {len(victims)} in-flight request(s) "
                f"({reason}); {self.kv.blocks_in_use} blocks still held, "
                f"{self.scheduler.n_waiting} waiting proceed")
        return bool(victims)

    # -- the serving loop body ----------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit -> prefill chunk round -> decode.
        Returns True when any work was done."""
        self._check_shed()
        self._expire_sessions()
        self.scheduler.admit()
        self._session_pressure_release()
        did = False
        for req in self.scheduler.prefilling()[
                :self.config.max_prefill_chunks_per_step]:
            if self._check_shed():
                return True
            self._prefill_chunk(req)
            did = True
        running = self.scheduler.running()
        if running:
            if self._check_shed():
                return True
            self._decode_step(running)
            did = True
        if did:
            self.steps += 1
            self.kv.sample_occupancy()
            self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                          self.kv.blocks_in_use)
        return did

    def has_work(self) -> bool:
        return self.scheduler.has_work() or self._shed_reason is not None

    def run(self) -> None:
        """Drive step() until every submitted request is terminal."""
        while self.scheduler.has_work():
            self.step()

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, seeds: Optional[Sequence[int]] = None,
                 eos_token: Optional[int] = None) -> List[List[int]]:
        """Synchronous convenience: submit all, run to completion,
        return the token lists (raises if any request errored)."""
        reqs = [self.submit(p, max_new_tokens, temperature=temperature,
                            top_k=top_k,
                            seed=(seeds[i] if seeds is not None else 0),
                            eos_token=eos_token)
                for i, p in enumerate(prompts)]
        self.run()
        for r in reqs:
            if r.state == ERROR:
                raise RuntimeError(f"request {r.rid} failed: {r.error}")
        return [r.out for r in reqs]

    # -- phases --------------------------------------------------------

    def _prefill_chunk(self, req: Request) -> None:
        C = self.config.prefill_chunk
        chunk = req.prompt[req.prefill_pos:req.prefill_pos + C]
        n_valid = len(chunk)
        tokens = np.zeros((1, C), np.int64)
        tokens[0, :n_valid] = chunk
        tok, _logits = programs.prefill(
            self.model, self.kv.caches, self.schedule, tokens,
            req.prefill_pos, n_valid, req.table, req.temperature,
            req.top_k, req.seed)
        req.prefill_pos += n_valid
        req.cached_len = req.prefill_pos
        COUNTERS.add("serve.prefill_chunks", nbytes=n_valid)
        if req.prefill_pos < len(req.prompt):
            return
        # final chunk committed: publish the prompt's full blocks under
        # their chain hashes (pin-adopted requests carry none)
        if req.block_hashes:
            start = -(-req.prefix_cached_tokens // self.kv.block_size)
            self.kv.register_prefix(req.rid, req.block_hashes, start)
        # the program sampled the request's FIRST token
        first = int(tok)
        now = self.clock()
        req.t_first_token = now
        req.token_times.append(now)
        req.out.append(first)
        COUNTERS.add("serve.tokens")
        COUNTERS.add("serve.ttft_ms", nbytes=int(req.ttft_s * 1e6))
        if self._is_finished(req, first):
            self._finish(req)
            return
        req.state = RUNNING
        slot = req.slot
        self._tokens[slot] = first
        # the first decode step writes this token's K/V at position P
        self._positions[slot] = len(req.prompt)
        self._active[slot] = True
        self._tables[slot] = req.table
        self._temps[slot] = req.temperature
        self._topks[slot] = req.top_k
        self._seeds[slot] = req.seed

    def _decode_step(self, running: List[Request]) -> None:
        if int(self.config.draft_len) > 0:
            self._verify_step(running)
            return
        t0 = time.perf_counter()
        toks = programs.decode(
            self.model, self.kv.caches, self.schedule, self._tokens,
            self._positions, self._active, self._tables, self._temps,
            self._topks, self._seeds)
        self._record_dequant(t0)
        now = self.clock()
        COUNTERS.add("serve.decode_steps", nbytes=len(running))
        for req in running:
            slot = req.slot
            tok = int(toks[slot])
            req.out.append(tok)
            req.token_times.append(now)
            req.cached_len += 1
            COUNTERS.add("serve.tokens")
            if self._is_finished(req, tok):
                self._finish(req)
                self._active[slot] = False
                self._tables[slot] = TRASH_BLOCK
            else:
                self._tokens[slot] = tok
                self._positions[slot] += 1

    def _record_dequant(self, t0: float) -> None:
        """`kv.dequant_ms` (µs in the bytes slot): the host time of a
        decode or verify dispatch against a quantized cache, to the
        sampled tokens on the host — the dequant is fused into the
        attention kernel, so the honest measurement is the whole
        dispatch; a dense-KV run of the same traffic isolates it."""
        if self.kv.quant_wire:
            COUNTERS.add("kv.dequant_ms",
                         nbytes=int((time.perf_counter() - t0) * 1e6))

    # -- speculative decoding -----------------------------------------

    def _propose_draft(self, req: Request) -> List[int]:
        """Self-speculative n-gram draft, on the host, no extra model:
        find the latest EARLIER occurrence of the request's last
        `spec_ngram` tokens in its own prompt + output and propose the
        continuation that followed it (else repeat the last token).
        Clamped so drafts never run past max_new_tokens or the request's
        allocated cache rows — verify writes candidate K/V at positions
        P+1..P+k, and each of those rows must be a real block."""
        c = self.config
        P = int(self._positions[req.slot])
        alloc_rows = len(self.kv.blocks_of(req.rid)) * self.kv.block_size
        k = min(int(c.draft_len),
                req.max_new_tokens - len(req.out) - 1,
                alloc_rows - 1 - P)
        if k <= 0:
            return []
        ctx = req.prompt + req.out
        n = min(int(c.spec_ngram), len(ctx))
        suffix = ctx[-n:]
        # prefer the latest earlier match whose continuation is a full k
        # tokens: once greedy output settles into a short cycle, the
        # nearest match sits one cycle before the tail and its
        # continuation is cut by the end of the context; an earlier match
        # carries the same cycle with k tokens of runway.  If every match
        # is cut, keep the longest continuation seen.
        best: List[int] = []
        for j in range(len(ctx) - n - 1, -1, -1):
            if ctx[j:j + n] == suffix:
                d = ctx[j + n:j + n + k]
                if len(d) >= k:
                    return [int(t) for t in d]
                if len(d) > len(best):
                    best = [int(t) for t in d]
        if best:
            return best
        return [int(ctx[-1])] * k

    def _verify_step(self, running: List[Request]) -> None:
        """One speculative step for every running slot: propose up to
        draft_len candidates, score all draft_len + 1 positions in one
        verify pass, accept the longest prefix on which the drafts match
        the target's own samples, and emit the target's sample after it
        as the bonus (all matched) or correction token.  Verify samples
        every position with the position-keyed rule of sequential decode,
        so the emitted stream is the non-speculative engine's token for
        token.  Rollback is a host-side rewind: rejected rows stay stale
        in the cache at positions at or past the rewound front, and are
        written again before any later query's mask reaches them."""
        R = self.config.max_batch
        k = int(self.config.draft_len)
        drafts = np.zeros((R, k), np.int64)
        n_draft = np.zeros((R,), np.int64)
        for req in running:
            d = self._propose_draft(req)
            n_draft[req.slot] = len(d)
            if d:
                drafts[req.slot, :len(d)] = d
                COUNTERS.add("serve.draft_tokens", calls=len(d))
        tokens = np.concatenate([self._tokens[:, None], drafts], axis=1)
        t0 = time.perf_counter()
        toks = programs.verify(
            self.model, self.kv.caches, self.schedule, tokens,
            self._positions, n_draft, self._active, self._tables,
            self._temps, self._topks, self._seeds)      # [R, draft_len + 1]
        self._record_dequant(t0)
        now = self.clock()
        COUNTERS.add("serve.decode_steps", nbytes=len(running))
        for req in running:
            slot = req.slot
            nd = int(n_draft[slot])
            # accept while draft i matches the target's sample for the
            # same position; the first sample past the matching prefix is
            # the bonus (m == nd) or the correction
            m = 0
            while m < nd and int(drafts[slot, m]) == int(toks[slot, m]):
                m += 1
            emitted = 0
            finished = False
            for i in range(m + 1):
                tok = int(toks[slot, i])
                req.out.append(tok)
                req.token_times.append(now)
                req.cached_len += 1
                emitted += 1
                COUNTERS.add("serve.tokens")
                if self._is_finished(req, tok):
                    finished = True
                    break
            if emitted > 1:
                # emitted - 1 draft tokens were accepted and used (the last
                # emitted token is always the target's own)
                COUNTERS.add("serve.accepted_tokens", calls=emitted - 1)
            if finished:
                self._finish(req)
                self._active[slot] = False
                self._tables[slot] = TRASH_BLOCK
            else:
                self._tokens[slot] = int(toks[slot, emitted - 1])
                self._positions[slot] += emitted

    def _is_finished(self, req: Request, last_tok: int) -> bool:
        if req.eos_token is not None and last_tok == req.eos_token:
            return True
        return len(req.out) >= req.max_new_tokens

    def _finish(self, req: Request) -> None:
        COUNTERS.add("serve.requests", nbytes=len(req.out))
        if req.session_id is not None and self.config.prefix_cache:
            self._pin_session(req)
        self.scheduler.finish(req, FINISHED)

    def close(self) -> None:
        for sid in list(self._sessions):
            self.release_session(sid)
