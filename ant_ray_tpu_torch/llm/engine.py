"""Continuous-batching LLM engine on the port's own PyTorch models
(counterpart of ant_ray_tpu/llm/engine.py, whose scheduler it copies).

* **Dense per-slot KV slabs** (models/llama.py `init_kv_cache`), updated
  in place.
* **Prompt ingestion** in one of two modes: bucketed prefill (lengths
  padded to powers of two; buckets of 128 and more run attention through
  the hand-written CUDA flash kernel) or **chunked prefill**
  (``prefill_chunk_tokens``): prompts ingested in fixed-size chunks,
  interleaved with decode steps at a ``decode_steps_per_chunk`` ratio.
* **Continuous batching**: each `step()` admits queued prompts, runs at
  most one prefill unit (a full bucketed prompt, or one chunk), then
  decodes every active slot in one batched call with an ``active`` mask.
* **Session KV offload** (``session_id=`` + kv_offload.py stores): a
  finished request's slab stays RESIDENT in its slot for multi-turn
  reuse; idle sessions are evicted — LRU past ``kv_idle_evict_s`` or on
  KV-full admission pressure — by copying the slab to host memory
  (pinned, from a CUDA cache; models/llama.py `extract_slot`) and
  putting it into a store, freeing the slot.  The next token for an
  offloaded session starts a background-thread fetch, which also pins a
  slab that comes back pageable (e.g. from a spill file); the step loop
  never waits for a fetch.  A landed slab is installed on the step
  thread with copies queued on the current stream
  (models/llama.py `install_slot`), ordered before the next decode
  without the host waiting.  Round trips are bitwise exact.
* **EngineLoop**: a background thread that owns the engine and steps
  it; requests are submitted from any thread and stream their tokens.

The reference's jitted device calls are plain calls here; everything
that writes the cache runs under ``torch.inference_mode()``.

Not in this port yet: the tracing plane (``trace_ctx``, ``llm:restore``
spans), the object-plane offload stores, publishing the loop's gauges and
tensor parallelism (``tensor_parallel_size`` / ``mesh``).  Passing any of
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.exceptions import BackPressureError, KVRestoreError
from ant_ray_tpu_torch.llm.kv_offload import LocalKvStore
from ant_ray_tpu_torch.llm.sampling import SamplingParams
from ant_ray_tpu_torch.llm.tokenizer import get_tokenizer
from ant_ray_tpu_torch.models import checkpoint as ckpt
from ant_ray_tpu_torch.models import llama

logger = logging.getLogger(__name__)


@dataclass
class RequestOutput:
    request_id: str
    prompt_token_ids: list
    token_ids: list = field(default_factory=list)
    text: str = ""
    finished: bool = False
    finish_reason: str | None = None
    error: str | None = None


@dataclass(eq=False)
class _Seq:
    request_id: str
    prompt: list
    sampling: SamplingParams
    generator: torch.Generator
    slot: int = -1
    generated: list = field(default_factory=list)
    session: Any = None           # _Session | None
    prefill_done: int = 0         # prompt tokens ingested (chunked mode)
    kv_len: int = 0               # slab tokens written for this slot
    last_tok: int | None = None   # device-fed token (resume after restore)
    on_event: Any = None          # callable(dict) | None — streaming sink


@dataclass(eq=False)
class _Session:
    """A logical conversation owning (at most) one KV slot over time."""

    session_id: str
    state: str = "new"            # new|resident|offloaded|restoring|failed
    slot: int = -1
    kv_len: int = 0               # tokens in the (resident or offloaded) slab
    carry: list = field(default_factory=list)  # final token, KV not written
    last_used: float = 0.0
    handle: Any = None            # offload store handle
    current: _Seq | None = None   # seq owning the slot right now
    paused: _Seq | None = None    # mid-generation seq parked by eviction
    pending: list = field(default_factory=list)  # seqs awaiting the slab


def _bucket(n: int, cap: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, cap)


def _not_in_port(what: str):
    return NotImplementedError(
        f"{what} is not ported to ant_ray_tpu_torch yet (see ROADMAP.md)")


_NOOP_TIMER = contextlib.nullcontext()


def _timer(prof, name: str):
    return prof.phase(name) if prof is not None else _NOOP_TIMER


class LLMEngine:
    """Synchronous engine core.

    ``model`` is a config name from models/llama.CONFIGS, a LOCAL
    CHECKPOINT DIRECTORY (HF Llama layout — real weights, loaded onto
    ``device`` by models/checkpoint.py), or a LlamaConfig; ``params`` (a
    dict of tensors, e.g. from models/convert.py) overrides both (random
    initialisation from ``seed`` remains the default for named configs).
    ``device=None`` is the current CUDA device; without one, and without
    ``device="cpu"``, construction raises.
    """

    def __init__(self, model="tiny", params=None, *, slots: int = 8,
                 max_seq: int | None = None, tokenizer=None,
                 seed: int = 0, device=None,
                 max_waiting: int | None = None,
                 prefill_chunk_tokens: int | None = None,
                 decode_steps_per_chunk: int = 1,
                 tensor_parallel_size: int = 1, mesh=None,
                 kv_idle_evict_s: float | None = None,
                 kv_offload_store=None, profiler=None):
        """``prefill_chunk_tokens``: enable chunked prefill with this fixed
        chunk width (None = bucketed prefill).
        ``decode_steps_per_chunk``: decode steps run between successive
        prefill chunks while both kinds of work are pending.
        ``max_waiting``: with every KV slot busy, at most this many
        requests may wait for one (None = unbounded).
        ``kv_idle_evict_s``: evict a session's slab after this many
        seconds idle (None disables the LRU sweep; admission pressure
        evicts regardless).
        ``kv_offload_store``: a kv_offload.py store; defaults to a
        LocalKvStore built lazily on first eviction.  ``profiler``:
        optional StepProfiler (observability/step_profiler.py) — each
        step() records prefill/decode/restore_install phases."""
        self.device = resolve_device(device)
        if tensor_parallel_size != 1 or mesh is not None:
            raise _not_in_port("tensor parallelism (tensor_parallel_size, "
                               "mesh)")
        if isinstance(model, str):
            # Explicit params: only the config is needed — don't read
            # gigabytes of weights to drop them.
            loaded, self.config, is_dir = ckpt.resolve_model(
                model, self.device, load=params is None)
            params = loaded if params is None else params
            if tokenizer is None and is_dir:
                tokenizer = get_tokenizer(model)  # checkpoint dir
        else:
            self.config = model
        self.max_seq = min(max_seq or self.config.max_seq,
                           self.config.max_seq)
        self.slots = slots
        self.tokenizer = tokenizer or get_tokenizer(None)
        self._seed = seed
        with torch.inference_mode():
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                params = llama.init_params(self.config, generator=gen,
                                           device=self.device)
            else:
                params = _to_device(params, self.device)
            self.params = params
            self.cache = llama.init_kv_cache(self.config, slots,
                                             self.max_seq,
                                             device=self.device)
        # Host-side mirror of each slot's most recent token: mutated in
        # numpy and uploaded once per decode call.
        self._last_np = np.zeros((slots,), np.int64)
        self._max_waiting = max_waiting
        self._free_slots = list(range(slots))
        self._active: dict[int, _Seq] = {}        # slot -> seq
        self._waiting: list[_Seq] = []
        self._finished: list[RequestOutput] = []
        self._req_counter = itertools.count()

        # ---- chunked prefill + session state
        self._chunk_tokens = prefill_chunk_tokens
        self._decode_per_chunk = max(1, int(decode_steps_per_chunk))
        self._decode_since_chunk = self._decode_per_chunk  # 1st chunk runs now
        self._prefilling: list[_Seq] = []         # chunked-mode ingest queue
        self._sessions: dict[str, _Session] = {}
        self._kv_idle_evict_s = kv_idle_evict_s
        self._kv_store = kv_offload_store
        self._restoring: dict[str, dict] = {}     # sid -> ticket
        self._chunk_rate: float | None = None     # tokens/s EWMA
        self._last_chunk_t: float | None = None
        self.profiler = profiler
        self.stats = {"tokens_generated": 0, "chunks": 0,
                      "chunk_tokens": 0, "offloads": 0,
                      "offload_bytes": 0, "restores": 0,
                      "restore_wait_s": 0.0, "restore_failures": 0,
                      "pressure_evictions": 0, "idle_evictions": 0}

    # ------------------------------------------------------------ public

    def add_request(self, prompt, sampling: SamplingParams | None = None,
                    request_id: str | None = None, *,
                    admit: bool = True, session_id: str | None = None,
                    on_event=None, trace_ctx=None) -> str:
        """prompt: str (tokenized here) or token-id list.

        With ``max_waiting`` configured and ``admit=True`` (the serving
        default), a request arriving while every KV slot is busy and the
        waiting line is full is REJECTED with
        :class:`~ant_ray_tpu_torch.exceptions.BackPressureError`.  Before
        shedding, an idle resident session is evicted to the offload
        store if one exists.  Offline batch
        paths (``generate``) pass ``admit=False``.

        ``session_id`` attaches the request to a persistent session: its
        KV slab survives the request (multi-turn reuse; continuations
        require chunked mode) and may be offloaded/restored.
        ``on_event`` streams per-token dicts to the caller (EngineLoop's
        sink).  ``trace_ctx`` must be None: the tracing plane is not
        ported.

        Each request draws its random numbers from its own
        ``torch.Generator``, seeded with ``sampling.seed`` or, without
        one, from the engine seed and the request id through CRC-32 —
        deterministic across processes, unlike the reference's
        ``hash(rid)``, which depends on PYTHONHASHSEED.  The bits differ
        from ``jax.random``'s, so only greedy output can match the
        reference token for token.  The generator rides the request, so
        an eviction mid-generation does not change its stream."""
        if trace_ctx is not None:
            raise _not_in_port("the tracing plane (trace_ctx)")
        if (admit and self._max_waiting is not None
                and not self._free_slots
                and len(self._waiting) >= self._max_waiting
                and not self._evict_for_pressure()):
            raise BackPressureError(
                f"engine at capacity: {self.slots} KV slots busy, "
                f"{len(self._waiting)} waiting (max_waiting="
                f"{self._max_waiting})",
                retry_after_s=self.retry_after_hint())
        sampling = sampling or SamplingParams()
        if isinstance(prompt, str):
            token_ids = self.tokenizer.encode(prompt)
        else:
            token_ids = [int(t) for t in prompt]
        if not token_ids:
            raise ValueError("empty prompt")
        # JAX clamps an out-of-range embedding gather; torch would raise
        # mid-step (a device-side assert on CUDA), so refuse it here.
        vocab = self.config.vocab_size
        if min(token_ids) < 0 or max(token_ids) >= vocab:
            raise ValueError(f"token ids must lie in [0, {vocab})")
        budget = max(1, self.max_seq - sampling.max_tokens)
        if len(token_ids) > budget:
            token_ids = token_ids[-budget:]      # keep the suffix
        rid = request_id or f"req-{next(self._req_counter)}"
        seed = (sampling.seed if sampling.seed is not None
                else zlib.crc32(f"{self._seed}:{rid}".encode()))
        gen = torch.Generator().manual_seed(seed)
        seq = _Seq(rid, token_ids, sampling, gen, on_event=on_event)
        if session_id is not None:
            sess = self._sessions.get(session_id)
            if sess is None or sess.state == "failed":
                sess = _Session(session_id)
                self._sessions[session_id] = sess
            elif self._chunk_tokens is None:
                # Any reuse, not just kv_len > 0: a continuation queued
                # while turn 1 is still in flight (kv_len still 0 here)
                # would otherwise reach _admit with a slab offset the
                # bucketed prefill cannot append at.
                raise ValueError(
                    "session continuation requires chunked prefill "
                    "(prefill_chunk_tokens=) — bucketed prefill cannot "
                    "append at a slab offset")
            seq.session = sess
        self._waiting.append(seq)
        return rid

    def has_unfinished(self) -> bool:
        return bool(self._waiting or self._active or self._prefilling
                    or self._restoring
                    or any(s.paused or s.pending
                           for s in self._sessions.values()))

    def step(self) -> list[RequestOutput]:
        """One engine iteration: land finished restores, admit prompts,
        run one prefill unit (bucketed prompt or one chunk), decode all
        active slots, sweep idle sessions.  Returns outputs finished
        since the last call."""
        with torch.inference_mode():
            prof = self.profiler
            if prof is not None:
                with prof.step():
                    self._step_inner(prof)
            else:
                self._step_inner(None)
        done, self._finished = self._finished, []
        return done

    def _step_inner(self, prof):
        self._poll_restores(prof)
        self._admit(prof)
        if self._chunk_tokens is not None:
            self._maybe_prefill_chunk(prof)
        self._decode(prof)
        self._sweep_idle()

    def generate(self, prompts, sampling: SamplingParams | None = None,
                 ) -> list[RequestOutput]:
        """Run a batch of prompts to completion (offline inference)."""
        order = [self.add_request(p, sampling, admit=False)
                 for p in prompts]
        outputs: dict[str, RequestOutput] = {}
        while self.has_unfinished():
            for out in self.step():
                outputs[out.request_id] = out
        return [outputs[rid] for rid in order]

    def stream(self, prompt, sampling: SamplingParams | None = None):
        """Incremental generation for one request: yields a dict per new
        token ({"token_id", "text", "finished": False}) and a final
        summary chunk ({"finished": True, "finish_reason", "token_ids",
        "full_text"})."""
        rid = self.add_request(prompt, sampling)
        seq = self._waiting[-1]
        assert seq.request_id == rid
        emitted = 0
        final: RequestOutput | None = None
        while final is None and self.has_unfinished():
            for out in self.step():
                if out.request_id == rid:
                    final = out
            source = final.token_ids if final else seq.generated
            while emitted < len(source):
                tok = int(source[emitted])
                emitted += 1
                yield {"token_id": tok,
                       "text": self.tokenizer.decode([tok]),
                       "finished": False,
                       "finish_reason": None}
        yield {"token_id": None,
               "text": "",
               "finished": True,
               "finish_reason": (final.finish_reason if final
                                 else "length"),
               "token_ids": list(final.token_ids) if final else [],
               "full_text": final.text if final else ""}

    # -------------------------------------------------- sessions public

    def resident_sessions(self) -> int:
        """Live sessions the engine is holding KV state for — resident,
        offloaded, or mid-restore.  Exceeds ``slots`` exactly when
        offload is doing its job."""
        return sum(1 for s in self._sessions.values()
                   if s.state in ("resident", "offloaded", "restoring"))

    def queue_depth(self) -> int:
        """Requests admitted but not yet generating: waiting for a slot,
        mid-prefill, or parked behind a session restore."""
        return (len(self._waiting) + len(self._prefilling)
                + sum(len(s.pending) + (1 if s.paused else 0)
                      for s in self._sessions.values()))

    def chunk_drain_rate(self) -> float | None:
        """Measured prefill-chunk throughput (tokens/s EWMA), the basis
        for KV-full retry hints.  None until the first two chunks."""
        return self._chunk_rate

    def retry_after_hint(self) -> float:
        """BackPressure retry hint: outstanding prompt tokens over the
        measured chunk-drain rate (fallback: 0.5 s)."""
        rate = self._chunk_rate
        if not rate or rate <= 0:
            return 0.5
        outstanding = sum(max(0, len(s.prompt) - s.prefill_done)
                          for s in self._prefilling)
        outstanding += sum(len(s.prompt) for s in self._waiting)
        outstanding += self._chunk_tokens or 0   # the admitted request
        return min(30.0, max(0.05, outstanding / rate + 0.02))

    def evict_session(self, session_id: str, *, force: bool = False
                      ) -> bool:
        """Offload one session's slab now.  Idle sessions always
        qualify; ``force=True`` additionally pauses a mid-GENERATION
        session (its request resumes after an automatic restore —
        bit-identically, since the slab round trip is exact).  Sessions
        mid-prefill are never evictable.  Returns True if evicted."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.state != "resident" or sess.slot < 0:
            return False
        cur = sess.current
        if cur is not None:
            if not force or cur in self._prefilling:
                return False
            self._active.pop(cur.slot, None)
            cur.slot = -1
            sess.paused = cur
            sess.current = None
        self._offload(sess)
        return True

    def end_session(self, session_id: str) -> bool:
        """Drop a session: frees its slot (if resident) and deletes its
        offloaded slab (if any).  In-flight work is not interrupted —
        call only for idle sessions."""
        sess = self._sessions.pop(session_id, None)
        if sess is None:
            return False
        if sess.slot >= 0 and sess.current is None:
            self._free_slots.append(sess.slot)
            sess.slot = -1
        if sess.handle is not None and self._kv_store is not None:
            try:
                self._kv_store.delete(sess.handle)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                logger.exception("deleting the slab of session %r failed",
                                 session_id)
        return True

    def has_evictable(self) -> bool:
        """True if admission pressure could free a slot by evicting an
        idle resident session (the submit-side gate's cheap probe)."""
        return any(s.state == "resident" and s.slot >= 0
                   and s.current is None and s.paused is None
                   for s in self._sessions.values())

    # ---------------------------------------------------- step phases

    def _admit(self, prof=None):
        """Route waiting requests: park session continuations behind
        restores, assign free (or pressure-evicted) slots, and in
        bucketed mode run at most one full prefill per step — the
        budget covers BOTH the resident-idle-session branch and the
        fresh-slot branch."""
        # Sessions parked with work but offloaded: ensure a restore is
        # in flight (covers forced mid-generation eviction).
        for sess in self._sessions.values():
            if sess.state == "offloaded" and (sess.paused or sess.pending):
                self._start_restore(sess)
        admitted_prefill = False
        i = 0
        while i < len(self._waiting):
            seq = self._waiting[i]
            sess = seq.session
            if sess is not None and sess.state in ("offloaded",
                                                   "restoring"):
                self._waiting.pop(i)
                sess.pending.append(seq)
                if sess.state == "offloaded":
                    self._start_restore(sess)
                continue
            if sess is not None and sess.slot >= 0 and (
                    sess.current is not None or sess.paused is not None):
                self._waiting.pop(i)          # session busy: park
                sess.pending.append(seq)
                continue
            if sess is not None and sess.slot >= 0:
                if self._chunk_tokens is None and admitted_prefill:
                    break                     # bucketed: ≤1 prefill/step
                self._waiting.pop(i)          # resident idle: append
                self._begin_ingest(seq, sess.slot, sess.kv_len, prof)
                admitted_prefill = True
                continue
            if not self._free_slots and not self._evict_for_pressure():
                i += 1
                continue
            if self._chunk_tokens is None and admitted_prefill:
                break                         # bucketed: ≤1 prefill/step
            slot = self._free_slots.pop()
            self._waiting.pop(i)
            if sess is not None:
                sess.slot = slot
                sess.state = "resident"
            self._begin_ingest(seq, slot, sess.kv_len if sess else 0,
                               prof)
            admitted_prefill = True

    def _begin_ingest(self, seq: _Seq, slot: int, start: int, prof=None):
        sess = seq.session
        if self._chunk_tokens is None and start != 0:
            # add_request rejects bucketed session continuations, so
            # this is a backstop: fail the one seq typed (the session
            # keeps its resident slot, idle) — raising mid-step would
            # leave the seq in no queue and wedge its caller's wait().
            self._fail_seq(seq, ValueError(
                "bucketed prefill cannot continue a session at offset "
                f"{start}; configure prefill_chunk_tokens"))
            return
        if sess is not None:
            sess.current = seq
            sess.last_used = time.monotonic()
            if sess.carry:
                seq.prompt = sess.carry + seq.prompt
                sess.carry = []
        seq.slot = slot
        seq.kv_len = start
        if self._chunk_tokens is not None:
            self._prefilling.append(seq)
            return
        bucket = _bucket(len(seq.prompt), self.max_seq)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(seq.prompt)] = seq.prompt
        with _timer(prof, "prefill"):
            last_logits, self.cache = llama.prefill_into_cache(
                self.params, torch.from_numpy(padded).to(self.device),
                self.cache, slot, len(seq.prompt), self.config)
        seq.kv_len = len(seq.prompt)
        tok = int(self._sample_one(seq, last_logits))
        self._after_token(seq, tok)
        if seq.slot >= 0:
            seq.last_tok = tok
            self._last_np[slot] = tok
            self._active[slot] = seq

    def _maybe_prefill_chunk(self, prof=None):
        """Run ONE chunk of ONE pending prompt — but only once
        ``decode_steps_per_chunk`` decode steps have run since the last
        chunk.  Selection is shortest-remaining-prompt-first (FIFO
        tiebreak)."""
        if not self._prefilling:
            return
        if self._active and \
                self._decode_since_chunk < self._decode_per_chunk:
            return
        idx = min(range(len(self._prefilling)),
                  key=lambda i: (len(self._prefilling[i].prompt)
                                 - self._prefilling[i].prefill_done, i))
        seq = self._prefilling.pop(idx)
        chunk = self._chunk_tokens
        part = seq.prompt[seq.prefill_done:seq.prefill_done + chunk]
        buf = np.zeros((chunk,), np.int64)
        buf[:len(part)] = part
        with _timer(prof, "prefill"):
            logits, self.cache = llama.prefill_chunk_into_cache(
                self.params, torch.from_numpy(buf).to(self.device),
                self.cache, seq.slot, seq.kv_len, len(part), self.config)
        seq.prefill_done += len(part)
        seq.kv_len += len(part)
        self._note_chunk(len(part))
        self._decode_since_chunk = 0
        if seq.prefill_done < len(seq.prompt):
            self._prefilling.append(seq)
            return
        tok = int(self._sample_one(seq, logits))
        self._after_token(seq, tok)
        if seq.slot >= 0:
            seq.last_tok = tok
            self._last_np[seq.slot] = tok
            self._active[seq.slot] = seq

    def _decode(self, prof=None):
        if not self._active:
            return
        mask = np.zeros((self.slots,), bool)
        mask[list(self._active)] = True
        with _timer(prof, "decode"):
            logits, self.cache = llama.decode_step(
                self.params, torch.from_numpy(self._last_np).to(self.device),
                self.cache, self.config,
                active=torch.from_numpy(mask).to(self.device))
            toks = self._sample_all(logits).cpu().numpy()
        self._decode_since_chunk += 1
        for slot, seq in list(self._active.items()):
            # this call wrote seq.last_tok's K/V at position kv_len
            seq.kv_len = min(seq.kv_len + 1, self.max_seq)
            tok = int(toks[slot])
            self.stats["tokens_generated"] += 1
            self._after_token(seq, tok)
            if seq.slot >= 0:
                seq.last_tok = tok
                self._last_np[slot] = tok

    def _note_chunk(self, n: int):
        self.stats["chunks"] += 1
        self.stats["chunk_tokens"] += n
        now = time.monotonic()
        if self._last_chunk_t is not None:
            dt = max(now - self._last_chunk_t, 1e-6)
            inst = n / dt
            self._chunk_rate = (inst if self._chunk_rate is None
                                else 0.8 * self._chunk_rate + 0.2 * inst)
        self._last_chunk_t = now

    # ------------------------------------------------- offload/restore

    def _store(self):
        if self._kv_store is None:
            self._kv_store = LocalKvStore()
        return self._kv_store

    def _evict_for_pressure(self) -> bool:
        """Free one slot by offloading the least-recently-used IDLE
        resident session.  Admission pressure spills cold state instead
        of shedding new work."""
        idle = [s for s in self._sessions.values()
                if s.state == "resident" and s.slot >= 0
                and s.current is None and s.paused is None]
        if not idle:
            return False
        victim = min(idle, key=lambda s: s.last_used)
        self._offload(victim)
        self.stats["pressure_evictions"] += 1
        return True

    def _sweep_idle(self):
        if self._kv_idle_evict_s is None:
            return
        cutoff = time.monotonic() - self._kv_idle_evict_s
        for sess in list(self._sessions.values()):
            if (sess.state == "resident" and sess.slot >= 0
                    and sess.current is None and sess.paused is None
                    and sess.last_used < cutoff):
                self._offload(sess)
                self.stats["idle_evictions"] += 1

    def _offload(self, sess: _Session):
        """Copy the session's slab to host memory and put it into the
        offload store; the slot returns to the free pool once the bytes
        are on the host.  The slab is NOT zeroed — stale bytes past a
        future occupant's length are masked exactly like reused slots
        always were."""
        slot = sess.slot
        k, v, ln = llama.extract_slot(self.cache, slot)
        sess.handle = self._store().put(sess.session_id, (k, v, ln))
        sess.kv_len = ln
        sess.slot = -1
        sess.state = "offloaded"
        self._free_slots.append(slot)
        self.stats["offloads"] += 1
        self.stats["offload_bytes"] += k.nbytes + v.nbytes

    def _start_restore(self, sess: _Session):
        if sess.state != "offloaded":
            return
        sess.state = "restoring"
        ticket = {"done": False, "result": None, "error": None,
                  "t0": time.monotonic()}
        self._restoring[sess.session_id] = ticket
        store, handle = self._store(), sess.handle
        pin = self.device.type == "cuda"

        def fetch():
            try:
                k, v, ln = store.get(handle)
                if pin:
                    # Pinned here, off the step thread: an install from
                    # pageable memory would block the host for the whole
                    # transfer.
                    k = k if k.is_pinned() else k.pin_memory()
                    v = v if v.is_pinned() else v.pin_memory()
                ticket["result"] = (k, v, ln)
            except Exception as exc:  # noqa: BLE001 — typed on the step thread
                ticket["error"] = exc
            finally:
                ticket["done"] = True

        threading.Thread(target=fetch, daemon=True,
                         name=f"kv-restore-{sess.session_id}").start()

    def _poll_restores(self, prof=None):
        """Land finished restore fetches: install the slab into a free
        (or pressure-evicted) slot and resume the session's work.  Never
        blocks — unfinished fetches stay in flight while decode
        proceeds; a landed fetch with no slot available retries next
        step."""
        if not self._restoring:
            return
        for sid, ticket in list(self._restoring.items()):
            if not ticket["done"]:
                continue
            sess = self._sessions.get(sid)
            if sess is None:
                del self._restoring[sid]
                continue
            if ticket["error"] is not None:
                del self._restoring[sid]
                self._fail_session(sess, ticket["error"])
                continue
            if not self._free_slots and not self._evict_for_pressure():
                continue                     # retry next step
            slot = self._free_slots.pop()
            del self._restoring[sid]
            k, v, ln = ticket["result"]
            with _timer(prof, "restore_install"):
                self.cache = llama.install_slot(self.cache, k, v, ln, slot)
            self.stats["restores"] += 1
            self.stats["restore_wait_s"] += time.monotonic() - ticket["t0"]
            sess.slot = slot
            sess.state = "resident"
            sess.kv_len = int(ln)
            sess.last_used = time.monotonic()
            if sess.paused is not None:
                seq = sess.paused
                sess.paused = None
                sess.current = seq
                seq.slot = slot
                self._last_np[slot] = seq.last_tok
                self._active[slot] = seq
            elif sess.pending:
                self._begin_ingest(sess.pending.pop(0), slot,
                                   sess.kv_len, prof)

    def _fail_session(self, sess: _Session, exc):
        """A restore failed (e.g. the slab is gone from the store): fail
        THIS session's requests typed and reset the session record;
        every other slot keeps decoding — the loop never wedges."""
        self.stats["restore_failures"] += 1
        err = KVRestoreError(
            f"session {sess.session_id!r}: KV restore failed: {exc!r}",
            session_id=sess.session_id)
        seqs = ([sess.paused] if sess.paused else []) + sess.pending
        sess.paused = None
        sess.pending = []
        sess.state = "failed"
        sess.handle = None
        sess.kv_len = 0
        for seq in seqs:
            self._fail_seq(seq, err)

    def _fail_seq(self, seq: _Seq, err):
        out = RequestOutput(
            request_id=seq.request_id, prompt_token_ids=seq.prompt,
            token_ids=list(seq.generated),
            text=self.tokenizer.decode(seq.generated),
            finished=True, finish_reason="error", error=str(err))
        self._finished.append(out)
        if seq.on_event is not None:
            seq.on_event({"type": "error", "error": err, "output": out})

    # ----------------------------------------------------------- private

    def _after_token(self, seq: _Seq, tok: int):
        seq.generated.append(tok)
        s = seq.sampling
        eos = getattr(self.tokenizer, "eos_id",
                      getattr(self.tokenizer, "eos_token_id", None))
        stop = set(s.stop_token_ids)
        if eos is not None:
            stop.add(int(eos))
        reason = None
        if tok in stop:
            reason = "stop"
        elif len(seq.generated) >= s.max_tokens:
            reason = "length"
        elif seq.kv_len + 1 >= self.max_seq:
            reason = "length"
        if seq.on_event is not None and reason != "stop":
            seq.on_event({"type": "token", "token_id": tok})
        if reason is not None:
            self._release(seq, reason)

    def _release(self, seq: _Seq, reason: str):
        out_ids = (seq.generated[:-1] if reason == "stop"
                   else seq.generated)
        out = RequestOutput(
            request_id=seq.request_id,
            prompt_token_ids=seq.prompt,
            token_ids=list(out_ids),
            text=self.tokenizer.decode(out_ids),
            finished=True,
            finish_reason=reason,
        )
        self._finished.append(out)
        sess = seq.session
        if seq.slot >= 0:
            self._active.pop(seq.slot, None)
            if sess is None:
                self._free_slots.append(seq.slot)
            else:
                # Slot stays with the session (multi-turn KV reuse).
                # The final token's K/V was never written — carry it
                # into the next turn's ingest.
                sess.kv_len = seq.kv_len
                sess.carry = list(seq.generated[-1:])
                sess.current = None
                sess.last_used = time.monotonic()
            seq.slot = -1
        elif sess is not None and sess.current is seq:
            sess.current = None
            sess.last_used = time.monotonic()
        if sess is not None and sess.pending and sess.slot >= 0 \
                and sess.current is None and sess.paused is None:
            # Next turn already queued: put it at the head of the line.
            self._waiting.insert(0, sess.pending.pop(0))
        if seq.on_event is not None:
            seq.on_event({"type": "final", "output": out})

    def _uniform(self, seq: _Seq) -> float:
        return float(torch.rand((), generator=seq.generator,
                                dtype=torch.float64))

    def _sample_one(self, seq: _Seq, logits):
        s = seq.sampling
        return self._sample_batch(
            logits[None], np.asarray([self._uniform(seq)]),
            np.asarray([s.temperature], np.float32),
            np.asarray([s.top_k], np.int64),
            np.asarray([s.top_p], np.float32))[0]

    def _sample_all(self, logits):
        uniforms = np.zeros((self.slots,), np.float64)
        temps = np.zeros((self.slots,), np.float32)
        top_ks = np.zeros((self.slots,), np.int64)
        top_ps = np.ones((self.slots,), np.float32)
        for slot, seq in self._active.items():
            s = seq.sampling
            temps[slot] = s.temperature
            top_ks[slot] = s.top_k
            top_ps[slot] = s.top_p
            uniforms[slot] = self._uniform(seq)
        return self._sample_batch(logits, uniforms, temps, top_ks, top_ps)

    def _sample_batch(self, logits, uniforms, temps, top_ks, top_ps):
        """Per-row sampling: greedy when temperature == 0, else
        temperature softmax with optional top-k / top-p (nucleus)
        filtering, as in the reference.  A row draws by inverting the
        CDF of its filtered distribution at its request's uniform, so
        one number from the request's generator decides the token.
        Host-side arguments are numpy arrays of one entry per row."""
        greedy = torch.argmax(logits, dim=-1)
        if not (temps > 0).any():
            return greedy
        dev = logits.device
        vocab = logits.shape[-1]
        temps_t = torch.from_numpy(temps).to(dev)
        top_ks_t = torch.from_numpy(top_ks).to(dev)
        top_ps_t = torch.from_numpy(top_ps).to(dev)
        scaled = logits / torch.clamp(temps_t[:, None], min=1e-6)
        # top-k: mask everything below the k-th largest (k==0 → keep all)
        sorted_desc, order = torch.sort(scaled, dim=-1, descending=True,
                                        stable=True)
        k_idx = torch.clamp(top_ks_t - 1, 0, vocab - 1)
        kth = torch.gather(sorted_desc, 1, k_idx[:, None])
        keep_k = (top_ks_t[:, None] <= 0) | (scaled >= kth)
        # top-p: smallest prefix of the sorted distribution with
        # cumulative prob >= p
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        cutoff_rank = torch.sum(cum < top_ps_t[:, None], dim=-1)  # inclusive
        ranks = torch.empty_like(order).scatter_(
            1, order, torch.arange(vocab, device=dev).expand_as(order))
        keep_p = ranks <= cutoff_rank[:, None]
        masked = torch.where(keep_k & keep_p, scaled,
                             torch.full_like(scaled, float("-inf")))
        probs = torch.softmax(masked, dim=-1)
        cdf = torch.cumsum(probs, dim=-1)
        target = (torch.from_numpy(uniforms).to(dev).to(cdf.dtype)
                  * cdf[:, -1])
        sampled = torch.searchsorted(cdf, target[:, None], right=True)[:, 0]
        # Rounding can put the target at the CDF's very top: never step
        # past the last token with non-zero probability.
        last = vocab - 1 - torch.argmax(
            torch.flip(probs > 0, dims=[-1]).to(torch.int8), dim=-1)
        sampled = torch.minimum(sampled, last)
        return torch.where(temps_t > 0, sampled, greedy)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {name: _to_device(leaf, device) for name, leaf in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------- loop

_IDLE_SLEEP_S = 0.01      # the loop's longest nap with nothing to step
_OP = object()            # inbox marker of a loop-thread op

class _LoopHandle:
    """Per-request handle returned by :meth:`EngineLoop.submit`: an
    event queue for streaming plus a wait() for the final output."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.events = queue.Queue()
        self.submit_ts = time.monotonic()
        self.first_token_ts: float | None = None
        self._final: RequestOutput | None = None
        self._error: BaseException | None = None
        self._done = threading.Event()

    # engine-loop side ------------------------------------------------
    def _on_event(self, ev: dict):
        if ev["type"] == "token" and self.first_token_ts is None:
            self.first_token_ts = time.monotonic()
        if ev["type"] == "final":
            self._final = ev["output"]
        elif ev["type"] == "error":
            self._error = ev["error"]
            self._final = ev.get("output")
        self.events.put(ev)
        if ev["type"] in ("final", "error"):
            self._done.set()

    def _fail(self, exc: BaseException):
        self._on_event({"type": "error", "error": exc, "output": None})

    # caller side -----------------------------------------------------
    def wait(self, timeout: float | None = None) -> RequestOutput:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._final

    def ttft_s(self) -> float | None:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    def __iter__(self):
        """Yield events until (and including) the final/error event."""
        while True:
            ev = self.events.get()
            yield ev
            if ev["type"] in ("final", "error"):
                return


class EngineLoop:
    """Background stepper that OWNS an engine: requests are submitted
    from any thread; one loop thread interleaves chunked prefill,
    decode, and restore landing, and streams tokens to per-request
    sinks, so concurrent requests share steps instead of serializing
    whole generations.

    :meth:`stats` / :meth:`load_signals` give the serve-autoscaling load
    signals under the reference's gauge names (``art_llm_tokens_per_s``,
    ``art_llm_queue_depth``, ``art_llm_resident_sessions``); publishing
    them as gauges waits for the runtime (ROADMAP.md)."""

    METRIC_NAMES = ("art_llm_tokens_per_s", "art_llm_queue_depth",
                    "art_llm_resident_sessions")

    def __init__(self, engine: LLMEngine, *,
                 max_waiting: int | None = None,
                 metrics_interval_s: float = 2.0):
        self._engine = engine
        self._max_waiting = (max_waiting if max_waiting is not None
                             else engine._max_waiting)
        self._metrics_interval = metrics_interval_s
        self._inbox: list = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._tokens_per_s = 0.0
        self._last_tick = time.monotonic()
        self._last_tokens = 0
        self._snapshot = self._loop_snapshot(engine)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="llm-engine-loop")
        self._thread.start()

    # ------------------------------------------------------- submission

    def submit(self, prompt, sampling: SamplingParams | None = None, *,
               session_id: str | None = None,
               request_id: str | None = None,
               trace_ctx=None) -> _LoopHandle:
        """Admission-gate and enqueue one request; returns its handle.

        Sheds typed BackPressureError when the engine is KV-full (no
        free slot, nothing evictable) and the waiting line is at
        ``max_waiting`` — with the retry hint derived from the measured
        chunk-drain rate.  ``trace_ctx`` must be None (not ported)."""
        if trace_ctx is not None:
            raise _not_in_port("the tracing plane (trace_ctx)")
        eng = self._engine
        if self._max_waiting is not None:
            with self._lock:
                inbox_n = len(self._inbox)
            # Requests waiting for a SLOT (mid-prefill seqs hold theirs
            # already and don't count against the line).  List len()
            # reads are GIL-atomic, so _waiting/_free_slots stay live;
            # the SESSION-map walks (parked count, evictability) come
            # from the loop-published snapshot — iterating _sessions
            # from this thread could blow up mid-resize.  Snapshot
            # staleness costs at most a spurious/missed 429 for one
            # request, never corruption.
            snap = self._snapshot
            waiting = inbox_n + len(eng._waiting) + snap["parked"]
            if (waiting >= self._max_waiting and not eng._free_slots
                    and not snap["evictable"]):
                raise BackPressureError(
                    f"llm engine at capacity: {eng.slots} KV slots "
                    f"busy, {waiting} waiting (max_waiting="
                    f"{self._max_waiting})",
                    retry_after_s=eng.retry_after_hint())
        rid = request_id or f"req-{next(eng._req_counter)}"
        handle = _LoopHandle(rid)
        with self._lock:
            self._inbox.append((prompt, sampling, rid, session_id, handle))
        self._wake.set()
        return handle

    def _call_on_loop(self, fn, timeout: float = 30.0):
        """Run ``fn(engine)`` on the loop thread and return its result
        (None on timeout).  Every mutation of the engine's session /
        slot maps must go through here — the loop thread owns them."""
        done = threading.Event()
        res = {}

        def op(eng):
            try:
                res["val"] = fn(eng)
            finally:
                done.set()

        with self._lock:
            self._inbox.append((_OP, op, None, None, None))
        self._wake.set()
        done.wait(timeout)
        return res.get("val")

    def evict_session(self, session_id: str, *, force: bool = False
                      ) -> bool:
        """Thread-safe wrapper: the eviction runs on the loop thread."""
        return bool(self._call_on_loop(
            lambda eng: eng.evict_session(session_id, force=force)))

    def end_session(self, session_id: str) -> bool:
        """Thread-safe wrapper: the teardown runs on the loop thread —
        end_session frees slots and drops session records, which would
        race the stepper if called from a request thread."""
        return bool(self._call_on_loop(
            lambda eng: eng.end_session(session_id)))

    # ---------------------------------------------------------- signals

    @staticmethod
    def _loop_snapshot(eng: LLMEngine) -> dict:
        """Admission/load counters as one fresh dict, published by the
        loop thread each iteration: submit() and stats() read THIS
        instead of walking the live engine structures (which the loop
        mutates concurrently — cross-thread iteration can blow up
        mid-resize).  At worst one step stale: a bounded gauge blip."""
        return {
            "parked": sum(len(s.pending) + (1 if s.paused else 0)
                          for s in eng._sessions.values()),
            "evictable": eng.has_evictable(),
            "queue_depth": eng.queue_depth(),
            "resident_sessions": eng.resident_sessions(),
        }

    def stats(self) -> dict:
        snap = self._snapshot
        return {
            "art_llm_tokens_per_s": self._tokens_per_s,
            "art_llm_queue_depth": float(snap["queue_depth"]),
            "art_llm_resident_sessions":
                float(snap["resident_sessions"]),
        }

    load_signals = stats

    def shutdown(self, timeout: float = 5.0):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout)

    # ------------------------------------------------------------- loop

    def _drain_inbox(self, eng):
        with self._lock:
            items, self._inbox = self._inbox, []
        for prompt, sampling, rid, session_id, handle in items:
            if prompt is _OP:
                sampling(eng)             # an injected loop-thread op
                continue
            try:
                eng.add_request(prompt, sampling, rid, admit=False,
                                session_id=session_id,
                                on_event=handle._on_event)
            except Exception as exc:  # noqa: BLE001 — typed to caller
                handle._fail(exc)

    def _run(self):
        eng = self._engine
        while not self._stop:
            self._drain_inbox(eng)
            if eng.has_unfinished():
                try:
                    eng.step()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    logger.exception("llm engine step failed")
                    time.sleep(0.05)
            else:
                self._wake.wait(_IDLE_SLEEP_S)
                self._wake.clear()
            self._snapshot = self._loop_snapshot(eng)
            now = time.monotonic()
            if now - self._last_tick >= self._metrics_interval:
                self._tick_metrics(eng, now)

    def _tick_metrics(self, eng, now: float):
        tokens = eng.stats["tokens_generated"]
        dt = max(now - self._last_tick, 1e-6)
        self._tokens_per_s = (tokens - self._last_tokens) / dt
        self._last_tokens = tokens
        self._last_tick = now
