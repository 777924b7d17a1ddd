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

The reference's six jitted device calls are plain calls here; everything
runs under ``torch.inference_mode()``.

Not in this port yet: sessions (``session_id``, KV offload and restore),
``EngineLoop``, the ``profiler`` hook, tensor parallelism
(``tensor_parallel_size`` / ``mesh``) and loading a checkpoint
directory.  Passing any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.exceptions import BackPressureError
from ant_ray_tpu_torch.llm.sampling import SamplingParams
from ant_ray_tpu_torch.llm.tokenizer import get_tokenizer
from ant_ray_tpu_torch.models import llama


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
    prefill_done: int = 0         # prompt tokens ingested (chunked mode)
    kv_len: int = 0               # slab tokens written for this slot


def _bucket(n: int, cap: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, cap)


def _not_in_port(what: str):
    return NotImplementedError(
        f"{what} is not ported to ant_ray_tpu_torch yet (see ROADMAP.md)")


class LLMEngine:
    """Synchronous engine core.

    ``model`` is a config name from models/llama.CONFIGS or a
    LlamaConfig; ``params`` (a dict of tensors, e.g. from
    models/convert.py) overrides the random initialisation made from
    ``seed`` on ``device``.  ``device=None`` is the current CUDA device;
    without one, and without ``device="cpu"``, construction raises.
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
        requests may wait for one (None = unbounded)."""
        self.device = resolve_device(device)
        if tensor_parallel_size != 1 or mesh is not None:
            raise _not_in_port("tensor parallelism (tensor_parallel_size, "
                               "mesh)")
        if kv_idle_evict_s is not None or kv_offload_store is not None:
            raise _not_in_port("session KV offload")
        if profiler is not None:
            raise _not_in_port("the step profiler hook")
        if isinstance(model, str):
            if model not in llama.CONFIGS:
                raise _not_in_port(f"loading a checkpoint ({model!r} is not "
                                   f"one of {sorted(llama.CONFIGS)})")
            self.config = llama.CONFIGS[model]
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

        # ---- chunked prefill
        self._chunk_tokens = prefill_chunk_tokens
        self._decode_per_chunk = max(1, int(decode_steps_per_chunk))
        self._decode_since_chunk = self._decode_per_chunk  # 1st chunk runs now
        self._prefilling: list[_Seq] = []         # chunked-mode ingest queue
        self._chunk_rate: float | None = None     # tokens/s EWMA
        self._last_chunk_t: float | None = None
        self.stats = {"tokens_generated": 0, "chunks": 0,
                      "chunk_tokens": 0}

    # ------------------------------------------------------------ public

    def add_request(self, prompt, sampling: SamplingParams | None = None,
                    request_id: str | None = None, *,
                    admit: bool = True, session_id: str | None = None
                    ) -> str:
        """prompt: str (tokenized here) or token-id list.

        With ``max_waiting`` configured and ``admit=True`` (the serving
        default), a request arriving while every KV slot is busy and the
        waiting line is full is REJECTED with
        :class:`~ant_ray_tpu_torch.exceptions.BackPressureError`.  Offline
        batch paths (``generate``) pass ``admit=False``.

        Each request draws its random numbers from its own
        ``torch.Generator``, seeded with ``sampling.seed`` or, without
        one, from the engine seed and the request id through CRC-32 —
        deterministic across processes, unlike the reference's
        ``hash(rid)``, which depends on PYTHONHASHSEED.  The bits differ
        from ``jax.random``'s, so only greedy output can match the
        reference token for token."""
        if session_id is not None:
            raise _not_in_port("sessions (session_id)")
        if (admit and self._max_waiting is not None
                and not self._free_slots
                and len(self._waiting) >= self._max_waiting):
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
        self._waiting.append(_Seq(rid, token_ids, sampling, gen))
        return rid

    def has_unfinished(self) -> bool:
        return bool(self._waiting or self._active or self._prefilling)

    def step(self) -> list[RequestOutput]:
        """One engine iteration: admit prompts, run one prefill unit
        (bucketed prompt or one chunk), decode all active slots.  Returns
        outputs finished since the last call."""
        with torch.inference_mode():
            self._admit()
            if self._chunk_tokens is not None:
                self._maybe_prefill_chunk()
            self._decode()
        done, self._finished = self._finished, []
        return done

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

    # ---------------------------------------------------- step phases

    def _admit(self):
        """Assign free slots to waiting requests; in bucketed mode run at
        most one full prefill per step."""
        admitted_prefill = False
        while self._waiting and self._free_slots:
            if self._chunk_tokens is None and admitted_prefill:
                break                         # bucketed: ≤1 prefill/step
            slot = self._free_slots.pop()
            self._begin_ingest(self._waiting.pop(0), slot)
            admitted_prefill = True

    def _begin_ingest(self, seq: _Seq, slot: int):
        seq.slot = slot
        seq.kv_len = 0
        if self._chunk_tokens is not None:
            self._prefilling.append(seq)
            return
        bucket = _bucket(len(seq.prompt), self.max_seq)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(seq.prompt)] = seq.prompt
        last_logits, self.cache = llama.prefill_into_cache(
            self.params, torch.from_numpy(padded).to(self.device),
            self.cache, slot, len(seq.prompt), self.config)
        seq.kv_len = len(seq.prompt)
        tok = int(self._sample_one(seq, last_logits))
        self._after_token(seq, tok)
        if seq.slot >= 0:
            self._last_np[slot] = tok
            self._active[slot] = seq

    def _maybe_prefill_chunk(self):
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
        logits, self.cache = llama.prefill_chunk_into_cache(
            self.params, torch.from_numpy(buf).to(self.device), self.cache,
            seq.slot, seq.kv_len, len(part), self.config)
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
            self._last_np[seq.slot] = tok
            self._active[seq.slot] = seq

    def _decode(self):
        if not self._active:
            return
        mask = np.zeros((self.slots,), bool)
        mask[list(self._active)] = True
        logits, self.cache = llama.decode_step(
            self.params, torch.from_numpy(self._last_np).to(self.device),
            self.cache, self.config,
            active=torch.from_numpy(mask).to(self.device))
        toks = self._sample_all(logits).cpu().numpy()
        self._decode_since_chunk += 1
        for slot, seq in list(self._active.items()):
            # this call wrote the slot's last token's K/V at kv_len
            seq.kv_len = min(seq.kv_len + 1, self.max_seq)
            tok = int(toks[slot])
            self.stats["tokens_generated"] += 1
            self._after_token(seq, tok)
            if seq.slot >= 0:
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
        if reason is not None:
            self._release(seq, reason)

    def _release(self, seq: _Seq, reason: str):
        out_ids = (seq.generated[:-1] if reason == "stop"
                   else seq.generated)
        self._finished.append(RequestOutput(
            request_id=seq.request_id,
            prompt_token_ids=seq.prompt,
            token_ids=list(out_ids),
            text=self.tokenizer.decode(out_ids),
            finished=True,
            finish_reason=reason,
        ))
        if seq.slot >= 0:
            self._active.pop(seq.slot, None)
            self._free_slots.append(seq.slot)
            seq.slot = -1

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
