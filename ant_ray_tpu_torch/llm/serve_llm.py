"""Serve deployment wrapping the LLM engine (counterpart of
ant_ray_tpu/llm/serve_llm.py, which the port does not import).

``build_llm_deployment`` returns a serve Application; each replica owns
one :class:`LLMServer`: one engine driven by a background
:class:`EngineLoop` — concurrent requests from many threads SHARE engine
steps (chunked prefill interleaved with decode) instead of serializing
whole generations behind a lock.  The request/response dicts follow the
OpenAI completions and chat shapes (``prompt`` → ``choices[].text``,
``messages`` → ``choices[].message``, ``stream`` → chunk dicts), as the
reference's do.  ``LLMServer`` also runs on its own, in any process.

Deadlines: the replica sets serve/api.py's ``_request_deadline`` from
the deadline the ingress or handle stamped (a caller in one process sets
it itself); a request whose deadline has passed is shed before it
reaches the engine, and a wait that outlives it raises
:class:`~ant_ray_tpu_torch.exceptions.DeadlineExceededError`.

Session affinity: a request carrying ``session_id`` keeps its KV slab
across turns on THIS replica (idle slabs offload to a kv_offload.py
store and restore transparently).  ``kv_offload="auto"`` picks the
object-plane store in any process connected to a runtime (a Serve
replica, a cluster's driver, local mode) and the host store otherwise.
Multi-replica session routing rides the owner-direct call plane — until
then, pin sessions to a replica via handle affinity or num_replicas=1.

Tracing: under a trace context (observability/tracing_plane.py), a
completion or a chat runs inside an ``llm:generate`` span and a stream
inside ``llm:stream``; each submission runs inside ``llm:admission``, and
the context rides the request into the engine (its ``llm:restore``
spans).  Without a context these spans are no-ops.
"""

from __future__ import annotations

import time

from ant_ray_tpu_torch.exceptions import DeadlineExceededError
from ant_ray_tpu_torch.llm.chat import render_chat
from ant_ray_tpu_torch.llm import kv_offload as kvo
from ant_ray_tpu_torch.llm.engine import EngineLoop, LLMEngine
from ant_ray_tpu_torch.llm.sampling import SamplingParams
from ant_ray_tpu_torch.llm.tokenizer import get_tokenizer
from ant_ray_tpu_torch.observability import tracing_plane
from ant_ray_tpu_torch.serve.api import deployment, get_request_deadline


class LLMServer:
    """One engine + one background engine loop.  ``device=None`` is the
    current CUDA device (pass ``device="cpu"`` to run on the CPU)."""

    def __init__(self, model="tiny", *, slots: int = 8,
                 max_seq: int | None = None, tokenizer_name: str | None =
                 None, seed: int = 0, tensor_parallel_size: int = 1,
                 max_waiting: int | None = None,
                 prefill_chunk_tokens: int | None = 64,
                 decode_steps_per_chunk: int = 1,
                 kv_idle_evict_s: float | None = None,
                 kv_offload="auto", device=None):
        store = self._resolve_store(kv_offload)
        self.engine = LLMEngine(
            model, slots=slots, max_seq=max_seq,
            tokenizer=get_tokenizer(tokenizer_name), seed=seed,
            device=device, tensor_parallel_size=tensor_parallel_size,
            max_waiting=max_waiting,
            prefill_chunk_tokens=prefill_chunk_tokens,
            decode_steps_per_chunk=decode_steps_per_chunk,
            kv_idle_evict_s=kv_idle_evict_s,
            kv_offload_store=store)
        self._loop = EngineLoop(self.engine, max_waiting=max_waiting)

    @staticmethod
    def _resolve_store(kv_offload):
        """"auto" → object plane when this process is connected to a
        runtime (a cluster worker or driver, or local mode), host-local
        otherwise; "object"/"local" force a tier; a store instance
        passes through; None lets the engine default apply."""
        if kv_offload is None or not isinstance(kv_offload, str):
            return kv_offload
        if kv_offload == "local":
            return kvo.LocalKvStore()
        if kv_offload == "object":
            return kvo.ObjectPlaneKvStore()
        if kv_offload == "auto":
            from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

            if global_worker.connected:
                return kvo.ObjectPlaneKvStore()
            return kvo.LocalKvStore()
        raise ValueError(f"unknown kv_offload mode {kv_offload!r}")

    @staticmethod
    def _check_deadline(where: str) -> None:
        """Shed a request whose end-to-end deadline already expired —
        generating tokens nobody is waiting for would burn engine steps
        for nothing."""
        deadline_ts = get_request_deadline()  # wall-clock wire field
        if deadline_ts is not None and time.time() >= deadline_ts:
            raise DeadlineExceededError(
                f"request deadline expired before {where} — shed, "
                "not executed")

    @staticmethod
    def _deadline_timeout() -> float | None:
        deadline_ts = get_request_deadline()
        if deadline_ts is None:
            return None
        return max(0.0, deadline_ts - time.time())

    @staticmethod
    def _is_chat(request: dict) -> bool:
        path = request.get("__route_path__", "")
        return "messages" in request or path.endswith("/chat/completions")

    def _submit(self, prompt, sampling, session_id=None):
        """Admission (typed shed inside the `llm:admission` span) +
        enqueue to the engine loop."""
        ctx = tracing_plane.current()
        with tracing_plane.span("llm:admission"):
            return self._loop.submit(prompt, sampling,
                                     session_id=session_id,
                                     trace_ctx=ctx)

    def _wait(self, handle, where: str):
        timeout = self._deadline_timeout()
        try:
            return handle.wait(timeout)
        except TimeoutError as exc:
            raise DeadlineExceededError(
                f"request deadline expired during {where}") from exc

    def __call__(self, request: dict) -> dict:
        """OpenAI-shaped request.  Completions: {"prompt": ...} →
        choices[].text; the prompt may be a string, a list of strings or
        a list of token ids.  Chat (a "messages" key, or a
        /chat/completions route): templated through the tokenizer's chat
        template → choices[].message.  An optional ``session_id`` pins
        the request to a persistent KV session (multi-turn reuse + host
        offload)."""
        if self._is_chat(request):
            return self._chat(request)
        prompts = request.get("prompt", "")
        many = isinstance(prompts, list) and prompts and not isinstance(
            prompts[0], int)
        batch = prompts if many else [prompts]
        sampling = self._sampling(request)
        session_id = request.get("session_id")
        self._check_deadline("generation")
        with tracing_plane.span(
                "llm:generate",
                {"prompts": len(batch),
                 "max_tokens": sampling.max_tokens}):
            handles = [self._submit(p, sampling, session_id=session_id)
                       for p in batch]
            outs = [self._wait(h, "generation") for h in handles]
        return {
            "object": "text_completion",
            "choices": [
                {"index": i, "text": o.text,
                 "token_ids": o.token_ids,
                 "finish_reason": o.finish_reason}
                for i, o in enumerate(outs)
            ],
        }

    def _chat(self, request: dict) -> dict:
        token_ids = render_chat(self.engine.tokenizer,
                                request.get("messages", []))
        sampling = self._sampling(request)
        self._check_deadline("generation")
        with tracing_plane.span(
                "llm:generate",
                {"max_tokens": sampling.max_tokens, "chat": True}):
            handle = self._submit(token_ids, sampling,
                                  session_id=request.get("session_id"))
            out = self._wait(handle, "generation")
        return {
            "object": "chat.completion",
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out.text},
                "finish_reason": out.finish_reason,
            }],
            "usage": {
                "prompt_tokens": len(out.prompt_token_ids),
                "completion_tokens": len(out.token_ids),
                "total_tokens": (len(out.prompt_token_ids)
                                 + len(out.token_ids)),
            },
        }

    @staticmethod
    def _sampling(request: dict) -> SamplingParams:
        return SamplingParams(
            max_tokens=int(request.get("max_tokens", 64)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            top_p=float(request.get("top_p", 1.0)),
            stop_token_ids=tuple(request.get("stop_token_ids", ())),
            seed=request.get("seed"),
        )

    def stream(self, request: dict):
        """Token-streaming completion or chat: a generator of
        OpenAI-chunk-shaped dicts, one per token as the loop produces it,
        then a final one with ``"done": True`` — other requests keep
        decoding in the same engine steps.  The deadline is read when
        the generator is first iterated."""
        chat = self._is_chat(request)
        if chat:
            prompt = render_chat(self.engine.tokenizer,
                                 request.get("messages", []))
        else:
            prompts = request.get("prompt", "")
            prompt = prompts[0] if isinstance(prompts, list) and prompts \
                and not isinstance(prompts[0], int) else prompts
        sampling = self._sampling(request)
        self._check_deadline("streaming generation")
        with tracing_plane.span(
                "llm:stream",
                {"max_tokens": sampling.max_tokens, "chat": chat}):
            handle = self._submit(prompt, sampling,
                                  session_id=request.get("session_id"))
            yield from (self._chat_chunks(handle) if chat
                        else self._chunks(handle))

    def _events(self, handle):
        """Handle events → the engine-stream delta shape."""
        decode = self.engine.tokenizer.decode
        for ev in handle:
            if ev["type"] == "token":
                tok = ev["token_id"]
                yield {"token_id": tok, "text": decode([tok]),
                       "finished": False, "finish_reason": None}
            elif ev["type"] == "error":
                raise ev["error"]
            else:
                out = ev["output"]
                yield {"token_id": None, "text": "", "finished": True,
                       "finish_reason": out.finish_reason,
                       "token_ids": list(out.token_ids),
                       "full_text": out.text}

    def _chunks(self, handle):
        for delta in self._events(handle):
            if delta["finished"]:
                yield {"object": "text_completion.chunk",
                       "choices": [{"index": 0, "text": "",
                                    "finish_reason":
                                        delta["finish_reason"]}],
                       "done": True}
            else:
                yield {"object": "text_completion.chunk",
                       "choices": [{"index": 0, "text": delta["text"],
                                    "token_id": delta["token_id"],
                                    "finish_reason": None}],
                       "done": False}

    def _chat_chunks(self, handle):
        for delta in self._events(handle):
            if delta["finished"]:
                yield {"object": "chat.completion.chunk",
                       "choices": [{"index": 0, "delta": {},
                                    "finish_reason":
                                        delta["finish_reason"]}],
                       "done": True}
            else:
                yield {"object": "chat.completion.chunk",
                       "choices": [{"index": 0,
                                    "delta": {"role": "assistant",
                                              "content": delta["text"]},
                                    "finish_reason": None}],
                       "done": False}

    def end_session(self, session_id: str) -> bool:
        """Drop a session's KV state (slot + offloaded slab).  Routed
        through the engine loop so the teardown runs on the loop thread
        — never concurrently with a step mutating the same slot maps."""
        return self._loop.end_session(session_id)

    def load_signals(self) -> dict:
        """Engine load gauges (the reference's autoscaling signals):
        art_llm_tokens_per_s, art_llm_queue_depth,
        art_llm_resident_sessions."""
        return self._loop.stats()

    def health(self):
        return "ok"

    def shutdown(self) -> None:
        """Stop the engine loop thread."""
        self._loop.shutdown()


def build_llm_deployment(model="tiny", *, name: str = "llm",
                         num_replicas: int = 1, slots: int = 8,
                         max_seq: int | None = None,
                         tokenizer_name: str | None = None,
                         tensor_parallel_size: int = 1,
                         route_prefix: str | None = "/v1",
                         max_ongoing_requests: int | None = None,
                         max_queued_requests: int = 0,
                         request_timeout_s: float | None = None,
                         max_waiting: int | None = None,
                         autoscaling_config=None,
                         prefill_chunk_tokens: int | None = 64,
                         decode_steps_per_chunk: int = 1,
                         kv_idle_evict_s: float | None = None,
                         kv_offload="auto", device=None):
    """Application for ``serve.run`` exposing the engine under the
    OpenAI surface: POST /v1/completions and /v1/chat/completions
    (+ streaming via {"stream": true}).

    The overload knobs compose: ``max_ongoing_requests`` /
    ``max_queued_requests`` bound the replica's request gate,
    ``request_timeout_s`` stamps the default end-to-end deadline, and
    ``max_waiting`` bounds the ENGINE's prompt line once every KV slot
    is busy — all sheds surface as 429/RESOURCE_EXHAUSTED with the
    retry hint derived from the measured chunk-drain rate.

    Serving enables chunked prefill by default
    (``prefill_chunk_tokens=64``); ``kv_idle_evict_s`` turns on
    idle-session offload through ``kv_offload`` ("auto" picks the
    object plane inside a replica).  Only the string modes reach a
    replica: a store instance does not pickle.  ``autoscaling_config``
    may target the engine's published load signals (see
    `AutoscalingConfig.target_signal`).

    ``device`` is passed to each replica's ``LLMServer``: None is the
    replica's current CUDA device, ``"cpu"`` runs on the CPU."""
    dep = deployment(
        LLMServer, name=name, num_replicas=num_replicas,
        route_prefix=route_prefix,
        max_ongoing_requests=max_ongoing_requests,
        max_queued_requests=max_queued_requests,
        request_timeout_s=request_timeout_s,
        autoscaling_config=autoscaling_config)
    return dep.bind(model, slots=slots, max_seq=max_seq,
                    tokenizer_name=tokenizer_name,
                    tensor_parallel_size=tensor_parallel_size,
                    max_waiting=max_waiting,
                    prefill_chunk_tokens=prefill_chunk_tokens,
                    decode_steps_per_chunk=decode_steps_per_chunk,
                    kv_idle_evict_s=kv_idle_evict_s,
                    kv_offload=kv_offload, device=device)
