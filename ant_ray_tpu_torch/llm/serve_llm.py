"""One-process LLM server over the port's engine (counterpart of
ant_ray_tpu/llm/serve_llm.py, which the port does not import).

:class:`LLMServer` owns one engine driven by a background
:class:`EngineLoop` — concurrent requests from many threads SHARE engine
steps (chunked prefill interleaved with decode) instead of serializing
whole generations behind a lock.  The request/response dicts follow the
OpenAI completions and chat shapes (``prompt`` → ``choices[].text``,
``messages`` → ``choices[].message``, ``stream`` → chunk dicts), as the
reference's do.

Deadlines: a caller sets the absolute ``time.time()`` deadline of a
request in serve/api.py's ``_request_deadline`` (the reference's replica
does it from the stamped wire field); a request whose deadline has passed
is shed before it reaches the engine, and a wait that outlives it raises
:class:`~ant_ray_tpu_torch.exceptions.DeadlineExceededError`.

Session affinity: a request carrying ``session_id`` keeps its KV slab
across turns (idle slabs offload to the host store and restore
transparently).

Not in the port yet (ROADMAP.md): Serve deployments
(``build_llm_deployment``), the ``llm:*`` spans of the tracing plane and
the object-plane KV store (``kv_offload="object"``); ``"auto"`` picks
the host store, the reference's choice outside a cluster.
"""

from __future__ import annotations

import time

from ant_ray_tpu_torch.exceptions import DeadlineExceededError
from ant_ray_tpu_torch.llm.chat import render_chat
from ant_ray_tpu_torch.llm.engine import EngineLoop, LLMEngine, _not_in_port
from ant_ray_tpu_torch.llm.kv_offload import LocalKvStore
from ant_ray_tpu_torch.llm.sampling import SamplingParams
from ant_ray_tpu_torch.llm.tokenizer import get_tokenizer
from ant_ray_tpu_torch.serve.api import get_request_deadline


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
        """"auto" and "local" → the host store (the port has no cluster
        runtime, so "auto" never finds one); "object" is not ported; a
        store instance passes through; None lets the engine default
        apply."""
        if kv_offload is None or not isinstance(kv_offload, str):
            return kv_offload
        if kv_offload in ("local", "auto"):
            return LocalKvStore()
        if kv_offload == "object":
            raise _not_in_port(
                'the object-plane KV store (kv_offload="object")')
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
        handles = [self._loop.submit(p, sampling, session_id=session_id)
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
        handle = self._loop.submit(token_ids, sampling,
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
        handle = self._loop.submit(prompt, sampling,
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


def build_llm_deployment(*_args, **_kwargs):
    """The reference's Serve application factory.  Serve needs the
    runtime, which is not ported yet: this raises."""
    raise _not_in_port("Serve deployments (build_llm_deployment)")
