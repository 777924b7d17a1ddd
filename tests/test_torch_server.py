"""The port's LLMServer (llm/serve_llm.py) against the JAX package's, both
built on one HF-layout directory this file writes from a seeded numpy
generator (2 layers, dim 64, vocab 256, fp32), with the reference's
serving defaults (chunked prefill of 64 tokens) and ``kv_offload="local"``.
Greedy response dicts and stream chunk sequences must be equal; sheds
raise the same typed errors with the same messages.  Also the
profiler's peak detection and the device memory statistics, each against
the reference."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ant_ray_tpu.exceptions import DeadlineExceededError as JaxDeadline
from ant_ray_tpu.llm.serve_llm import LLMServer as JaxServer
from ant_ray_tpu.observability import device_stats as jax_device_stats
from ant_ray_tpu.observability.step_profiler import \
    StepProfiler as JaxProfiler
from ant_ray_tpu.serve.api import _request_deadline as jax_deadline
from ant_ray_tpu_torch.exceptions import (BackPressureError,
                                          DeadlineExceededError)
from ant_ray_tpu_torch.llm import LLMServer, SamplingParams
from ant_ray_tpu_torch.llm.serve_llm import build_llm_deployment
from ant_ray_tpu_torch.observability import StepProfiler, device_memory_stats
from ant_ray_tpu_torch.serve.api import _request_deadline

WAIT_S = 120
DIMS = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 128,
        "torch_dtype": "float32"}


def _write_dir(path, seed=0):
    """config.json and a model.safetensors of seeded random weights in the
    HF layout ((out, in) projections scaled by 1/sqrt(in))."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d, f, v = (DIMS[k] for k in ("hidden_size", "intermediate_size",
                                 "vocab_size"))
    kv = d // DIMS["num_attention_heads"] * DIMS["num_key_value_heads"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    state = {"model.embed_tokens.weight": w(v, d), "lm_head.weight": w(v, d),
             "model.norm.weight": np.ones(d, np.float32)}
    for i in range(DIMS["num_hidden_layers"]):
        for name, shape in (("self_attn.q_proj", (d, d)),
                            ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)),
                            ("self_attn.o_proj", (d, d)),
                            ("mlp.gate_proj", (f, d)),
                            ("mlp.up_proj", (f, d)),
                            ("mlp.down_proj", (d, f))):
            state[f"model.layers.{i}.{name}.weight"] = w(*shape)
        for name in ("input_layernorm", "post_attention_layernorm"):
            state[f"model.layers.{i}.{name}.weight"] = np.ones(d, np.float32)
    (path / "config.json").write_text(json.dumps(DIMS))
    save_file(state, str(path / "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp("llama"))


@pytest.fixture(scope="module")
def servers(model_dir):
    kw = dict(slots=2, kv_offload="local")
    jax_srv = JaxServer(model_dir, **kw)
    srv = LLMServer(model_dir, device="cpu", **kw)
    yield jax_srv, srv
    jax_srv.shutdown()
    srv.shutdown()


REQUESTS = [
    {"prompt": "The quick brown fox", "max_tokens": 8},
    {"prompt": ["ab", "a longer prompt of some bytes"], "max_tokens": 6},
    {"prompt": [5, 9, 17, 33, 65, 129], "max_tokens": 6},
    {"messages": [{"role": "system", "content": "Be brief."},
                  {"role": "user", "content": "hello there"}],
     "max_tokens": 7},
    {"prompt": "chat route", "__route_path__": "/v1/chat/completions",
     "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5},
]


@pytest.mark.parametrize("request_", REQUESTS,
                         ids=["text", "list", "token_ids", "chat",
                              "chat_route"])
def test_responses_equal_the_reference(servers, request_):
    jax_srv, srv = servers
    got = srv(dict(request_))
    assert got == jax_srv(dict(request_))
    for choice in got["choices"]:
        assert choice["finish_reason"] in ("length", "stop")
    if "usage" in got:
        usage = got["usage"]
        assert usage["total_tokens"] == (usage["prompt_tokens"]
                                         + usage["completion_tokens"])


@pytest.mark.parametrize("request_", [REQUESTS[0], REQUESTS[2], REQUESTS[3]],
                         ids=["text", "token_ids", "chat"])
def test_stream_chunks_equal_the_reference(servers, request_):
    jax_srv, srv = servers
    chunks = list(srv.stream(dict(request_)))
    assert chunks == list(jax_srv.stream(dict(request_)))
    assert chunks[-1]["done"] and not any(c["done"] for c in chunks[:-1])
    whole = srv(dict(request_))["choices"][0]
    if "messages" in request_:
        text = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
        assert text == whole["message"]["content"]
    else:
        assert [c["choices"][0]["token_id"] for c in chunks[:-1]] == \
            whole["token_ids"]


def test_session_turns_and_end_session_equal_the_reference(servers):
    jax_srv, srv = servers
    turns = [{"prompt": "first turn", "max_tokens": 5, "session_id": "s"},
             {"prompt": " and a second", "max_tokens": 5, "session_id": "s"}]
    for turn in turns:
        assert srv(dict(turn)) == jax_srv(dict(turn))
    assert srv.load_signals()["art_llm_resident_sessions"] == 1.0
    assert srv.end_session("s") is jax_srv.end_session("s") is True
    assert srv.end_session("s") is jax_srv.end_session("s") is False


def test_load_signals_and_health_match_the_reference(servers):
    jax_srv, srv = servers
    got = srv.load_signals()
    assert set(got) == set(jax_srv.load_signals())
    assert all(isinstance(v, float) for v in got.values())
    assert srv.health() == jax_srv.health() == "ok"


def test_max_waiting_bounds_the_loop_queue(model_dir):
    """As the reference's test_llm_server_max_waiting_bounds_loop_queue:
    with the lone KV slot busy and the line full, a request sheds typed
    BackPressureError instead of waiting without bound."""
    srv = LLMServer(model_dir, slots=1, max_seq=64, max_waiting=0,
                    kv_offload="local", device="cpu")
    try:
        pin = srv._loop.submit([1, 2, 3], SamplingParams(max_tokens=40))
        deadline = time.monotonic() + WAIT_S
        while pin.first_token_ts is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert pin.first_token_ts is not None, "pin request never started"
        with pytest.raises(BackPressureError) as err:
            srv({"prompt": "hi", "max_tokens": 1})
        assert err.value.retry_after_s > 0
        pin.wait(timeout=WAIT_S)
        assert srv({"prompt": "hi", "max_tokens": 1})["choices"]
    finally:
        srv.shutdown()


def _shed(server, var, request, stream=False):
    """Call ``server`` with a deadline one second past; the message of
    what it raised."""
    token = var.set(time.time() - 1.0)
    try:
        with pytest.raises(TimeoutError) as info:
            if stream:
                next(server.stream(request))
            else:
                server(request)
    finally:
        var.reset(token)
    return type(info.value), str(info.value)


@pytest.mark.parametrize("stream", [False, True])
def test_expired_deadline_sheds_without_touching_the_engine(servers, stream):
    jax_srv, srv = servers
    req = {"prompt": "never runs", "max_tokens": 4}
    stats = dict(srv.engine.stats)
    counter = repr(srv.engine._req_counter)
    kind, msg = _shed(srv, _request_deadline, dict(req), stream)
    assert kind is DeadlineExceededError
    assert issubclass(kind, TimeoutError)
    assert (JaxDeadline, msg) == _shed(jax_srv, jax_deadline, dict(req),
                                       stream)
    assert srv.engine.stats == stats
    assert repr(srv.engine._req_counter) == counter     # no id consumed
    # A stream reads the deadline when first iterated, not when built.
    token = _request_deadline.set(time.time() - 1.0)
    gen = srv.stream(dict(req))
    _request_deadline.reset(token)
    assert next(gen)["object"] == "text_completion.chunk"
    list(gen)


def _expire_while_waiting(server, var):
    """Hold the server's loop thread, submit with a deadline 0.2 s ahead,
    release the loop: the wait outlives the deadline."""
    gate = threading.Event()
    server._loop._call_on_loop(lambda eng: gate.wait(WAIT_S), timeout=0)
    token = var.set(time.time() + 0.2)
    try:
        with pytest.raises(TimeoutError) as info:
            server({"prompt": "too late", "max_tokens": 4})
    finally:
        var.reset(token)
        gate.set()
    return type(info.value), str(info.value)


def test_deadline_expiring_during_generation_raises(model_dir):
    jax_srv = JaxServer(model_dir, slots=1, kv_offload="local")
    srv = LLMServer(model_dir, slots=1, kv_offload="local", device="cpu")
    try:
        kind, msg = _expire_while_waiting(srv, _request_deadline)
        assert kind is DeadlineExceededError
        assert msg == "request deadline expired during generation"
        assert (JaxDeadline, msg) == _expire_while_waiting(jax_srv,
                                                           jax_deadline)
        # The server keeps serving after the shed.
        assert srv({"prompt": "next", "max_tokens": 2})["choices"]
    finally:
        jax_srv.shutdown()
        srv.shutdown()


def test_store_modes_and_deployment():
    from ant_ray_tpu.llm.serve_llm import \
        build_llm_deployment as jax_build_llm_deployment
    from ant_ray_tpu_torch.llm import kv_offload as kvo

    # No runtime in this process: "auto" is the host store.
    assert type(LLMServer._resolve_store("auto")) is kvo.LocalKvStore
    assert type(LLMServer._resolve_store("local")) is kvo.LocalKvStore
    assert LLMServer._resolve_store(None) is None
    assert type(LLMServer._resolve_store("object")) is \
        kvo.ObjectPlaneKvStore
    with pytest.raises(ValueError):
        LLMServer._resolve_store("disk")
    app = build_llm_deployment("tiny")
    want = jax_build_llm_deployment("tiny")
    assert app.deployment.cls_or_fn is LLMServer
    assert app.args == want.args == ("tiny",)
    assert app.kwargs == {**want.kwargs, "device": None}
    for field in ("name", "num_replicas", "route_prefix",
                  "max_ongoing_requests", "max_queued_requests",
                  "request_timeout_s", "autoscaling_config"):
        assert getattr(app.deployment, field) == \
            getattr(want.deployment, field), field
    assert build_llm_deployment("tiny", device="cpu").kwargs["device"] \
        == "cpu"


# --------------------------------------------- profiler and device stats

def test_peak_detection(monkeypatch):
    assert StepProfiler()._peak_flops is None
    assert JaxProfiler()._peak_flops is None          # the reference off a TPU
    assert StepProfiler(peak_flops=1e12)._peak_flops == 1e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    prof = StepProfiler(flops_per_step=1e9)
    assert prof._peak_flops == 989e12
    with prof.step():
        pass
    assert prof.summary()["mfu_mean"] > 0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Other GPU")
    assert StepProfiler()._peak_flops is None


def test_device_memory_stats_on_the_cpu_have_the_references_shape():
    got = device_memory_stats()
    want = jax_device_stats.device_memory_stats()
    assert len(got) == 1 and want
    assert set(got[0]) == set(want[0])
    assert got[0]["platform"] == want[0]["platform"] == "cpu"
    for field in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        assert got[0][field] is None and want[0][field] is None
