"""``build_llm_deployment`` of the port (llm/serve_llm.py) served by
Serve in a port cluster, against the reference's in a JAX cluster
(each started without ``_system_config``: both packages read the same
``ART_*`` variables).  Both deploy one HF-layout directory
(tests/test_torch_server.py ``_write_dir``: 2 layers, dim 64, vocab
256, fp32, from a seeded numpy generator) on the CPU (the port's
replicas with ``device="cpu"``) with the reference's serving defaults.
Completions and chats through the handle and over HTTP, handle streams
and SSE streams must be equal (greedy); a session continues across an
idle eviction through ``kv_offload="auto"``, which is the object-plane
store in a replica; the 429 and 504 contracts match."""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu.serve as jserve
import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.serve as tserve
from ant_ray_tpu.llm.serve_llm import LLMServer as JaxServer
from ant_ray_tpu.llm.serve_llm import \
    build_llm_deployment as jax_build_llm_deployment
from ant_ray_tpu_torch.llm.serve_llm import LLMServer, build_llm_deployment
from test_torch_server import _write_dir

WAIT_S = 120
IDLE_EVICT_S = 0.3
COUNTERS = ("offloads", "restores", "idle_evictions", "pressure_evictions",
            "offload_bytes", "restore_failures")


class JaxProbe(JaxServer):
    """The reference's server plus a method that reports its store and
    one that holds the replica's admission slot."""

    def store_report(self):
        return (type(self.engine._kv_store).__name__,
                {k: self.engine.stats[k] for k in COUNTERS})

    def hold(self, seconds):
        time.sleep(seconds)
        return seconds


class PortProbe(LLMServer):
    """The port's server plus a method that reports its store and one
    that holds the replica's admission slot."""

    def store_report(self):
        return (type(self.engine._kv_store).__name__,
                {k: self.engine.stats[k] for k in COUNTERS})

    def hold(self, seconds):
        time.sleep(seconds)
        return seconds


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp("llama"))


@pytest.fixture(scope="module")
def deployed(model_dir):
    """One deployment per package: the reference's serving defaults
    (chunked prefill of 64), idle eviction, ``kv_offload="auto"``, an
    admission gate of one running request and no queue seat."""
    kw = dict(name="llm", slots=2, max_seq=96, kv_idle_evict_s=IDLE_EVICT_S,
              max_ongoing_requests=1, max_queued_requests=0)
    out = {}
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            for name, art, serve, build, probe, extra in (
                    ("jax", jart, jserve, jax_build_llm_deployment,
                     JaxProbe, {}),
                    ("torch", tart, tserve, build_llm_deployment, PortProbe,
                     {"device": "cpu"})):
                app = build(model_dir, **kw, **extra)
                app = dataclasses.replace(app, deployment=dataclasses.replace(
                    app.deployment, cls_or_fn=probe))
                handle = serve.run(app, port=0)
                out[name] = (art, handle, serve.api.run.last_http_port)
            yield out
        finally:
            tserve.shutdown()
            tart.shutdown()
    finally:
        jserve.shutdown()
        jart.shutdown()


def _both(deployed, scenario):
    return tuple(scenario(*deployed[p]) for p in ("jax", "torch"))


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


COMPLETION = {"prompt": [5, 9, 17, 33, 65, 129], "max_tokens": 8}
CHAT = {"messages": [{"role": "system", "content": "Be brief."},
                     {"role": "user", "content": "hello there"}],
        "max_tokens": 7}


def test_completion_and_chat_through_the_handle(deployed):
    def scenario(art, handle, _port):
        return (art.get(handle.remote(dict(COMPLETION)), timeout=WAIT_S),
                art.get(handle.remote(dict(CHAT)), timeout=WAIT_S),
                handle.call({"prompt": "text prompt", "max_tokens": 5}))

    want, got = _both(deployed, scenario)
    assert got == want
    assert got[0]["object"] == "text_completion"
    assert len(got[0]["choices"][0]["token_ids"]) == 8
    assert got[1]["object"] == "chat.completion"


def test_completion_and_chat_over_http(deployed):
    def scenario(art, handle, port):
        replies = []
        for path, body in (("/v1/completions", COMPLETION),
                           ("/v1/chat/completions",
                            {"messages": CHAT["messages"], "max_tokens": 7})):
            code, headers, raw = _post(port, path, dict(body))
            replies.append((code, headers["Content-Type"], json.loads(raw)))
        return replies

    want, got = _both(deployed, scenario)
    assert got == want
    (code, _, body), (chat_code, _, chat) = got
    assert code == chat_code == 200
    assert body["result"]["object"] == "text_completion"
    assert chat["result"]["object"] == "chat.completion"
    # The HTTP reply carries what the handle returns.
    art, handle, _ = deployed["torch"]
    assert body["result"] == art.get(handle.remote(dict(COMPLETION)),
                                     timeout=WAIT_S)


def test_handle_stream_and_sse_stream(deployed):
    def scenario(art, handle, port):
        gen = handle.options(method_name="stream", stream=True).remote(
            dict(COMPLETION))
        chunks = [art.get(ref, timeout=WAIT_S) for ref in gen]
        code, headers, raw = _post(port, "/v1/completions",
                                   {**COMPLETION, "stream": True})
        frames = [ln[len("data: "):] for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        return chunks, code, headers["Content-Type"], frames

    want, got = _both(deployed, scenario)
    assert got == want
    chunks, code, ctype, frames = got
    assert code == 200 and ctype == "text/event-stream"
    assert frames[-1] == "[DONE]"
    assert [json.loads(f) for f in frames[:-1]] == chunks
    assert chunks[-1]["done"] and len(chunks) == COMPLETION["max_tokens"] + 1


def test_session_continues_across_an_idle_eviction(deployed):
    """Turn one, then a pause past ``kv_idle_evict_s`` and a request
    without a session (its steps run the idle sweep, which offloads the
    session's slab to the replica's store), then turn two, which
    restores it.  Its tokens must equal those of the same two turns
    with no eviction between them (a second session), and the
    reference's."""
    turns = [{"prompt": [7, 8, 9, 10], "max_tokens": 5},
             {"prompt": [11, 12], "max_tokens": 5}]

    def scenario(art, handle, _port):
        report = handle.options(method_name="store_report")
        end = handle.options(method_name="end_session")
        plain = [handle.call({**t, "session_id": "plain"}) for t in turns]
        end.call("plain")
        kind, before = report.call()
        first = handle.call({**turns[0], "session_id": "s"})
        time.sleep(IDLE_EVICT_S + 0.3)
        filler = handle.call({"prompt": [3, 4], "max_tokens": 3})
        _, evicted = report.call()
        second = handle.call({**turns[1], "session_id": "s"})
        _, after = report.call()
        end.call("s")
        return (kind, plain, [first, second], filler,
                {k: evicted[k] - before[k] for k in COUNTERS},
                {k: after[k] - before[k] for k in COUNTERS})

    want, got = _both(deployed, scenario)
    assert got == want
    kind, plain, session, _filler, evicted, after = got
    assert kind == "ObjectPlaneKvStore"
    assert session == plain
    assert evicted["idle_evictions"] == evicted["offloads"] == 1
    assert after["restores"] == 1 and after["restore_failures"] == 0


def _contract(reply):
    code, headers, raw = reply
    body = json.loads(raw)
    return code, "Retry-After" in headers, sorted(body)


def test_429_and_504_contracts(deployed):
    """One running request and no queue seat: a completion sent while
    another call holds the replica sheds as 429 + Retry-After with the
    same message; a client deadline shorter than the generation gives
    504."""
    def scenario(art, handle, port):
        hold = handle.options(method_name="hold")
        blocker = threading.Thread(target=lambda: hold.call(1.5))
        blocker.start()
        time.sleep(0.5)                 # the hold now has the only slot
        shed = _post(port, "/v1/completions",
                     {"prompt": [1, 2], "max_tokens": 1})
        blocker.join()
        assert int(shed[1]["Retry-After"]) >= 1
        assert json.loads(shed[2])["retry_after_s"] > 0
        late = _post(port, "/v1/completions",
                     {"prompt": [5, 6, 7], "max_tokens": 60},
                     {"X-Request-Timeout-S": "0.01"})
        after = _post(port, "/v1/completions", dict(COMPLETION))
        return (_contract(shed), json.loads(shed[2])["error"],
                _contract(late), after[0], json.loads(after[2]))

    want, got = _both(deployed, scenario)
    assert got == want
    shed, message, late, code, after = got
    assert shed == (429, True, ["error", "retry_after_s"])
    assert message == "replica at capacity (1 running, 0 queued)"
    assert late == (504, False, ["error"])
    assert code == 200 and after["result"]["object"] == "text_completion"
