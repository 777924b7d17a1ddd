"""The object-plane KV stores of the port (llm/kv_offload.py
``ObjectPlaneKvStore`` and ``KvVault``), the store ``LLMServer`` picks
(``_resolve_store``), and the engine options ``kv_evict_on_pressure``
and ``EngineLoop(idle_sleep_s=...)``, against the JAX package.

Slabs are made from a seeded numpy generator.  An fp32 slab goes through
both packages' stores in their own clusters (started without
``_system_config``: both packages read the same ``ART_*`` variables)
and must come back bitwise equal to the input in both; a bf16 slab,
which has no numpy dtype, is held to its input.  Engines load one
HF-layout directory (tests/test_torch_server.py ``_write_dir``: 2
layers, dim 64, vocab 256, fp32): greedy tokens and the offload
counters must be equal to the JAX engine's.  Tolerance: tokens exact,
slabs bitwise.  The holder-death test starts a port cluster of its own
with ``testing_chunk_serve_delay_s`` before the module's clusters
exist."""

import gc
import re
import time

import numpy as np
import pytest
import torch

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from ant_ray_tpu.llm import LLMEngine as JaxEngine
from ant_ray_tpu.llm import SamplingParams as JaxSampling
from ant_ray_tpu.llm import kv_offload as jkvo
from ant_ray_tpu.llm.engine import EngineLoop as JaxLoop
from ant_ray_tpu.llm.serve_llm import LLMServer as JaxServer
from ant_ray_tpu.llm.tokenizer import get_tokenizer as jax_tokenizer
from ant_ray_tpu_torch.exceptions import KVRestoreError
from ant_ray_tpu_torch.llm import EngineLoop, LLMEngine, SamplingParams
from ant_ray_tpu_torch.llm import kv_offload as tkvo
from ant_ray_tpu_torch.llm.serve_llm import LLMServer
from ant_ray_tpu_torch.llm.tokenizer import get_tokenizer
from test_torch_server import _write_dir

DEADLINE_S = 120
COUNTERS = ("offloads", "restores", "pressure_evictions", "idle_evictions",
            "restore_failures", "offload_bytes")


def _mask(message: str) -> str:
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>",
                  message.replace("ant_ray_tpu_torch", "ant_ray_tpu"))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _write_dir(tmp_path_factory.mktemp("llama"))


def _kw(kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 96)
    kw.setdefault("prefill_chunk_tokens", 8)
    return kw


def _port(model_dir, **kw):
    return LLMEngine(model_dir, device="cpu", tokenizer=get_tokenizer(None),
                     **_kw(kw))


def _jax(model_dir, **kw):
    return JaxEngine(model_dir, tokenizer=jax_tokenizer(None), **_kw(kw))


def _sampling(eng, n, **kw):
    cls = JaxSampling if isinstance(eng, JaxEngine) else SamplingParams
    return cls(max_tokens=n, **kw)


def _drain(eng):
    outs = {}
    deadline = time.monotonic() + DEADLINE_S
    while eng.has_unfinished():
        for out in eng.step():
            outs[out.request_id] = out
        assert time.monotonic() < deadline, "engine never drained"
    return outs


def _turn(eng, sid, prompt, n):
    eng.add_request(list(prompt), _sampling(eng, n), admit=False,
                    session_id=sid)
    outs = list(_drain(eng).values())
    assert len(outs) == 1
    return [int(t) for t in outs[0].token_ids]


def _counters(eng):
    return {key: eng.stats[key] for key in COUNTERS}


def _np_slab(seed, shape=(2, 16, 2, 8)):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape).astype(np.float32)
    return k, -3 * k, seed + 5


def _torch_slab(seed, dtype):
    k, v, ln = _np_slab(seed)
    return torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype), ln


# ------------------------------------------- the store LLMServer picks

def _auto_kind(server_cls):
    return type(server_cls._resolve_store("auto")).__name__


def test_resolve_store_without_a_runtime_and_in_local_mode():
    assert not tart.is_initialized() and not jart.is_initialized()
    assert _auto_kind(LLMServer) == _auto_kind(JaxServer) == "LocalKvStore"
    for art in (jart, tart):
        art.init(local_mode=True)
    try:
        # Local mode is connected too (the reference's rule).
        assert _auto_kind(LLMServer) == _auto_kind(JaxServer) == \
            "ObjectPlaneKvStore"
        store = LLMServer._resolve_store("auto")
        k, v, ln = _torch_slab(1, torch.bfloat16)
        store.put("s", (k, v, ln))
        k2, v2, ln2 = store.get("s")
        assert torch.equal(k2, k) and torch.equal(v2, v) and ln2 == ln
    finally:
        for art in (jart, tart):
            art.shutdown()
    assert _auto_kind(LLMServer) == "LocalKvStore"
    assert type(LLMServer._resolve_store("object")) is \
        tkvo.ObjectPlaneKvStore
    with pytest.raises(ValueError, match="unknown kv_offload mode"):
        LLMServer._resolve_store("disk")


# ---------------------------------------------------------- chaos leg

def test_holder_death_mid_restore_fails_one_session_typed(model_dir):
    """The KV slab holder (a KvVault actor) dies while a restore is in
    flight (the port of the reference's test of the same name in
    tests/test_llm_sessions.py, with its assertions).  Exactly one
    session fails with KVRestoreError; the engine never wedges and
    keeps completing other requests."""
    tart.init(num_cpus=2,
              _system_config={"testing_chunk_serve_delay_s": 0.005})
    try:
        vault = tart.remote(tkvo.KvVault).remote()
        tart.get(vault.put.remote("warm", 1), timeout=60)   # actor is up
        store = tkvo.ObjectPlaneKvStore(vault=vault, get_timeout_s=15.0)
        eng = _port(model_dir, kv_offload_store=store)
        _turn(eng, "doomed", [5, 9, 17], 4)
        assert eng.evict_session("doomed")
        tart.kill(vault)                     # holder dies, slab with it
        failed_events = []
        eng.add_request([21, 22], SamplingParams(max_tokens=4),
                        admit=False, session_id="doomed",
                        on_event=failed_events.append)
        events = []
        eng.add_request([7, 8, 9], SamplingParams(max_tokens=6),
                        admit=False, on_event=events.append)
        outs = _drain(eng)
        failed = [o for o in outs.values() if o.finish_reason == "error"]
        assert len(failed) == 1 and "doomed" in failed[0].error
        survivors = [o for o in outs.values() if o.finish_reason != "error"]
        assert len(survivors) == 1 and len(survivors[0].token_ids) == 6
        assert eng.stats["restore_failures"] == 1
        assert not [e for e in events if e["type"] == "error"]
        errors = [e["error"] for e in failed_events if e["type"] == "error"]
        assert len(errors) == 1 and isinstance(errors[0], KVRestoreError)
        assert errors[0].session_id == "doomed"
        sess = eng._sessions["doomed"]
        assert sess.state == "failed" and sess.paused is None
        # The session id is reusable: a fresh request re-prefills.
        assert len(_turn(eng, "doomed", [1, 2, 3], 3)) == 3
    finally:
        tart.shutdown()


# ------------------------------------------------- the module's clusters

@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=2, num_tpus=0)
    try:
        tart.init(num_cpus=2, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        cause = getattr(e, "cause", None)
        return ("raise", type(e).__name__, _mask(str(cause or e)),
                type(cause).__name__ if cause is not None else None)


def test_object_plane_roundtrip_fp32_matches_jax(clusters):
    k, v, ln = _np_slab(0)
    jstore = jkvo.ObjectPlaneKvStore()
    jstore.put("sess", (k, v, ln))
    jk, jv, jln = jstore.get("sess")
    tstore = tkvo.ObjectPlaneKvStore()
    tstore.put("sess", (torch.from_numpy(k), torch.from_numpy(v), ln))
    tk, tv, tln = tstore.get("sess")
    assert tk.dtype == torch.float32 and tln == jln == ln
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tk.numpy(), k) and np.array_equal(tv.numpy(), v)
    assert (tstore.puts, tstore.gets) == (jstore.puts, jstore.gets) == (1, 1)
    # delete drops the ref: the next get raises the same typed error.
    want = _outcome(lambda: (jstore.delete("sess"), jstore.get("sess")))
    got = _outcome(lambda: (tstore.delete("sess"), tstore.get("sess")))
    assert got == want
    assert got[:2] == ("raise", "KvStoreError")
    with pytest.raises(tkvo.KvStoreError):
        tstore.get("never-put")


def test_object_plane_roundtrip_bf16_bitwise(clusters):
    store = tkvo.ObjectPlaneKvStore()
    slabs = {f"s{i}": _torch_slab(i, torch.bfloat16) for i in range(3)}
    for key, slab in slabs.items():
        store.put(key, slab)
    store.put("s0", slabs["s0"])          # a re-put replaces the ref
    for key, (k, v, ln) in slabs.items():
        k2, v2, ln2 = store.get(key)
        assert k2.dtype == torch.bfloat16 and k2.is_contiguous()
        assert torch.equal(k2.view(torch.int16), k.view(torch.int16))
        assert torch.equal(v2.view(torch.int16), v.view(torch.int16))
        assert ln2 == ln
    assert len(store._refs) == 3


def _vault_scenario(art, kvo, k, v, ln, to_native):
    vault = art.remote(kvo.KvVault).remote()
    store = kvo.ObjectPlaneKvStore(vault=vault, get_timeout_s=30.0)
    out = {"put": store.put("sess", (to_native(k), to_native(v), ln))}
    k2, v2, ln2 = store.get("sess")
    out["back"] = (np.asarray(k2).tobytes() == k.tobytes(),
                   np.asarray(v2).tobytes() == v.tobytes(), ln2)
    out["missing"] = _outcome(lambda: store.get("missing"))
    store.delete("sess")                  # fire-and-forget drop
    out["dropped"] = _outcome(lambda: store.get("sess"))
    out["direct"] = _outcome(lambda: art.get(vault.fetch.remote("x"),
                                             timeout=30))
    art.kill(vault)
    return out


def test_vault_roundtrip_and_errors_match_jax(clusters):
    k, v, ln = _np_slab(3)
    want = _vault_scenario(jart, jkvo, k, v, ln, lambda a: a)
    got = _vault_scenario(tart, tkvo, k, v, ln, torch.from_numpy)
    assert got == want
    assert got["back"] == (True, True, ln)
    assert got["missing"][1:] == ("ActorError", "vault has no slab "
                                  "'missing'", "KvStoreError")


def test_auto_store_in_a_cluster_worker_and_driver(clusters):
    def kinds(art, server_module):
        @art.remote
        def in_worker():
            import importlib

            mod = importlib.import_module(server_module)
            return type(mod.LLMServer._resolve_store("auto")).__name__

        return art.get(in_worker.remote(), timeout=DEADLINE_S)

    assert kinds(tart, "ant_ray_tpu_torch.llm.serve_llm") == \
        kinds(jart, "ant_ray_tpu.llm.serve_llm") == "ObjectPlaneKvStore"
    # A cluster's driver is connected too.
    assert _auto_kind(LLMServer) == _auto_kind(JaxServer) == \
        "ObjectPlaneKvStore"


# ------------------------------------- engine sessions through the plane

def _evict_run(eng):
    got = []
    for prompt, n in ([5, 9, 17], 6), ([3, 88, 41, 2], 6), ([11, 12], 6):
        got.append(_turn(eng, "s", prompt, n))
        eng.step()                   # idle sweep fires (cutoff = now)
        assert eng._sessions["s"].state == "offloaded"
    return got


def test_engine_session_through_object_plane_matches_jax(clusters,
                                                         model_dir):
    jeng = _jax(model_dir, kv_idle_evict_s=0.0,
                kv_offload_store=jkvo.ObjectPlaneKvStore())
    want = _evict_run(jeng)
    store = tkvo.ObjectPlaneKvStore()
    eng = _port(model_dir, kv_idle_evict_s=0.0, kv_offload_store=store)
    assert _evict_run(eng) == want
    assert _counters(eng) == _counters(jeng)
    assert eng.stats["restores"] == 2 and store.gets == 2
    assert store.puts == 3 and list(store._refs) == ["s"]
    assert eng.end_session("s") and not store._refs


class _DeletingStore(tkvo.ObjectPlaneKvStore):
    """Drops the slab's ref as soon as a fetch has read it and puts a
    slab of the same size in its place, before the engine installs the
    fetched tensors: the arena may reuse the freed bytes at once."""

    def get(self, handle):
        slab = super().get(handle)
        self.delete(handle)
        gc.collect()
        k, v, ln = slab
        self.put("junk", (torch.full_like(k, 7.0), torch.full_like(v, 7.0),
                          ln))
        return slab


def test_delete_before_install_keeps_the_bytes(clusters, model_dir):
    store = tkvo.ObjectPlaneKvStore()
    k, v, ln = _torch_slab(4, torch.float32)
    store.put("a", (k, v, ln))
    k2, v2, _ = store.get("a")
    store.delete("a")
    gc.collect()
    for i in range(3):                   # refill the arena
        store.put(f"b{i}", (-k, -v, ln))
    assert torch.equal(k2, k) and torch.equal(v2, v)
    # Through the engine: the install reads what the fetch returned.
    want = _evict_run(_port(model_dir, kv_idle_evict_s=0.0))
    deleting = _DeletingStore()
    eng = _port(model_dir, kv_idle_evict_s=0.0, kv_offload_store=deleting)
    assert _evict_run(eng) == want
    assert set(deleting._refs) == {"s", "junk"}


# ------------------------------------------------------ engine options

def _pressure_run(eng, sampling_cls):
    _turn(eng, "idle", [5, 9, 17], 4)
    out = {"state": eng._sessions["idle"].state,
           "free": list(eng._free_slots)}
    try:
        eng.add_request([1, 2, 3], sampling_cls(max_tokens=4),
                        session_id="fresh")
        out["add"] = "admitted"
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        out["add"] = (type(e).__name__, re.sub(r"\d+\.\d+", "<t>", str(e)),
                      e.retry_after_s > 0)
    out["after"] = eng._sessions["idle"].state
    out["counters"] = _counters(eng)
    return out


@pytest.mark.parametrize("evict", [True, False])
def test_kv_evict_on_pressure_matches_jax(model_dir, evict):
    kw = dict(slots=1, max_waiting=0, kv_evict_on_pressure=evict)
    want = _pressure_run(_jax(model_dir, **kw), JaxSampling)
    got = _pressure_run(_port(model_dir, **kw), SamplingParams)
    assert got == want
    if evict:
        assert got["add"] == "admitted" and got["after"] == "offloaded"
        assert got["counters"]["pressure_evictions"] == 1
    else:
        assert got["add"][0] == "BackPressureError"
        assert got["after"] == "resident"
        assert got["counters"]["pressure_evictions"] == 0


def _queued_without_eviction(eng, sampling_cls):
    """max_waiting=None and no pressure eviction: a fresh request waits
    behind the idle session's slot; the idle sweep then frees it."""
    _turn(eng, "idle", [5, 9, 17], 4)
    eng.add_request([1, 2, 3], sampling_cls(max_tokens=3))
    for _ in range(3):
        eng.step()
    waited = (len(eng._waiting), eng._sessions["idle"].state)
    eng._kv_idle_evict_s = 0.0
    outs = list(_drain(eng).values())
    return waited, [[int(t) for t in o.token_ids] for o in outs], \
        _counters(eng)


def test_without_pressure_eviction_a_request_waits_as_in_jax(model_dir):
    kw = dict(slots=1, kv_evict_on_pressure=False)
    want = _queued_without_eviction(_jax(model_dir, **kw), JaxSampling)
    got = _queued_without_eviction(_port(model_dir, **kw), SamplingParams)
    assert got == want
    assert got[0] == (1, "resident") and got[2]["idle_evictions"] == 1


def _idle_polls(loop_cls, eng, idle_sleep_s, window_s):
    """How often an idle loop looks for work in ``window_s``."""
    calls = []
    real = eng.has_unfinished

    def counting():
        calls.append(time.monotonic())
        return real()

    eng.has_unfinished = counting
    loop = loop_cls(eng, idle_sleep_s=idle_sleep_s)
    try:
        time.sleep(window_s)
        return len(calls)
    finally:
        loop.shutdown()


@pytest.mark.parametrize("idle_sleep_s", [0.005, 0.25])
def test_idle_sleep_s_is_honoured(model_dir, idle_sleep_s):
    window = 0.6
    for loop_cls, eng in ((JaxLoop, _jax(model_dir)),
                          (EngineLoop, _port(model_dir))):
        idle = _idle_polls(loop_cls, eng, idle_sleep_s, window)
        # At most one poll a nap (plus the first): the loop really
        # sleeps idle_sleep_s between looks.
        assert idle <= window / idle_sleep_s + 2, (loop_cls, idle)
        assert idle >= (2 if idle_sleep_s >= 0.25 else 10), (loop_cls, idle)


def test_a_submission_wakes_a_loop_with_a_long_nap(model_dir):
    for loop_cls, eng, sampling_cls in (
            (JaxLoop, _jax(model_dir), JaxSampling),
            (EngineLoop, _port(model_dir), SamplingParams)):
        loop = loop_cls(eng, idle_sleep_s=120.0)
        try:
            time.sleep(0.1)                      # the loop is napping
            t0 = time.monotonic()
            out = loop.submit([5, 9, 17], sampling_cls(max_tokens=2)).wait(
                DEADLINE_S)
            assert time.monotonic() - t0 < 60.0, loop_cls
            assert len(out.token_ids) == 2
        finally:
            loop.shutdown()
