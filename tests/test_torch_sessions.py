"""Sessions with KV offload and restore, EngineLoop and the step-profiler
hook of the port's LLMEngine, against the JAX package's engine on the
same carried weights (``tiny``, fp32, CPU; slots 2, max_seq 96, chunked
prefill of 8 tokens, as tests/test_llm_sessions.py runs the reference).
The scheduler is a copy, so greedy tokens and the eviction and restore
counters must be equal; sampled streams can only be held to the port's
own uninterrupted run, since ``torch.Generator`` and ``jax.random`` give
different bits.  Slabs round-trip bit for bit.  Tolerance: tokens exact,
slabs bitwise."""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

import jax

from ant_ray_tpu.llm import LLMEngine as JaxEngine
from ant_ray_tpu.llm import SamplingParams as JaxSampling
from ant_ray_tpu.models import llama as jl
from ant_ray_tpu.observability.step_profiler import \
    StepProfiler as JaxProfiler
from ant_ray_tpu_torch.exceptions import BackPressureError, KVRestoreError
from ant_ray_tpu_torch.llm import EngineLoop, LLMEngine, SamplingParams
from ant_ray_tpu_torch.llm.kv_offload import KvStoreError, LocalKvStore
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
from ant_ray_tpu_torch.observability import StepProfiler, tracing_plane

DEADLINE_S = 120
COUNTERS = ("offloads", "restores", "pressure_evictions", "idle_evictions",
            "restore_failures")


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jl.CONFIGS["tiny"], jax.random.PRNGKey(7))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                    tl.CONFIGS["tiny"], device="cpu")
    return jparams, tparams


def _kw(kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 96)
    kw.setdefault("prefill_chunk_tokens", 8)
    return kw


def _port(weights, **kw):
    return LLMEngine("tiny", weights[1], device="cpu", **_kw(kw))


def _jax(weights, **kw):
    return JaxEngine(jl.CONFIGS["tiny"], weights[0], **_kw(kw))


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


def _turn(eng, sid, prompt, n, **kw):
    eng.add_request(list(prompt), _sampling(eng, n, **kw), admit=False,
                    session_id=sid)
    outs = list(_drain(eng).values())
    assert len(outs) == 1
    return [int(t) for t in outs[0].token_ids]


def _counters(eng):
    return {key: eng.stats[key] for key in COUNTERS}


# ------------------------------------------------- offload/restore parity

def _idle_evict_run(eng):
    got = []
    for prompt, n in ([5, 9, 17], 6), ([3, 88, 41, 2], 6), ([11, 12], 6):
        got.append(_turn(eng, "s", prompt, n))
        eng.step()                   # idle sweep fires (cutoff = now)
        assert eng._sessions["s"].state == "offloaded"
    return got


def test_idle_evict_then_restore_matches_jax(weights):
    jeng = _jax(weights, kv_idle_evict_s=0.0)
    want = _idle_evict_run(jeng)
    eng = _port(weights, kv_idle_evict_s=0.0)
    assert _idle_evict_run(eng) == want
    assert _counters(eng) == _counters(jeng)
    assert eng.stats["idle_evictions"] >= 2 and eng.stats["restores"] >= 2
    assert set(eng.stats) == set(jeng.stats)


def _beyond_slots_run(eng, n_sessions=4):
    first = [_turn(eng, f"s{i}", [5 + i, 9, 17 + i], 5)
             for i in range(n_sessions)]
    resident = eng.resident_sessions()
    second = [_turn(eng, f"s{i}", [99, 98 + i], 5)
              for i in range(n_sessions)]
    return first, second, resident


def test_sessions_beyond_slots_match_jax(weights):
    jeng = _jax(weights)
    want = _beyond_slots_run(jeng)
    eng = _port(weights)
    assert _beyond_slots_run(eng) == want
    assert want[2] == 4 > eng.slots
    assert _counters(eng) == _counters(jeng)
    assert eng.stats["pressure_evictions"] >= 2
    assert eng.stats["restores"] >= 2


def _forced_evict_run(eng, **kw):
    prompt, n = [5, 9, 17, 3, 88, 41], 16
    eng.add_request(prompt, _sampling(eng, n, **kw), admit=False,
                    session_id="s")
    for _ in range(6):               # past prefill, a few tokens in
        eng.step()
    sess = eng._sessions["s"]
    assert sess.current is not None and sess.current.generated
    assert eng.evict_session("s", force=True)
    assert sess.state == "offloaded" and sess.paused is not None
    outs = list(_drain(eng).values())
    assert len(outs) == 1
    return [int(t) for t in outs[0].token_ids]


@pytest.mark.parametrize("sampling", ["greedy", "temperature"])
def test_forced_mid_generation_evict(weights, sampling):
    """Greedy: equal to the JAX engine's forced eviction.  Temperature:
    equal to the port's own uninterrupted run — the request's generator
    rides the request, not the slot."""
    kw = ({} if sampling == "greedy"
          else {"temperature": 0.7, "seed": 123})
    eng = _port(weights)
    got = _forced_evict_run(eng, **kw)
    if sampling == "greedy":
        want = _forced_evict_run(_jax(weights))
    else:
        want = _turn(_port(weights), "s", [5, 9, 17, 3, 88, 41], 16, **kw)
    assert got == want
    assert eng.stats["offloads"] == 1 and eng.stats["restores"] == 1


def test_pressure_eviction_admits_instead_of_shedding(weights):
    eng = _port(weights, slots=1, max_waiting=0)
    _turn(eng, "idle", [5, 9, 17], 4)
    assert eng._sessions["idle"].state == "resident"
    assert not eng._free_slots
    eng.add_request([1, 2, 3], SamplingParams(max_tokens=4),
                    session_id="fresh")
    assert eng._sessions["idle"].state == "offloaded"
    assert eng.stats["pressure_evictions"] == 1
    _drain(eng)

    busy = _port(weights, slots=1, max_waiting=0)
    busy.add_request(list(range(1, 40)), SamplingParams(max_tokens=30),
                     admit=False)
    busy.step()
    with pytest.raises(BackPressureError) as err:
        busy.add_request([4, 5], SamplingParams(max_tokens=2))
    assert err.value.retry_after_s > 0
    assert busy.stats["pressure_evictions"] == 0


def test_bucketed_continuation_raises_value_error(weights):
    eng = _port(weights, prefill_chunk_tokens=None)
    eng.add_request([5, 9, 17], SamplingParams(max_tokens=8), admit=False,
                    session_id="s")
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.add_request([3, 4], SamplingParams(max_tokens=4), admit=False,
                        session_id="s")
    outs = list(_drain(eng).values())
    assert len(outs) == 1 and outs[0].finish_reason != "error"


def test_restore_failure_fails_one_session_typed(weights):
    store = LocalKvStore()
    eng = _port(weights, kv_offload_store=store)
    _turn(eng, "s", [5, 9, 17], 4)
    assert eng.evict_session("s")
    store.delete("s")                       # the slab vanishes
    events = []
    eng.add_request([21, 22], SamplingParams(max_tokens=4), admit=False,
                    session_id="s", on_event=events.append)
    eng.add_request([7, 8, 9], SamplingParams(max_tokens=6), admit=False)
    outs = _drain(eng)
    failed = [o for o in outs.values() if o.finish_reason == "error"]
    ok = [o for o in outs.values() if o.finish_reason != "error"]
    assert len(failed) == 1 and "restore" in failed[0].error
    assert len(ok) == 1 and len(ok[0].token_ids) == 6
    errors = [e["error"] for e in events if e["type"] == "error"]
    assert len(errors) == 1 and isinstance(errors[0], KVRestoreError)
    assert errors[0].session_id == "s"
    with pytest.raises(KvStoreError):
        store.get("s")
    assert eng.stats["restore_failures"] == 1
    assert eng._sessions["s"].state == "failed"
    # The session id is reusable: a fresh request re-prefills from zero.
    assert len(_turn(eng, "s", [1, 2, 3], 3)) == 3


class _HeldStore(LocalKvStore):
    """LocalKvStore whose get() blocks until released — pins a restore
    in flight so the test can watch decode run under it."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()

    def get(self, handle):
        if not self.release.wait(DEADLINE_S):
            raise TimeoutError("the test never released the restore")
        return super().get(handle)


def test_restore_overlaps_decode(weights):
    store = _HeldStore()
    eng = _port(weights, kv_offload_store=store)
    _turn(eng, "s", [5, 9, 17], 4)
    assert eng.evict_session("s")
    eng.add_request([21, 22], SamplingParams(max_tokens=4), admit=False,
                    session_id="s")
    other = eng.add_request([7, 8, 9], SamplingParams(max_tokens=6),
                            admit=False)
    outs = {}
    deadline = time.monotonic() + DEADLINE_S
    while eng.has_unfinished():
        for out in eng.step():
            outs[out.request_id] = out
        if other in outs and not store.release.is_set():
            # The unrelated request finished start to end while the
            # fetch was pinned: the step loop never waited for it.
            assert eng.stats["restores"] == 0
            assert eng._sessions["s"].state == "restoring"
            store.release.set()
        assert time.monotonic() < deadline, "engine wedged on restore"
    assert store.release.is_set() and len(outs) == 2
    assert eng.stats["restores"] == 1 and eng.stats["restore_wait_s"] > 0


def test_kv_restore_error_pickles_with_session_id():
    err = KVRestoreError("session 's' lost", session_id="s")
    back = pickle.loads(pickle.dumps(err))
    assert isinstance(back, KVRestoreError)
    assert back.session_id == "s" and "lost" in str(back)


# ------------------------------------------------------------ EngineLoop

def test_engine_loop_submit_stream_wait_and_sessions(weights):
    """Requests from several threads through one loop: each handle's
    streamed tokens equal its final output and the same requests run
    through a plain engine; evict_session and end_session run on the
    loop thread."""
    prompts = [[5 + i, 9, 17] for i in range(4)]
    want = [_turn(_port(weights, slots=4), f"w{i}", p, 5)
            for i, p in enumerate(prompts)]
    eng = _port(weights, slots=4)       # room for all: nothing evicted
    loop = EngineLoop(eng, metrics_interval_s=0.0)
    handles = [None] * len(prompts)

    def client(i):
        handles[i] = loop.submit(prompts[i], SamplingParams(max_tokens=5),
                                 session_id=f"s{i}" if i % 2 else None)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE_S)
            assert not t.is_alive()
        for i, h in enumerate(handles):
            out = h.wait(timeout=DEADLINE_S)
            streamed = [e["token_id"] for e in h if e["type"] == "token"]
            assert streamed == out.token_ids == want[i]
            assert h.ttft_s() is not None and h.ttft_s() > 0
        assert loop.evict_session("s1")
        assert eng._sessions["s1"].state == "offloaded"
        assert not loop.end_session("missing")
        assert loop.end_session("s1") and loop.end_session("s3")
        assert not eng._sessions
        assert sorted(eng._free_slots) == list(range(eng.slots))
        stats = loop.stats()
        assert set(stats) == set(EngineLoop.METRIC_NAMES)
        assert stats["art_llm_tokens_per_s"] >= 0
        # A trace context rides the request: the restore of a traced
        # continuation is attributed to it as an `llm:restore` span.
        ctx = tracing_plane.mint(sampled=True)
        loop.submit([4, 8, 15], SamplingParams(max_tokens=3),
                    session_id="t").wait(timeout=DEADLINE_S)
        offloaded = eng.stats["offload_bytes"]
        assert loop.evict_session("t")
        out = loop.submit([16, 23], SamplingParams(max_tokens=3),
                          session_id="t",
                          trace_ctx=ctx).wait(timeout=DEADLINE_S)
        assert len(out.token_ids) == 3 and out.error is None
        spans = [sp for sp in tracing_plane.recorder().snapshot()
                 if sp["trace_id"] == ctx.trace_id]
        assert [(sp["name"], sp["parent_id"], sp["attrs"]["session"],
                 sp["attrs"]["bytes"]) for sp in spans] == [
            ("llm:restore", ctx.span_id, "t",
             eng.stats["offload_bytes"] - offloaded)]
        assert loop.end_session("t")
    finally:
        loop.shutdown()
    assert not loop._thread.is_alive()


# -------------------------------------------------------------- profiler

def _profiled_run(eng):
    _turn(eng, "s", [5, 9, 17, 3, 88, 41, 2, 7, 1, 4], 4)   # two chunks
    eng.evict_session("s")
    _turn(eng, "s", [21, 22], 4)                            # restore
    return eng.profiler


def test_profiler_phases_and_summary_keys_match_jax(weights):
    jprof = _profiled_run(_jax(weights, profiler=JaxProfiler(
        publish=False)))
    prof = _profiled_run(_port(weights, profiler=StepProfiler()))
    names = [sorted(r.phases) for r in prof.step_records()]
    assert names == [sorted(r.phases) for r in jprof.step_records()]
    assert {"prefill", "decode", "restore_install"} <= set().union(*names)
    assert set(prof.summary()) == set(jprof.summary())
    assert prof.summary()["steps"] == jprof.summary()["steps"]
    assert prof.last.total_s > 0 and prof.last.mfu is None


def test_profiler_mfu_with_explicit_peak():
    prof = StepProfiler(flops_per_step=1e9, peak_flops=1e12, history=2)
    for _ in range(3):
        with prof.step():
            with prof.phase("decode"):
                time.sleep(0.001)
    records = prof.step_records()
    assert [r.step for r in records] == [1, 2]              # bounded window
    assert all(0 < r.mfu < 1 for r in records)
    assert prof.summary()["mfu_mean"] > 0
    assert 0 < records[-1].fraction("decode") <= 1


# ----------------------------------------------------------------- slabs

def _slab(dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    k = torch.randn((2, 16, 2, 8), generator=gen).to(dtype)
    return k, -k * 3, seed


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("spill", [False, True])
def test_local_store_roundtrip_bitwise(tmp_path, dtype, spill):
    store = (LocalKvStore(spill_dir=str(tmp_path), capacity_slabs=2)
             if spill else LocalKvStore())
    slabs = {f"s{i}": _slab(dtype, i) for i in range(5)}
    for key, slab in slabs.items():
        store.put(key, slab)
    assert store.spills == (3 if spill else 0)
    assert len(store._mem) == (2 if spill else 5)   # capacity holds
    files = sorted(tmp_path.iterdir())
    assert len(files) == store.spills == len(set(files))
    for key, (k, v, ln) in slabs.items():
        k2, v2, ln2 = store.get(key)
        assert k2.dtype == dtype and torch.equal(k2, k)
        assert torch.equal(v2, v) and ln2 == ln
    store.put("s0", slabs["s0"])          # supersedes its spill file
    for key in slabs:
        store.delete(key)
    assert not list(tmp_path.iterdir())
    with pytest.raises(KvStoreError):
        store.get("s0")


def test_extract_install_bitwise_on_bf16_cache():
    cfg = tl.CONFIGS["tiny"]
    cache = tl.init_kv_cache(cfg, 3, 32, device="cpu")
    cache["k"] = cache["k"].to(torch.bfloat16)
    cache["v"] = cache["v"].to(torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen))
    cache["length"][1] = 19
    k, v, ln = tl.extract_slot(cache, 1)
    assert k.is_contiguous() and k.shape == (cfg.n_layers, 32,
                                             cfg.n_kv_heads, cfg.head_dim)
    assert ln == 19 and k.dtype == torch.bfloat16
    before = {n: cache[n].clone() for n in ("k", "v")}
    with torch.inference_mode():
        tl.install_slot(cache, k, v, ln, 2)
    for name in ("k", "v"):
        assert torch.equal(cache[name][:, 2], before[name][:, 1])
        assert torch.equal(cache[name][:, :2], before[name][:, :2])
    assert cache["length"].tolist() == [0, 19, 19]
