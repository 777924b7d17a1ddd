"""The port's local-mode runtime (``init(local_mode=True)``, tasks,
actors, ``put`` / ``get`` / ``wait``) against the JAX package's, the
same scenario run through both with the same inputs (made from a seeded
numpy generator).  Each scenario is a counterpart of a test in
tests/test_api_local.py and keeps its assertions; the outcomes of the
two packages must then be equal: values, exception types and messages,
``num_returns``, error lineage, named and killed actors and the split
``wait`` returns.  Messages are compared after the package's own name
and random actor ids are masked; a task error's traceback is compared by
its last line (the frames name each package's files)."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from ant_ray_tpu import exceptions as jexc
from ant_ray_tpu_torch import exceptions as texc
from ant_ray_tpu_torch._private import serialization as tser


def _mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{24}\b", "<id>", message)


def _error(e: BaseException):
    """An exception in a form both packages can be compared by; a task
    error's cause (itself a task error along a lineage) likewise."""
    if isinstance(e, (jexc.TaskError, texc.TaskError)):
        return (type(e).__name__, e.function_name, _error(e.cause),
                e.remote_traceback.strip().splitlines()[-1])
    return (type(e).__name__, _mask(str(e)))


def _outcome(fn):
    """("ok", value) or ("raise", the exception's comparable form)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", _error(e))


def _run(art, scenario):
    art.init(local_mode=True)
    try:
        return scenario(art, np.random.default_rng(0))
    finally:
        art.shutdown()


def task_roundtrip(art, rng):
    @art.remote
    def add(a, b):
        return a + b

    a, b = (int(v) for v in rng.integers(0, 1000, 2))
    out = art.get(add.remote(a, b))
    assert out == a + b
    return out


def task_with_ref_args(art, rng):
    @art.remote
    def double(x):
        return 2 * x

    ref = art.put(int(rng.integers(0, 1000)))
    return art.get(double.remote(ref))


def chained_tasks(art, rng):
    @art.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(9):
        ref = inc.remote(ref)
    out = art.get(ref)
    assert out == 10
    return out


def num_returns(art, rng):
    @art.remote(num_returns=2)
    def pair():
        return 1, 2

    refs = pair.remote()
    r1, r2 = refs
    assert (art.get(r1), art.get(r2)) == (1, 2)
    return len(refs), art.get(r1), art.get(r2)


def task_error_propagates(art, rng):
    @art.remote
    def boom():
        raise ValueError("boom")

    ref = boom.remote()
    return _outcome(lambda: art.get(ref))


def error_lineage(art, rng):
    @art.remote
    def boom():
        raise ValueError("boom")

    @art.remote
    def passthrough(x):
        return x

    ref = passthrough.remote(boom.remote())
    return _outcome(lambda: art.get(ref))


def actor_basics(art, rng):
    @art.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    out = [art.get(c.incr.remote()), art.get(c.incr.remote(5))]
    assert out == [11, 16]
    return out


def named_actor(art, rng):
    @art.remote
    class Holder:
        def value(self):
            return "hi"

    Holder.options(name="h1").remote()
    h = art.get_actor("h1")
    return (art.get(h.value.remote()),
            _outcome(lambda: art.get_actor("missing")),
            _outcome(lambda: Holder.options(name="h1").remote()),
            art.get(Holder.options(name="h1", get_if_exists=True).remote()
                    .value.remote()))


def kill_actor(art, rng):
    @art.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    before = art.get(a.ping.remote())
    art.kill(a)
    return before, _outcome(lambda: art.get(a.ping.remote()))


def wait(art, rng):
    @art.remote
    def f(i):
        return i

    refs = [f.remote(i) for i in range(4)]
    ready, not_ready = art.wait(refs, num_returns=2)
    assert len(ready) == 2
    return ([art.get(r) for r in ready], [art.get(r) for r in not_ready],
            _outcome(lambda: art.wait(refs, num_returns=5)),
            _outcome(lambda: art.wait(refs[0])))


def put_get_many_types(art, rng):
    values = [1, "s", {"a": [1, 2]}, rng.standard_normal(10)]
    outs = [art.get(art.put(v)) for v in values]
    for value, out in zip(values, outs):
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(out, value)
        else:
            assert out == value
    return [o.tolist() if isinstance(o, np.ndarray) else o for o in outs]


def options_override(art, rng):
    @art.remote
    def f():
        return 1

    return (art.get(f.options(num_cpus=2).remote()),
            _outcome(lambda: f.options(no_such_option=1)))


def reinit_error(art, rng):
    first = _outcome(lambda: art.init(local_mode=True))
    ctx = art.init(local_mode=True, ignore_reinit_error=True)
    return first, ctx.mode


def direct_call_raises(art, rng):
    @art.remote
    def f():
        return 1

    @art.remote
    class A:
        pass

    return _outcome(f), _outcome(A)


def get_type_check(art, rng):
    return _outcome(lambda: art.get([1, 2, 3]))


def method_num_returns(art, rng):
    @art.remote
    class A:
        @art.method(num_returns=2)
        def pair(self):
            return 1, 2

    a = A.remote()
    r1, r2 = a.pair.remote()
    out = art.get([r1, r2])
    assert out == [1, 2]
    return out


def wait_empty_list(art, rng):
    out = art.wait([])
    assert out == ([], [])
    return out


def stream_local_mode(art, rng):
    @art.remote(num_returns="streaming")
    def produce():
        yield 1
        yield 2

    out = [art.get(r) for r in produce.remote()]
    assert out == [1, 2]
    return out


def resources_and_nodes(art, rng):
    return (art.cluster_resources(), art.available_resources(),
            art.nodes(), art.is_initialized())


def put_of_a_ref_refused(art, rng):
    return _outcome(lambda: art.put(art.put(1)))


SCENARIOS = [task_roundtrip, task_with_ref_args, chained_tasks, num_returns,
             task_error_propagates, error_lineage, actor_basics, named_actor,
             kill_actor, wait, put_get_many_types, options_override,
             reinit_error, direct_call_raises, get_type_check,
             method_num_returns, wait_empty_list, stream_local_mode,
             resources_and_nodes, put_of_a_ref_refused]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_local_mode_matches_jax_package(scenario):
    want = _run(jart, scenario)
    got = _run(tart, scenario)
    assert got == want


def test_error_outcomes_name_the_failure():
    """The compared outcomes are the ones test_api_local.py expects."""
    assert _run(tart, task_error_propagates) == ("raise", (
        "TaskError", f"{__name__}.task_error_propagates.<locals>.boom",
        ("ValueError", "boom"), "ValueError: boom"))
    lineage = _run(tart, error_lineage)[1]
    assert lineage[:2] == (
        "TaskError", f"{__name__}.error_lineage.<locals>.passthrough")
    assert lineage[2][:3] == (
        "TaskError", f"{__name__}.error_lineage.<locals>.boom",
        ("ValueError", "boom"))
    assert _run(tart, kill_actor)[1] == (
        "raise", ("ActorDiedError", "Actor ActorID(<id>) died: killed"))
    assert _run(tart, get_type_check)[1][0] == "TypeError"


def test_mixed_tensor_numpy_serialization():
    """Counterpart of test_mixed_jax_numpy_serialization: a tensor's
    buffer must not disturb the pickle-5 buffer order of a numpy array
    beside it; both packages give the same numpy values."""
    from ant_ray_tpu._private import serialization as jser

    jout = jser.deserialize(jser.serialize(
        (jnp.arange(4, dtype=jnp.float32), np.arange(1000))))
    tout = tser.deserialize(tser.serialize(
        (torch.arange(4, dtype=torch.float32), np.arange(1000))))
    assert isinstance(tout[0], torch.Tensor)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1], jout[1])
    np.testing.assert_array_equal(tout[1], np.arange(1000))


def _gpu_entry() -> dict:
    """The ``GPU`` entry the port's detector adds on a host with cards
    (none where there is no card)."""
    from ant_ray_tpu_torch._private.accelerators import gpu

    n = gpu.num_gpus()
    return {"GPU": float(n)} if n else {}


@pytest.mark.parametrize("address", ["art://127.0.0.1:10001"])
def test_init_without_local_mode_raises_not_implemented(address):
    """The client (``art://``, connecting from outside the cluster) is
    ported (ROADMAP queue A item 6.6): with no client server at the
    address, ``init`` fails as the JAX package's does, and the runtime
    is left unconnected (tests/test_torch_client.py drives a server)."""
    errors = []
    for art in (jart, tart):
        with pytest.raises(Exception) as ei:
            art.init(address)
        errors.append(type(ei.value).__name__)
        assert not art.is_initialized()
    assert errors[0] == errors[1], errors


def test_init_starts_a_fresh_cluster():
    """``init()`` with no address starts a GCS and a node daemon of the
    port, runs a task in a worker process, and ``shutdown()`` removes
    the session directory."""
    ctx = tart.init(num_cpus=1)
    try:
        assert ctx.mode == "cluster"
        assert tart.cluster_resources() == {"CPU": 1.0, **_gpu_entry()}

        @tart.remote
        def pid():
            return os.getpid()

        assert tart.get(pid.remote()) != os.getpid()
        from ant_ray_tpu_torch._private.worker import global_worker

        session_dir = global_worker.runtime.session_dir
        assert os.path.basename(session_dir).startswith(
            "art_torch_session_")
        assert os.path.isdir(session_dir)
    finally:
        tart.shutdown()
    assert not os.path.exists(session_dir)


def test_init_with_address_connects():
    """``address="host:port"`` joins a running cluster as a driver: its
    tasks run there, and ``shutdown()`` leaves that cluster running."""
    from ant_ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 1})
    try:
        tart.init(address=cluster.address)
        try:
            @tart.remote
            def double(x):
                return 2 * x

            assert tart.get(double.remote(21)) == 42
            assert len(tart.nodes()) == 1
        finally:
            tart.shutdown()
        tart.init(address=cluster.address)
        try:
            assert tart.cluster_resources() == {"CPU": 1.0, **_gpu_entry()}
        finally:
            tart.shutdown()
    finally:
        cluster.shutdown()


def test_api_before_init_starts_a_cluster():
    """The first API call before ``init`` starts a cluster, as in the
    JAX package (``ART_ADDRESS`` would name one to join instead)."""
    @tart.remote
    def f():
        return 1

    assert not tart.is_initialized()
    try:
        assert tart.get(f.remote()) == 1
        assert tart.is_initialized()
        from ant_ray_tpu_torch._private.worker import (CLUSTER_MODE,
                                                       global_worker)

        assert global_worker.mode == CLUSTER_MODE
    finally:
        tart.shutdown()
    assert not tart.is_initialized()


def test_system_config_applies_until_the_next_init(monkeypatch):
    """``_system_config`` sets a flag that the object store reads, exports
    nothing to the environment, and the next init() starts from the
    defaults again."""
    import os

    from ant_ray_tpu_torch._private.config import Config, global_config

    monkeypatch.delenv("ART_MAX_SPILL_BYTES", raising=False)
    tart.init(local_mode=True, _system_config={"max_spill_bytes": 4096})
    try:
        assert global_config().max_spill_bytes == 4096
    finally:
        tart.shutdown()
    assert "ART_MAX_SPILL_BYTES" not in os.environ
    tart.init(local_mode=True)
    try:
        assert global_config().max_spill_bytes == Config().max_spill_bytes
    finally:
        tart.shutdown()
    monkeypatch.setenv("ART_MAX_SPILL_BYTES", "1234")
    assert Config().apply_env_overrides().max_spill_bytes == 1234


@pytest.mark.parametrize("flag,item", [
    ("no_such_flag", "a flag of neither package"),
    ("lockcheck_hold_budget_s", "item 6.6, lockcheck"),
    ("lockcheck", "item 6.6, lockcheck"),
    ("tpu_chips_override", "item 9, GPU placement"),
    ("testing_preemption_notice", "item 9, GPU placement"),
    ("preemption_poll_interval_s", "item 9, GPU placement"),
    ("worker_lease_timeout_s", "item none: no module")])
def test_system_config_rejects_flags_the_port_does_not_read(flag, item):
    """A flag whose reader is not ported fails loudly, naming the
    ROADMAP item that brings it, instead of being set and never read."""
    with pytest.raises(ValueError, match=f"Unknown config flag: {flag} "
                                         f".*{item}"):
        tart.init(local_mode=True, _system_config={flag: 1})
    assert not tart.is_initialized()


def test_system_config_carries_every_flag_a_ported_module_reads():
    """The cluster's flags come with their readers: each flag of the
    JAX package's table is either carried, with the same default, or
    named in the table of unported flags."""
    import dataclasses

    from ant_ray_tpu._private.config import Config as JConfig
    from ant_ray_tpu_torch._private.config import UNPORTED_FLAGS, Config

    jax_flags = {f.name: f.default for f in dataclasses.fields(JConfig)}
    port_flags = {f.name: f.default for f in dataclasses.fields(Config)}
    assert set(port_flags) | set(UNPORTED_FLAGS) == set(jax_flags)
    assert not set(port_flags) & set(UNPORTED_FLAGS)
    assert all(port_flags[k] == jax_flags[k] for k in port_flags)
    assert {"max_inline_object_size", "hot_wire_enabled",
            "object_transfer_chunk_size", "heartbeat_period_s",
            "data_inflight_tasks", "data_inflight_bytes",
            "data_target_block_bytes", "cpu_profile_hz",
            "cpu_profile_publish_period_s", "cpu_profile_max_stacks",
            "include_dashboard", "enable_node_agent",
            "device_stats_interval_s", "export_task_events",
            "enable_insight", "enable_cgroups", "cgroup_root",
            "cgroup_workers_memory_max", "cgroup_workers_cpu_weight",
            "gcs_ha_lease_ttl_s", "gcs_ha_renew_period_s",
            "gcs_ha_sync_period_s"} <= set(port_flags)
    tart.init(local_mode=True,
              _system_config={"max_inline_object_size": 4096,
                              "data_inflight_tasks": 3,
                              "data_target_block_bytes": 512})
    try:
        from ant_ray_tpu_torch._private.config import global_config

        assert global_config().max_inline_object_size == 4096
        assert (global_config().data_inflight_tasks,
                global_config().data_target_block_bytes) == (3, 512)
    finally:
        tart.shutdown()


@pytest.mark.parametrize("kwargs", [
    {"num_cpus": 2}, {"num_gpus": 1}, {"num_tpus": 1},
    {"resources": {"GPU": 1}}, {"object_store_memory": 1 << 30},
    {"namespace": "ns"}])
def test_init_local_mode_with_cluster_only_arguments_raises(kwargs):
    """Local mode starts no cluster, so an argument that sizes or names
    one has nothing to act on: it fails instead of being dropped."""
    with pytest.raises(ValueError,
                       match=f"{next(iter(kwargs))}=.*local mode"):
        tart.init(local_mode=True, **kwargs)
    assert not tart.is_initialized()


def test_tasks_and_actors_pass_tensors_as_they_are():
    """Local mode moves values by reference: a task's tensor result is
    the tensor the function returned (no copy, no device change)."""
    tart.init(local_mode=True)
    try:
        made = []

        @tart.remote
        def make(n):
            made.append(torch.arange(n, dtype=torch.bfloat16))
            return made[-1]

        @tart.remote
        class Sum:
            def total(self, t):
                return t.float().sum().item()

        ref = make.remote(8)
        assert tart.get(ref) is made[0]
        assert tart.get(Sum.remote().total.remote(ref)) == 28.0
        x = torch.ones(3)
        assert tart.get(tart.put(x)) is x
    finally:
        tart.shutdown()


def test_exports_match_the_jax_package():
    assert set(tart.__all__) == set(jart.__all__) | {"resolve_device"}
    for name in tart.__all__:
        assert getattr(tart, name) is not None


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_runtime_overhead_probe(package):
    """chip_smoke.py's probe of the runtime's own cost per call (no-op
    actor calls and tasks in turns with the same method and function
    called directly) runs through either package's local mode: every
    call returns its argument and every median is a positive time."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_probe", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    art = tart if package == "torch" else jart
    art.init(local_mode=True)
    try:
        got = smoke.runtime_overhead(art, calls=50)
    finally:
        art.shutdown()
    times = ("actor_call_us", "direct_method_us", "task_us", "direct_fn_us")
    assert set(got) == {"calls", "actor_overhead_us", "task_overhead_us",
                        *times}
    assert got["calls"] == 50
    assert all(got[k] > 0 for k in times)
    assert got["actor_overhead_us"] == pytest.approx(
        got["actor_call_us"] - got["direct_method_us"])
