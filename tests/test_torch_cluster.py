"""The port's cluster mode (``init(num_cpus=4)``: a GCS, a node daemon
and worker processes) against the JAX package's, the same scenario run
through both with the same inputs (made from a seeded numpy generator).
Each scenario is a counterpart of a test in tests/test_cluster.py or
tests/test_worker_pool.py and keeps its assertions; the outcomes of the
two packages must then be equal: values, exception types and messages,
``wait`` splits, named, detached and restarted actors, and error
lineage.  Messages are compared after the package's own name and random
ids are masked.

Each package has its own module-scoped cluster, started without
``_system_config`` (both packages read the same ``ART_*`` variables, so
an export by one would reach the other's processes); the scenarios run
one package after the other, but the cost per call is read with the two
packages' calls interleaved."""

import gc
import importlib
import os
import re
import time

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart


def _mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", message)


def _error(e: BaseException):
    """An exception in a form both packages can be compared by; a task
    error's cause likewise."""
    cause = getattr(e, "cause", None)
    if hasattr(e, "function_name") and hasattr(e, "remote_traceback"):
        return (type(e).__name__, e.function_name,
                _error(cause) if cause is not None else None,
                e.remote_traceback.strip().splitlines()[-1])
    return (type(e).__name__, _mask(str(e)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", _error(e))


def _children(pid: int) -> list[int]:
    out = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == pid:
            out.append(int(entry))
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode()
    except OSError:
        return ""


def _worker_of(art):
    return importlib.import_module(art.__name__ + "._private.worker")


def _warm(art):
    @art.remote
    def warm(i):
        time.sleep(0.2)
        return i

    # Fill the worker pool so timing-sensitive scenarios see warm workers.
    art.get([warm.remote(i) for i in range(4)])


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            for art in (jart, tart):
                _warm(art)
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _both(scenario):
    want = scenario(jart, np.random.default_rng(0))
    got = scenario(tart, np.random.default_rng(0))
    return want, got


# -------------------------------------------------- tests/test_worker_pool
# (first in the file: the burst test starts clusters of its own, before
# the module's clusters exist)


@pytest.mark.parametrize("art", [jart, tart], ids=["jax", "torch"])
def test_task_burst_spawns_bounded_workers(art):
    """A burst of queued tasks must not fork a process storm: spawns are
    capped by the worker pool even while many leases race."""
    art.init(num_cpus=2)
    try:
        @art.remote
        def tick(i):
            time.sleep(0.05)
            return i

        assert art.get([tick.remote(i) for i in range(16)],
                       timeout=120) == list(range(16))
        logs = os.path.join(_worker_of(art).global_worker.runtime
                            .session_dir, "logs")
        spawned = [f for f in os.listdir(logs) if f.startswith("worker-")]
        assert len(spawned) <= 2 + 2, \
            f"burst spawned {len(spawned)} workers on a 2-CPU node"
    finally:
        art.shutdown()


def _make_sweeper(art, owner: str, ping_fails: bool, gcs_nodes):
    """Minimal NodeManager shell driving _sweep_lease_owners: one
    LEASED worker owned by ``owner``, a fake client pool whose owner
    Ping fails (or not) and whose GCS returns ``gcs_nodes``."""
    nd = importlib.import_module(art.__name__ + "._private.node_daemon")
    ids = importlib.import_module(art.__name__ + "._private.ids")
    protocol = importlib.import_module(art.__name__ + "._private.protocol")

    mgr = object.__new__(nd.NodeManager)
    mgr._gcs_address = "gcs:1"
    handle = nd.WorkerHandle(worker_id=ids.WorkerID.from_random(),
                             proc=None, address="127.0.0.1:4000",
                             state=nd.LEASED, lease_owner=owner)
    mgr._workers = {handle.worker_id: handle}
    reclaimed = []
    mgr._reclaim_leases_of = reclaimed.append

    class _Client:
        def __init__(self, addr):
            self.addr = addr

        async def call_async(self, method, payload, timeout=None):
            if self.addr == "gcs:1" and method == "GetAllNodes":
                return gcs_nodes
            if ping_fails:
                raise protocol.RpcConnectionError(f"no route to {self.addr}")
            return "pong"

    class _Pool:
        def get(self, addr):
            return _Client(addr)

    mgr._clients = _Pool()
    return mgr, reclaimed


async def _run_sweeps(mgr, rounds: int):
    import asyncio

    now = getattr(mgr, "_test_now", 1000.0)
    for _ in range(rounds):
        now += 100.0                        # always past the interval
        mgr._sweep_lease_owners(now)
        while getattr(mgr, "_owner_sweep_running", False):
            await asyncio.sleep(0.01)
    mgr._test_now = now


def _strikes(art, value):
    cfg = importlib.import_module(
        art.__name__ + "._private.config").global_config()
    old, cfg.lease_owner_ping_strikes = cfg.lease_owner_ping_strikes, value
    return cfg, old


def _sweep_defers_when_gcs_says_node_alive(art):
    import asyncio

    ids = importlib.import_module(art.__name__ + "._private.ids")
    specs = importlib.import_module(art.__name__ + "._private.specs")
    owner = "10.9.9.9:7001"
    alive = {ids.NodeID.from_random(): specs.NodeInfo(
        node_id=ids.NodeID.from_random(), address="10.9.9.9:6000",
        alive=True)}
    mgr, reclaimed = _make_sweeper(art, owner, True, alive)
    cfg, old = _strikes(art, 2)
    try:
        asyncio.run(_run_sweeps(mgr, rounds=3))   # strikes 1..3 < 2*3
        early = list(reclaimed)
        asyncio.run(_run_sweeps(mgr, rounds=3))   # crosses 3x budget (6)
        return early, list(reclaimed)
    finally:
        cfg.lease_owner_ping_strikes = old


def _sweep_reclaims_when_gcs_confirms_death(art):
    import asyncio

    owner = "10.9.9.9:7001"
    mgr, reclaimed = _make_sweeper(art, owner, True, {})
    cfg, old = _strikes(art, 2)
    try:
        asyncio.run(_run_sweeps(mgr, rounds=1))
        early = list(reclaimed)                   # one strike: too early
        asyncio.run(_run_sweeps(mgr, rounds=1))
        return early, list(reclaimed)
    finally:
        cfg.lease_owner_ping_strikes = old


def _sweep_resets_strikes_on_successful_ping(art):
    import asyncio

    mgr, reclaimed = _make_sweeper(art, "10.9.9.9:7001", False, {})
    asyncio.run(_run_sweeps(mgr, rounds=5))
    return list(reclaimed), mgr._owner_ping_fails


@pytest.mark.parametrize("sweep", [
    _sweep_defers_when_gcs_says_node_alive,
    _sweep_reclaims_when_gcs_confirms_death,
    _sweep_resets_strikes_on_successful_ping,
], ids=lambda f: f.__name__.lstrip("_"))
def test_lease_owner_sweep_matches_jax_package(sweep):
    want, got = sweep(jart), sweep(tart)
    assert got == want
    assert got == {
        _sweep_defers_when_gcs_says_node_alive: ([], ["10.9.9.9:7001"]),
        _sweep_reclaims_when_gcs_confirms_death: ([], ["10.9.9.9:7001"]),
        _sweep_resets_strikes_on_successful_ping: ([], {}),
    }[sweep]


# ------------------------------------------------------ tests/test_cluster


def task_roundtrip(art, rng):
    @art.remote
    def add(a, b):
        return a + b

    a, b = (int(v) for v in rng.integers(0, 1000, 2))
    out = art.get(add.remote(a, b))
    assert out == a + b
    return out


def parallel_tasks(art, rng):
    @art.remote
    def slow(i):
        time.sleep(0.3)
        return i

    t0 = time.monotonic()
    out = art.get([slow.remote(i) for i in range(4)])
    # 4 tasks on 4 cpus run concurrently, not serially (4 * 0.3).
    assert time.monotonic() - t0 < 1.1
    return out


def chained_and_nested(art, rng):
    @art.remote
    def inc(x):
        return x + 1

    @art.remote
    def fan_in(*xs):
        return sum(xs)

    @art.remote
    def nested(depth):
        if depth == 0:
            return 0
        return art.get(nested.remote(depth - 1)) + 1

    return (art.get(fan_in.remote(*[inc.remote(i) for i in range(3)])),
            art.get(nested.remote(3)))


def large_object_plasma(art, rng):
    arr = rng.random(500_000)  # 4 MB > inline threshold
    ref = art.put(arr)
    np.testing.assert_array_equal(art.get(ref), arr)

    @art.remote
    def total(x):
        return float(x.sum())

    return art.get(total.remote(ref))


def large_task_return(art, rng):
    @art.remote
    def big(seed):
        return np.random.default_rng(seed).random(400_000)

    out = art.get(big.remote(int(rng.integers(1 << 30))))
    return out.shape, float(out.sum())


def error_propagation(art, rng):
    @art.remote
    def boom():
        raise ValueError("kaboom")

    @art.remote
    def passthrough(x):
        return x

    return (_outcome(lambda: art.get(boom.remote())),
            _outcome(lambda: art.get(passthrough.remote(boom.remote()))))


def get_timeout(art, rng):
    @art.remote
    def slow():
        time.sleep(2)
        return 1

    ref = slow.remote()
    timed_out = _outcome(lambda: art.get(ref, timeout=0.3))
    return timed_out, art.get(ref)  # still resolvable afterwards


def wait(art, rng):
    @art.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast = sleepy.remote(0.05)
    slow = sleepy.remote(3.0)
    ready, not_ready = art.wait([fast, slow], num_returns=1, timeout=2.0)
    assert ready == [fast] and not_ready == [slow]
    return [art.get(r) for r in ready], len(not_ready)


def wait_blocks_until_ready(art, rng):
    @art.remote
    def sleepy(t):
        time.sleep(t)
        return t

    ref = sleepy.remote(0.8)
    t0 = time.monotonic()
    ready, not_ready = art.wait([ref], num_returns=1, timeout=30.0)
    elapsed = time.monotonic() - t0
    assert ready == [ref] and not not_ready
    assert 0.5 <= elapsed < 25.0, elapsed
    pending_ref = sleepy.remote(5.0)
    ready, not_ready = art.wait([pending_ref], num_returns=1, timeout=0)
    assert not ready and not_ready == [pending_ref]
    return len(ready), len(not_ready)


def wait_num_returns_caps_ready(art, rng):
    @art.remote
    def quick(i):
        return i

    refs = [quick.remote(i) for i in range(4)]
    art.get(list(refs))
    ready, not_ready = art.wait(refs, num_returns=1, timeout=5.0)
    split = (len(ready), len(not_ready))
    assert {r.id for r in ready + not_ready} == {r.id for r in refs}
    seen, pending = [], refs
    while pending:
        done, pending = art.wait(pending, num_returns=1, timeout=5.0)
        seen.extend(art.get(done))
    return split, sorted(seen)


def large_args_promoted_to_plasma(art, rng):
    big = rng.standard_normal(1_000_000)  # 8 MB >> 100 KB threshold
    inner = art.put({"tag": int(rng.integers(100))})

    @art.remote
    def consume(arr, nested):
        return float(arr.sum()), art.get(nested[0])["tag"]

    total, tag = art.get(consume.remote(big, [inner]))
    assert total == float(big.sum())
    return total, tag


def large_actor_ctor_args_promoted(art, rng):
    big = rng.standard_normal(1_000_000)

    @art.remote(max_restarts=1)
    class Holder:
        def __init__(self, arr):
            self.total = float(arr.sum())

        def get(self):
            return self.total

        def crash(self):
            os._exit(1)

    h = Holder.remote(big)
    first = art.get(h.get.remote())
    h.crash.remote()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            return first, art.get(h.get.remote())  # restarted, same args
        except art.exceptions.ActorDiedError:
            time.sleep(0.2)
    raise AssertionError("actor did not restart in time")


def nested_ref_pins_released_with_outer(art, rng):
    rt = _worker_of(art).global_worker.runtime
    inner = art.put(123)
    outer = art.put([inner])
    oid = outer.id
    before = (oid in rt._contained_pins, rt._pins.get(inner.id, 0) >= 1)
    del outer
    gc.collect()
    after = (oid in rt._contained_pins, rt._pins.get(inner.id, 0))
    return before, after, art.get(inner)


def actor_state_and_ordering(art, rng):
    @art.remote
    class Counter:
        def __init__(self):
            self.values = []

        def push(self, v):
            self.values.append(v)
            return len(self.values)

        def get_all(self):
            return self.values

    c = Counter.remote()
    values = [int(v) for v in rng.integers(0, 100, 20)]
    for v in values:
        c.push.remote(v)
    out = art.get(c.get_all.remote())
    assert out == values
    return out


def actor_passed_to_task(art, rng):
    @art.remote
    class Store:
        def __init__(self):
            self.v = 0

        def set(self, v):
            self.v = v

        def get(self):
            return self.v

    @art.remote
    def writer(store, v):
        art.get(store.set.remote(v))
        return "done"

    s = Store.remote()
    return art.get(writer.remote(s, 42)), art.get(s.get.remote())


def named_actor_cross_process(art, rng):
    @art.remote
    class Registry:
        def ping(self):
            return "pong"

    Registry.options(name="reg", lifetime="detached").remote()

    @art.remote
    def lookup():
        return art.get(art.get_actor("reg").ping.remote())

    return (art.get(lookup.remote()),
            _outcome(lambda: art.get_actor("no_such_actor")))


def actor_crash_and_kill(art, rng):
    @art.remote
    class Fragile:
        def ping(self):
            return "ok"

        def crash(self):
            os._exit(1)

    a = Fragile.remote()
    out = [art.get(a.ping.remote())]
    out.append(_outcome(lambda: art.get(a.crash.remote()))[1][0])
    out.append(_outcome(lambda: art.get(a.ping.remote()))[1][0])
    b = Fragile.remote()
    out.append(art.get(b.ping.remote()))
    art.kill(b)
    out.append(_outcome(lambda: art.get(b.ping.remote())))
    return out


def actor_restart(art, rng):
    @art.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def incr(self):
            self.calls += 1
            return self.calls

        def die(self):
            os._exit(1)

    p = Phoenix.remote()
    first = art.get(p.incr.remote())
    died = _outcome(lambda: art.get(p.die.remote()))[1][0]
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            return first, died, art.get(p.incr.remote())  # fresh state
        except art.exceptions.ActorDiedError:
            time.sleep(0.2)
    raise AssertionError("actor did not restart in time")


def async_actor(art, rng):
    @art.remote
    class AsyncActor:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.01)
            return x * 2

    return art.get(AsyncActor.remote().work.remote(21))


def detached_lifetime_and_get_if_exists(art, rng):
    @art.remote
    class Singleton:
        def whoami(self):
            return id(self)

    h1 = Singleton.options(name="single", get_if_exists=True).remote()
    h2 = Singleton.options(name="single", get_if_exists=True).remote()
    return art.get(h1.whoami.remote()) == art.get(h2.whoami.remote())


def num_returns_cluster(art, rng):
    @art.remote(num_returns=3)
    def three():
        return 1, 2, 3

    refs = three.remote()
    return len(refs), art.get(list(refs))


def task_submitting_tasks(art, rng):
    @art.remote
    def leaf(x):
        return x * 10

    @art.remote
    def branch(n):
        return sum(art.get([leaf.remote(i) for i in range(n)]))

    return art.get(branch.remote(4))


def pubsub_actor_death_pushes_to_submitters(art, rng):
    @art.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    first = art.get(v.ping.remote())
    rt = _worker_of(art).global_worker.runtime
    state = rt._actor_states[v.actor_id]
    alive_reason = state.dead_reason
    # Kill via the GCS directly — as another driver would — so the
    # submit path learns about it purely through the push channel.
    rt._gcs.call("KillActor", {"actor_id": v.actor_id,
                               "no_restart": True}, retries=3)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and state.dead_reason is None:
        time.sleep(0.05)
    t0 = time.monotonic()
    died = _outcome(lambda: art.get(v.ping.remote(), timeout=30))
    assert time.monotonic() - t0 < 5.0  # fast-fail, no WaitActorAlive
    return first, alive_reason, state.dead_reason is not None, died[1][0]


def kill_with_restart_allowed(art, rng):
    @art.remote(max_restarts=1)
    class Cat:
        def __init__(self):
            self.lives = 1

        def ping(self):
            return self.lives

    c = Cat.remote()
    first = art.get(c.ping.remote())
    art.kill(c, no_restart=False)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            again = art.get(c.ping.remote(), timeout=20)
            break
        except art.exceptions.ActorDiedError:
            time.sleep(0.2)
    else:
        raise AssertionError("actor never restarted after soft kill")
    art.kill(c)  # terminal
    return first, again, _outcome(lambda: art.get(c.ping.remote()))[1][0]


def actor_max_concurrency_bounded(art, rng):
    @art.remote(max_concurrency=2)
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return 1

    s = Sleeper.remote()
    art.get(s.nap.remote(0.01))  # instantiation out of the timing window
    t0 = time.monotonic()
    out = art.get([s.nap.remote(0.3) for _ in range(4)])
    elapsed = time.monotonic() - t0
    assert 0.55 <= elapsed < 1.15, elapsed
    return out


def actor_concurrency_groups(art, rng):
    @art.remote(concurrency_groups={"io": 2})
    class Grouped:
        @art.method(concurrency_group="io")
        def io_call(self, t):
            time.sleep(t)
            return "io"

        def compute(self, t):
            time.sleep(t)
            return "c"

    g = Grouped.remote()
    art.get(g.compute.remote(0.01))
    t0 = time.monotonic()
    out = art.get([g.io_call.remote(0.4), g.io_call.remote(0.4),
                   g.compute.remote(0.4)])
    assert time.monotonic() - t0 < 1.0
    t0 = time.monotonic()
    art.get([g.io_call.remote(0.3) for _ in range(3)])
    assert time.monotonic() - t0 >= 0.55
    return out


SCENARIOS = [
    task_roundtrip, parallel_tasks, chained_and_nested,
    large_object_plasma, large_task_return, error_propagation, get_timeout,
    wait, wait_blocks_until_ready, wait_num_returns_caps_ready,
    large_args_promoted_to_plasma, large_actor_ctor_args_promoted,
    nested_ref_pins_released_with_outer, actor_state_and_ordering,
    actor_passed_to_task, named_actor_cross_process, actor_crash_and_kill,
    actor_restart, async_actor, detached_lifetime_and_get_if_exists,
    num_returns_cluster, task_submitting_tasks,
    pubsub_actor_death_pushes_to_submitters, kill_with_restart_allowed,
    actor_max_concurrency_bounded, actor_concurrency_groups,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_cluster_matches_jax_package(clusters, scenario):
    want, got = _both(scenario)
    assert got == want


def test_compared_outcomes_name_the_failure(clusters):
    """The compared outcomes are the ones tests/test_cluster.py expects."""
    rng = np.random.default_rng(0)
    direct, lineage = error_propagation(tart, rng)
    assert direct[1][:3] == (
        "TaskError", f"{__name__}.error_propagation.<locals>.boom",
        ("ValueError", "kaboom"))
    assert lineage[1][0] == "TaskError"
    timed_out, value = get_timeout(tart, rng)
    assert (timed_out[1][0], value) == ("GetTimeoutError", 1)
    crash = actor_crash_and_kill(tart, rng)
    assert crash[1:3] == ["ActorDiedError", "ActorDiedError"]
    assert crash[4][1][0] == "ActorDiedError"
    assert nested_ref_pins_released_with_outer(tart, rng) == (
        (True, True), (False, 0), 123)


def _gpu_entry() -> dict:
    """The ``GPU`` entry the port's detector adds on a host with cards
    (none where there is no card)."""
    from ant_ray_tpu_torch._private.accelerators import gpu

    n = gpu.num_gpus()
    return {"GPU": float(n)} if n else {}


def test_cluster_resources_and_nodes_match(clusters):
    """Both clusters advertise the same resources, the port's also the
    cards its detector finds, and one live node each."""
    assert tart.cluster_resources() == {**jart.cluster_resources(),
                                        **_gpu_entry()}
    assert tart.cluster_resources() == {"CPU": 4.0, "TPU": 0.0,
                                        **_gpu_entry()}
    assert len(tart.nodes()) == len(jart.nodes()) == 1


OVERHEAD_CALLS = 300
# The port's cost per call may be at most this multiple of the JAX
# package's: the two run the same code, and the calls interleave, so
# both see the same host from one call to the next.
OVERHEAD_FACTOR = 1.5


def test_call_overhead_matches_jax_package(clusters):
    """The runtime's own cost per call (a no-op actor call and a no-op
    task through ``.remote()`` + ``get``, less the direct call), through
    both packages' clusters with each call of one package followed by
    the same call of the other (tools/cluster_overhead.py's
    ``interleaved_overhead``): the port's medians stay within
    ``OVERHEAD_FACTOR`` of the JAX package's, and every timed call of
    both goes over a hot frame."""
    from tools.cluster_overhead import KINDS, interleaved_overhead

    out = interleaved_overhead((jart, tart), OVERHEAD_CALLS)
    want, got = out[jart.__name__], out[tart.__name__]
    for kind in KINDS:
        key = f"{kind}_overhead_us"
        assert got[key] <= OVERHEAD_FACTOR * want[key], (kind, got, want)
    for side in (want, got):
        hot = side["hotframe"]
        # The warm calls agreed the hot wire on both connections.
        assert (hot["calls_encoded"] == hot["acks_decoded"]
                == 2 * OVERHEAD_CALLS), out
        assert hot["fallback_ineligible"] == hot["fallback_cache_full"] == 0


# ------------------------------------------- what the port leaves out
# Each raises, naming the ROADMAP item (queue A) that ports it; the
# tests of what a later item ported keep their names and check it.


def test_runtime_env_option_raises(clusters):
    """The ``runtime_env`` option is ported (ROADMAP queue A item 6.6):
    a task and an actor with ``env_vars`` see them, a task without the
    env does not, in both packages alike (more cases in
    tests/test_torch_runtime_env.py)."""
    def scenario(art, _rng):
        @art.remote
        def f():
            return os.environ.get("ART_PIN_FLAG")

        @art.remote
        class A:
            def read(self):
                return os.environ.get("ART_PIN_FLAG")

        env = {"env_vars": {"ART_PIN_FLAG": "1"}}
        a = A.options(runtime_env=env).remote()
        out = (art.get(f.options(runtime_env=env).remote(), timeout=60),
               art.get(a.read.remote(), timeout=60),
               art.get(f.remote(), timeout=60))
        art.kill(a)
        return out

    want, got = _both(scenario)
    assert got == want == ("1", "1", None)


def test_dashboard_and_node_agent_are_off_and_not_settable(clusters):
    """The suite turns both processes off (``ART_INCLUDE_DASHBOARD=0``,
    ``ART_ENABLE_NODE_AGENT=0``): the port's cluster then starts
    neither, and its daemon reports no agent.  Their flags are ported
    (ROADMAP queue A item 6.6's first part), with the JAX package's
    defaults, and can be set."""
    from ant_ray_tpu._private.config import Config as JConfig
    from ant_ray_tpu_torch._private.config import Config
    from ant_ray_tpu_torch._private.worker import global_worker

    for flag, value in (("include_dashboard", False),
                        ("enable_node_agent", False),
                        ("device_stats_interval_s", 1.0)):
        assert getattr(Config(), flag) == getattr(JConfig(), flag)
        assert getattr(Config().apply_dict({flag: value}), flag) == value
    rt = global_worker.runtime
    assert rt._node.call("GetAgentInfo", {}, timeout=10) == {
        "address": None, "alive": False, "restarts": 0}
    assert not any("node_agent" in _cmdline(c) or "dashboard" in _cmdline(c)
                   for p in rt._owned_processes for c in [p.pid]
                   + _children(p.pid))


def test_cluster_context_has_no_dashboard(clusters):
    """A cluster started with ``include_dashboard`` off (the suite's
    setting) has no dashboard URL, on the context, on the runtime and
    in the GCS's KV."""
    assert tart.init(ignore_reinit_error=True).dashboard_url == ""
    from ant_ray_tpu_torch._private.worker import global_worker

    assert global_worker.runtime.dashboard_url == ""
    assert global_worker.runtime._gcs.call(
        "KVGet", {"key": "dashboard_url"}, timeout=10) is None


def test_cpu_profiler_raises(clusters):
    """The CPU profiler is ported (ROADMAP queue A item 6.5): its flags
    take the JAX package's defaults, and the driver, the GCS, the node
    daemon and the workers of the port's cluster each publish folded
    stacks to the GCS ring."""
    from ant_ray_tpu._private.config import Config as JConfig
    from ant_ray_tpu_torch._private.config import Config
    from ant_ray_tpu_torch._private.worker import global_worker
    from ant_ray_tpu_torch.observability import cpu_profiler

    for flag in ("cpu_profile_hz", "cpu_profile_publish_period_s",
                 "cpu_profile_max_stacks"):
        assert getattr(Config(), flag) == getattr(JConfig(), flag)
    assert Config().apply_dict({"cpu_profile_hz": 0.0}).cpu_profile_hz == 0
    assert cpu_profiler.profiler() is not None
    rt = global_worker.runtime

    @tart.remote
    def spin(n):
        return sum(i * i for i in range(n))

    deadline = time.monotonic() + 30
    procs = set()
    while time.monotonic() < deadline and not {
            "driver", "gcs", "daemon", "worker"} <= procs:
        tart.get([spin.remote(20000) for _ in range(4)])
        procs = {r["proc"] for r in rt._gcs.call(
            "CpuProfileGet", {}, timeout=10)}
        time.sleep(0.3)
    assert {"driver", "gcs", "daemon", "worker"} <= procs, procs


@pytest.mark.parametrize("kwargs,what", [
    ({"ha_replica_id": "r0", "store_path": "unused.db"}, "GCS HA"),
    ({"export_dir": "unused"}, "export events")])
def test_gcs_ha_and_export_events_raise(kwargs, what, tmp_path,
                                        monkeypatch):
    """GCS HA and export events are ported (ROADMAP queue A item 6.6).
    A GCS given a replica id and a store joins the replicated control
    plane as the JAX package's does: a coordinator for that replica,
    standing by until its lease is won, and without a store it refuses
    (more in tests/test_torch_gcs_ha.py).  A GCS given an export
    directory makes it and answers ``ExportEventsGet`` as enabled, as
    the JAX package's does (more in tests/test_torch_export_events.py)."""
    import asyncio

    from ant_ray_tpu._private.gcs import GcsServer as JGcsServer
    from ant_ray_tpu_torch._private.gcs import GcsServer

    monkeypatch.chdir(tmp_path)
    if what == "GCS HA":
        views = []
        for cls in (JGcsServer, GcsServer):
            server = cls(**kwargs)
            views.append((server._ha.replica_id, server._ha.role,
                          server._ha.term, type(server._ha._selector).__name__))
            server._store.close()
            with pytest.raises(ValueError, match="requires a shared store"):
                cls(ha_replica_id="r0")
        assert views[0] == views[1] == (
            "r0", "standby", 0, "FileBasedLeaderSelector")
        return
    replies = [asyncio.run(cls(**kwargs)._export_events_get({}))
               for cls in (JGcsServer, GcsServer)]
    assert replies[0] == replies[1] == {"enabled": True, "events": []}
    assert os.path.isdir(tmp_path / kwargs["export_dir"])


def test_cluster_utils_gcs_standbys_raise():
    """``gcs_standbys`` is ported: the head starts a leader and a warm
    standby over the session's store and hands out both addresses; the
    router follows the leader through ``kill_gcs_leader()`` (the term
    rises by one, the KV key and the node survive), and shutdown
    removes the session directory."""
    from ant_ray_tpu_torch._private.protocol import ClientPool
    from ant_ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 1, "gcs_standbys": 1})
    session_dir = cluster._session_dir
    try:
        replicas = cluster.address.split(",")
        assert len(replicas) == 2
        pool = ClientPool()
        router = pool.get(cluster.address)
        assert router.call("KVPut", {"key": "k", "value": b"v"},
                           timeout=30, retries=3) is True
        leader = cluster.gcs_leader_address(timeout=60)
        # The leader's own view: a standby's trails it by a sync.
        term = pool.get(leader).call("GetHaView", {}, timeout=30)["term"]
        assert cluster.kill_gcs_leader() == leader
        (standby,) = [a for a in replicas if a != leader]
        assert cluster.gcs_leader_address(timeout=60) == standby
        assert router.call("KVGet", {"key": "k"}, timeout=30,
                           retries=3) == b"v"
        view = pool.get(standby).call("GetHaView", {}, timeout=30)
        assert (view["leader"], view["term"]) == (standby, term + 1)
        assert view["last_failover_ts"] is not None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            nodes = router.call("GetAllNodes", {}, timeout=30)
            if [n.alive for n in nodes.values()] == [True]:
                break
            time.sleep(0.2)
        assert [n.alive for n in nodes.values()] == [True]
    finally:
        cluster.shutdown()
    assert not os.path.exists(session_dir)


def test_cgroups_raise():
    """The cgroup flags are ported: the port's table carries them with
    the JAX package's defaults and takes them from ``_system_config``
    (more in tests/test_torch_cgroup2.py)."""
    from ant_ray_tpu._private.config import Config as JConfig
    from ant_ray_tpu_torch._private.config import Config

    flags = ("enable_cgroups", "cgroup_root", "cgroup_workers_memory_max",
             "cgroup_workers_cpu_weight")
    assert [getattr(Config(), f) for f in flags] == \
        [getattr(JConfig(), f) for f in flags]
    cfg = Config().apply_dict({"enable_cgroups": True,
                               "cgroup_root": "/fake/cgroup"})
    assert (cfg.enable_cgroups, cfg.cgroup_root) == (True, "/fake/cgroup")


def test_insight_raises():
    """``enable_insight`` is ported, off by default as in the JAX
    package (more in tests/test_torch_insight.py)."""
    from ant_ray_tpu_torch._private.config import Config

    assert Config().enable_insight is False
    assert Config().apply_dict({"enable_insight": True}).enable_insight


def test_device_objects_raise(clusters):
    from ant_ray_tpu_torch._private.worker import global_worker

    rt = global_worker.runtime
    client = rt._clients.get(rt.address)
    for method in ("DeviceTensorFetch", "DeviceTensorFree",
                   "DeviceTensorSendVia"):
        with pytest.raises(NotImplementedError,
                           match="device objects.*item 9"):
            client.call(method, {"token": "t"}, timeout=10)


@pytest.mark.parametrize("method,item", [
    ("__art_exec_loop__", "compiled-DAG.*6.6"),
    ("__art_collective__", "collective DAG.*item 7")])
def test_compiled_dag_and_collective_methods_raise(clusters, method, item):
    from ant_ray_tpu_torch._private.task_options import TaskOptions
    from ant_ray_tpu_torch._private.worker import global_worker

    @tart.remote
    class Node:
        def ping(self):
            return "pong"

    node = Node.remote()
    assert tart.get(node.ping.remote()) == "pong"
    ref = global_worker.runtime.submit_actor_task(node, method, (), {},
                                                  TaskOptions())
    with pytest.raises(tart.exceptions.ActorError) as ei:
        tart.get(ref)
    assert isinstance(ei.value.cause, NotImplementedError)
    assert re.search(item, str(ei.value.cause))


def test_log_serving_raises(clusters):
    """Log serving is ported (ROADMAP queue A item 6.6's first part):
    the daemon lists its session's logs and reads one, as the JAX
    package's does; a name outside the log directory reads nothing."""
    from ant_ray_tpu_torch._private.worker import global_worker

    rt = global_worker.runtime
    files = rt._node.call("ListLogs", {}, timeout=10)
    names = [f["filename"] for f in files]
    assert "gcs.err" in names and any(n.startswith("worker-")
                                      for n in names)
    reply = rt._node.call("ReadLog", {"filename": "gcs.err", "tail": 4096},
                          timeout=10)
    assert reply["eof"] and b"GCS listening" in reply["data"]
    missing = rt._node.call("ReadLog", {"filename": "../gcs_store.db"},
                            timeout=10)
    assert "error" in missing


def test_lockcheck_instrumented_path_raises():
    """``note_blocking`` keeps the JAX package's signature as a no-op;
    the flag that turns the instrumented path on cannot be set."""
    import inspect

    from ant_ray_tpu._lint import lockcheck as jlockcheck
    from ant_ray_tpu_torch._lint import lockcheck
    from ant_ray_tpu_torch._private.config import Config

    assert inspect.signature(lockcheck.note_blocking) == \
        inspect.signature(jlockcheck.note_blocking)
    assert lockcheck.note_blocking("rpc") is None
    with pytest.raises(ValueError, match="lockcheck.*6.6"):
        Config().apply_dict({"lockcheck": True})
