"""The port's DAG layer (``dag/nodes.py``, ``dag/compiled.py``, the
worker's ``__art_exec_loop__``) against the JAX package's: each scenario
of tests/test_dag.py that needs no collective runs through both
packages' clusters with the same inputs, keeps the reference's
assertions, and the outcomes must be equal — values, exception types
and messages, the executor's class.  The reference's wall-clock race
between compiled and interpreted steps (``:174``, unsteady) has a twin
that counts instead: N steady-state executes submit no task, and each
exec loop reports N iterations.  Also: a pipeline whose stage raises
keeps serving, exec-loop death surfaces as the actor's
``ActorDiedError`` (chained under the driver's error), a tensor over
``buffer_size_bytes`` meets the capacity ``MemoryError``, teardown
leaves no channel file.  The collective DAG nodes (``dag/collective.py``,
ported with queue A item 7) have the twins of ``:215``, ``:252`` and
``:268``: gloo groups of actors in each package, the same results.

Each package has its own module-scoped cluster, started without
``_system_config`` (both packages read the same ``ART_*`` variables)."""

import importlib
import os
import re
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _both(scenario):
    return tuple(scenario(art, _mod(art, "dag")) for art in PACKAGES)


def _mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    message = re.sub(r"\b[0-9a-f]{8,}\b", "<id>", message)
    return re.sub(r"/\S+", "<path>", message)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", type(e).__name__, _mask(str(e)))


def _require_channels():
    from ant_ray_tpu._private.native import load_native as jload
    from ant_ray_tpu_torch._private.native import load_native as tload

    if jload() is None or tload() is None:
        pytest.skip("native channel extension unavailable")


# ------------------------------------------------- tests/test_dag.py :16-:90

def test_function_dag(clusters):
    def scenario(art, dag_mod):
        @art.remote
        def add(a, b):
            return a + b

        @art.remote
        def mul(a, b):
            return a * b

        with dag_mod.InputNode() as inp:
            dag = mul.bind(add.bind(inp, 1), 10)
        return art.get(dag.execute(4))

    want, got = _both(scenario)
    assert want == got == 50


def test_diamond_dag(clusters):
    def scenario(art, dag_mod):
        @art.remote
        def left(x):
            return x + 1

        @art.remote
        def right(x):
            return x * 2

        @art.remote
        def join(a, b):
            return (a, b)

        with dag_mod.InputNode() as inp:
            dag = join.bind(left.bind(inp), right.bind(inp))
        return art.get(dag.execute(10))

    want, got = _both(scenario)
    assert want == got == (11, 20)


def test_actor_dag(clusters):
    def scenario(art, dag_mod):
        @art.remote
        class Accum:
            def __init__(self):
                self.total = 0

            def add(self, x):
                self.total += x
                return self.total

        a = Accum.remote()
        with dag_mod.InputNode() as inp:
            dag = a.add.bind(inp)
        out = [art.get(dag.execute(5)), art.get(dag.execute(7))]
        art.kill(a)  # shared module cluster: release the actor's CPU
        return out

    want, got = _both(scenario)
    assert want == got == [5, 12]  # same actor, stateful


def test_compiled_dag_reuse(clusters):
    """A task graph compiles to the interpreted executor (no channels),
    reusable across executes."""
    def scenario(art, dag_mod):
        @art.remote
        def square(x):
            return x * x

        with dag_mod.InputNode() as inp:
            dag = square.bind(square.bind(inp))
        compiled = dag.experimental_compile()
        out = [type(compiled).__name__, art.get(compiled.execute(2)),
               art.get(compiled.execute(3))]
        compiled.teardown()
        return out

    want, got = _both(scenario)
    assert want == got == ["CompiledDAG", 16, 81]


def test_dag_cycle_detection(clusters):
    def scenario(art, dag_mod):
        @art.remote
        def f(x):
            return x

        node = f.bind(1)
        node._bound_args = (node,)  # forge a cycle
        return _outcome(node.execute)

    want, got = _both(scenario)
    assert want == got == ("raise", "ValueError", "cycle detected in DAG")


def test_missing_input_errors(clusters):
    def scenario(art, dag_mod):
        @art.remote
        def f(x):
            return x

        with dag_mod.InputNode() as inp:
            dag = f.bind(inp)
        return _outcome(dag.execute)

    want, got = _both(scenario)
    assert want == got
    assert want[:2] == ("raise", "ValueError") and "input" in want[2]


# ------------------------------------------------ channel-compiled DAGs

def test_channel_compiled_actor_pipeline(clusters):
    """Two-stage actor pipeline over preallocated shm channels: correct,
    stateful, reusable (ref: compiled_dag_node.py exec loops)."""
    _require_channels()

    def scenario(art, dag_mod):
        compiled_mod = _mod(art, "dag.compiled")

        @art.remote
        class Scale:
            def __init__(self, k):
                self.k = k
                self.calls = 0

            def apply(self, x):
                self.calls += 1
                return x * self.k

            def get_calls(self):
                return self.calls

        a = Scale.remote(2)
        b = Scale.remote(10)
        with dag_mod.InputNode() as inp:
            dag = b.apply.bind(a.apply.bind(inp))
        compiled = dag.experimental_compile()
        is_channel = isinstance(compiled, compiled_mod.ChannelCompiledDAG)
        refs = [compiled.execute(i) for i in range(5)]
        values = [r.get(timeout=30) for r in refs]
        compiled.teardown()
        # Actors are usable again after teardown (loops exited cleanly).
        calls = art.get(a.get_calls.remote())
        left = [os.path.exists(s.path)
                for s in compiled._channel_specs.values()]
        art.kill(a)
        art.kill(b)
        return is_channel, values, calls, len(left), any(left)

    want, got = _both(scenario)
    assert want == got == (True, [i * 20 for i in range(5)], 5, 3, False)


def test_channel_compiled_error_propagation(clusters):
    _require_channels()

    def scenario(art, dag_mod):
        @art.remote
        class Flaky:
            def work(self, x):
                if x < 0:
                    raise ValueError("negative input")
                return x + 1

        @art.remote
        class Tail:
            def passthrough(self, x):
                return x

        f, t = Flaky.remote(), Tail.remote()
        with dag_mod.InputNode() as inp:
            dag = t.passthrough.bind(f.work.bind(inp))
        compiled = dag.experimental_compile()
        out = [_outcome(lambda x=x: compiled.execute(x).get(timeout=30))
               for x in (1, -1, 5)]   # the pipeline survives the error
        compiled.teardown()
        art.kill(f)
        art.kill(t)
        return out

    want, got = _both(scenario)
    assert want == got == [("ok", 2),
                           ("raise", "ValueError", "negative input"),
                           ("ok", 6)]


def _stage_tasks(state, expect):
    """The GCS task table's (name, state) counts for the tasks named in
    ``expect``, polled until they equal ``expect`` (task events reach
    the GCS in batches, at most a second apart) or 30 s pass."""
    from collections import Counter

    names = {name for name, _state in expect}
    deadline = time.monotonic() + 30
    while True:
        got = dict(Counter((t["name"], t["state"])
                           for t in state.list_tasks()
                           if t["name"] in names))
        if got == expect or time.monotonic() > deadline:
            return got
        time.sleep(0.2)


def test_channel_compiled_steady_state_submits_no_task(clusters):
    """Twin of ``test_channel_compiled_beats_interpreted`` (``:174``),
    whose wall-clock race is unsteady: counted instead.  The interpreted
    path submits a task per stage per execute; N compiled executes
    submit none — the GCS task table holds one exec-loop task a stage
    and no new ``work`` task — and each loop reports N iterations."""
    _require_channels()
    n = 20
    WORK = {("SteadyStage.work", "FINISHED"): 2 * n}
    LOOPS = {("SteadyStage.__art_exec_loop__", "FINISHED"): 2}

    def scenario(art, dag_mod):
        state = _mod(art, "util.state")

        @art.remote
        class SteadyStage:
            def work(self, x):
                return x + 1

        s1, s2 = SteadyStage.remote(), SteadyStage.remote()
        with dag_mod.InputNode() as inp:
            dag = s2.work.bind(s1.work.bind(inp))
        interpreted = [art.get(dag.execute(i), timeout=60)
                       for i in range(n)]
        after_interpreted = _stage_tasks(state, WORK)
        compiled = dag.experimental_compile()
        channeled = [compiled.execute(i).get(timeout=60) for i in range(n)]
        compiled.teardown()
        loops = art.get(compiled._loop_refs, timeout=60)
        after_compiled = _stage_tasks(state, WORK | LOOPS)
        art.kill(s1)
        art.kill(s2)
        return (interpreted, channeled, after_interpreted, after_compiled,
                [loop["iterations"] for loop in loops])

    want, got = _both(scenario)
    assert want[:4] == got[:4]
    assert got[0] == got[1] == [i + 2 for i in range(n)]
    assert got[2] == WORK
    assert got[3] == WORK | LOOPS
    assert got[4] == [n, n]
    # The JAX package's loop may count a tick that teardown ended: it
    # turns the closed channel into an error value and may publish it
    # before the next channel closes (ROADMAP §C).
    assert all(n <= it <= n + 2 for it in want[4]), want[4]


class _SlowUnpickle:
    """Deserialization takes `delay` seconds — makes channel-read cost
    visible so the overlap pass is measurable deterministically."""

    def __init__(self, value, delay):
        self.value = value
        self.delay = delay

    def __reduce__(self):
        return (_slow_unpickle, (self.value, self.delay))


def _slow_unpickle(value, delay):
    time.sleep(delay)
    obj = _SlowUnpickle.__new__(_SlowUnpickle)
    obj.value = value
    obj.delay = delay
    return obj


def test_overlap_pass_parallelizes_channel_reads(clusters):
    """The per-actor overlap pass (ref: dag_node_operation.py:325,576)
    reads both upstream channels of one actor on its ``dag-read``
    threads: a combiner with two slow payloads pays max(read, read), not
    their sum."""
    _require_channels()
    delay = 0.1

    def scenario(art, dag_mod):
        @art.remote
        class Producer:
            def make(self, x):
                return _SlowUnpickle(x, delay)

        @art.remote
        class Combine:
            def both(self, a, b):
                return a.value + b.value

        def build():
            pa, pb, c = (Producer.remote(), Producer.remote(),
                         Combine.remote())
            with dag_mod.InputNode() as inp:
                dag = c.both.bind(pa.make.bind(inp), pb.make.bind(inp))
            return [pa, pb, c], dag

        def timed(compiled, n=4):
            # warmup (channel setup + first reads), then steady ticks
            compiled.execute(0).get(timeout=60)
            t0 = time.perf_counter()
            refs = [compiled.execute(i) for i in range(1, n + 1)]
            out = [r.get(timeout=60) for r in refs]
            return out, (time.perf_counter() - t0) / n

        actors_a, dag_a = build()
        serial_dag = dag_a.experimental_compile(overlap=False)
        serial_out, serial = timed(serial_dag)
        serial_dag.teardown()
        actors_b, dag_b = build()
        overlap_dag = dag_b.experimental_compile(overlap=True)
        overlap_out, overlapped = timed(overlap_dag)
        overlap_dag.teardown()
        for a in actors_a + actors_b:
            art.kill(a)
        # Serial pays both slow reads back-to-back (>= 2*delay);
        # overlapped pays ~one delay.  Generous margins for a loaded rig.
        assert serial >= 2 * delay * 0.9, f"serial={serial:.3f}"
        assert overlapped < serial - delay * 0.5, \
            f"overlap={overlapped:.3f} serial={serial:.3f}"
        return serial_out, overlap_out

    want, got = _both(scenario)
    assert want == got == ([2 * i for i in range(1, 5)],) * 2


# ------------------------------------------------ the port's own checks

def test_exec_loop_death_surfaces_as_actor_died_error(clusters):
    """A stage's actor killed while its loop runs: the next result's
    ``get`` raises the driver's "wedged" error with the actor's
    ``ActorDiedError`` as its cause, instead of hanging."""
    _require_channels()

    def scenario(art, dag_mod):
        exceptions = _mod(art, "exceptions")

        @art.remote
        class Doomed:
            def work(self, x):
                return x * 3

        d = Doomed.remote()
        with dag_mod.InputNode() as inp:
            dag = d.work.bind(inp)
        compiled = dag.experimental_compile()
        first = compiled.execute(2).get(timeout=30)
        art.kill(d)
        with pytest.raises(RuntimeError) as ei:
            compiled.execute(3).get(timeout=60)
        compiled.teardown()
        cause = ei.value.__cause__
        return (first, str(ei.value).split(" (")[0], type(cause).__name__,
                isinstance(cause, exceptions.ActorDiedError))

    want, got = _both(scenario)
    assert want == got == (6, "compiled DAG wedged: an exec-loop actor died",
                           "ActorDiedError", True)


def test_tensor_over_buffer_size_raises_the_capacity_error(clusters):
    """A driver input over ``buffer_size_bytes`` meets the native
    ``MemoryError`` naming both sizes, after a tensor that fits went
    through.  (Both packages count the refused input as submitted, so
    the DAG is torn down after it.)"""
    import torch

    _require_channels()

    def scenario(art, dag_mod):
        @art.remote
        class Sum:
            def total(self, x):
                return x.sum() if hasattr(x, "sum") else x

        s = Sum.remote()
        with dag_mod.InputNode() as inp:
            dag = s.total.bind(inp)
        compiled = dag.experimental_compile(buffer_size_bytes=4096)
        small = torch.arange(64, dtype=torch.float64)
        fits = compiled.execute(small).get(timeout=30)
        big = torch.ones(4096, dtype=torch.float32)
        over = _outcome(lambda: compiled.execute(big))
        compiled.teardown()
        art.kill(s)
        return over[:2], re.sub(r"\d+", "<n>", over[2]), float(fits)

    want, got = _both(scenario)
    assert want == got == (("raise", "MemoryError"),
                           "message of <n> bytes exceeds channel capacity "
                           "<n>", 2016.0)


def test_compile_falls_back_for_graphs_that_are_not_actor_pipelines(
        clusters):
    """Task nodes, or actor nodes fed by no InputNode, get the
    interpreted executor, as in the JAX package; a mixed graph runs."""
    _require_channels()

    def scenario(art, dag_mod):
        @art.remote
        def inc(x):
            return x + 1

        @art.remote
        class Node:
            def same(self, x=0):
                return x

        a = Node.remote()
        with dag_mod.InputNode() as inp:
            mixed = a.same.bind(inc.bind(inp))
        no_input = a.same.bind()
        kinds = [type(g.experimental_compile()).__name__
                 for g in (mixed, no_input)]
        forced = type(a.same.bind(dag_mod.InputNode()).experimental_compile(
            _force_interpreted=True)).__name__
        value = art.get(mixed.experimental_compile().execute(4))
        art.kill(a)
        return kinds, forced, value

    want, got = _both(scenario)
    assert want == got == (["CompiledDAG", "CompiledDAG"], "CompiledDAG", 5)


def test_collective_verbs_raise_naming_item_7():
    """``dag.collective`` has the JAX package's verbs (the name is the
    pin's from before ROADMAP item 7 ported them): binding none, or a
    node that is not an actor method, raises as the JAX package's do."""
    from ant_ray_tpu.dag import collective as jcollective
    from ant_ray_tpu_torch.dag import collective

    for verb in ("allreduce", "allgather", "reducescatter"):
        for mod in (jcollective, collective):
            with pytest.raises(ValueError, match="at least one input"):
                getattr(mod, verb).bind([])
        with pytest.raises(ValueError, match="actor-method nodes"):
            getattr(collective, verb).bind([_mod(tart, "dag").InputNode()])


def _collective_nodes(art, dag_mod):
    """tests/test_dag.py :215 — allreduce and allgather bound as DAG
    nodes over a gloo group of two actors."""
    import numpy as np

    col = _mod(art, "util.collective")

    @art.remote
    class Shard(col.CollectiveActorMixin):
        def __init__(self, value):
            self.value = float(value)

        def tensor(self):
            import numpy as _np
            return _np.full(4, self.value, _np.float32)

    shards = [Shard.remote(v) for v in (1.0, 2.0)]
    try:
        col.create_collective_group(shards, world_size=2, ranks=[0, 1],
                                    backend="gloo", group_name="dag_g")
        inputs = [s.tensor.bind() for s in shards]
        outputs = dag_mod.collective.allreduce.bind(inputs,
                                                    group_name="dag_g")
        assert len(outputs) == 2
        result = art.get(outputs[0].execute(), timeout=60)
        inputs = [s.tensor.bind() for s in shards]
        gathered = dag_mod.collective.allgather.bind(inputs,
                                                     group_name="dag_g")
        out = art.get(gathered[1].execute(), timeout=60)
    finally:
        for s in shards:
            art.kill(s)
    return (np.asarray(result).tolist(),
            np.asarray(out).reshape(-1).tolist())


def test_collective_allreduce_dag_nodes(clusters):
    want = _retry_reference_race(lambda: _collective_nodes(
        jart, _mod(jart, "dag")))
    got = _collective_nodes(tart, _mod(tart, "dag"))
    assert got == want == ([3.0] * 4, [1.0] * 4 + [2.0] * 4)


def test_collective_bind_rejects_same_actor(clusters):
    """tests/test_dag.py :252."""
    def scenario(art, dag_mod):
        @art.remote
        class A:
            def t(self):
                return 1

        a = A.remote()
        out = [_outcome(lambda: dag_mod.collective.allreduce.bind(
                   [a.t.bind(), a.t.bind()])),
               _outcome(lambda: dag_mod.collective.allreduce.bind(
                   [dag_mod.InputNode()]))]
        art.kill(a)
        return out

    want, got = _both(scenario)
    assert got == want
    assert got[0][0] == "raise" and "distinct actors" in got[0][2]
    assert "actor-method nodes" in got[1][2]


def test_collective_dag_reexecution_sees_fresh_state(clusters):
    """tests/test_dag.py :268 — re-executing a bound collective re-runs
    the op against the actors' current state."""
    def scenario(art, dag_mod):
        import numpy as np

        col = _mod(art, "util.collective")

        @art.remote
        class Counter(col.CollectiveActorMixin):
            def __init__(self):
                self.n = 0.0

            def tensor(self):
                import numpy as _np
                self.n += 1.0
                return _np.full(2, self.n, _np.float32)

        actors = [Counter.remote() for _ in range(2)]
        try:
            col.create_collective_group(actors, world_size=2, ranks=[0, 1],
                                        backend="gloo",
                                        group_name="reexec_g")
            outputs = dag_mod.collective.allreduce.bind(
                [a.tensor.bind() for a in actors], group_name="reexec_g")
            first = np.asarray(art.get(outputs[0].execute(), timeout=60))
            second = np.asarray(art.get(outputs[0].execute(), timeout=60))
        finally:
            for a in actors:
                art.kill(a)
        return first.tolist(), second.tolist()

    want = _retry_reference_race(lambda: scenario(jart, _mod(jart, "dag")))
    got = scenario(tart, _mod(tart, "dag"))
    assert got == want == ([2.0, 2.0], [4.0, 4.0])


def _retry_reference_race(run):
    """``run()`` (the JAX package's side of a scenario), run once more
    where its gloo rendezvous lost the port it had picked to another
    process (``EADDRINUSE``: the race between its pick and its bind,
    ROADMAP §C, which the port's rendezvous does not have).  The rerun
    starts from a KV without the failed attempt's advertised address."""
    try:
        return run()
    except Exception as e:  # noqa: BLE001 — re-raised unless the race
        if "EADDRINUSE" not in str(e):
            raise
    from ant_ray_tpu._private.worker import global_worker

    gcs = global_worker.runtime._gcs
    for key in gcs.call("KVKeys", {"prefix": "collective:"}) or []:
        gcs.call("KVDel", {"key": key})
    return run()


def test_dag_exports_match_the_jax_package():
    import ant_ray_tpu.dag as jdag
    import ant_ray_tpu.dag.compiled as jcompiled
    import ant_ray_tpu_torch.dag as tdag
    import ant_ray_tpu_torch.dag.compiled as tcompiled

    assert jdag.__all__ == tdag.__all__
    assert tcompiled.EXEC_LOOP_METHOD == jcompiled.EXEC_LOOP_METHOD
    for name in ("ChannelSpec", "StepSpec", "ActorProgram", "exec_loop",
                 "CompiledDAGRef", "ChannelCompiledDAG"):
        assert hasattr(tcompiled, name), name
