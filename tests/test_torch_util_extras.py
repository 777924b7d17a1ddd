"""The port's ``util/actor_pool.py``, ``util/queue.py`` and
``util/virtual_cluster.py`` against the JAX package's: the ActorPool and
Queue twins of tests/test_util_extras.py (``:22-95``) in a cluster of
each package, and the virtual-cluster twins of tests/test_ant_extras.py
(``:51``, ``:65``, ``:83``, ``:128``) in a three-node ``Cluster`` of
each package, over the GCS's virtual-cluster RPCs.  Each scenario keeps
the reference's assertions, and the outcomes must be equal (node ids
are mapped to the node's resource tag).

The virtual-cluster scenarios run first, in one three-node cluster per
package, one package after the other (a ``Cluster``'s
``_system_config`` travels as ``ART_*`` variables, which both packages
read); the pool and queue scenarios then share one module-scoped
cluster per package, started without ``_system_config``."""

import importlib
import os
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _both(scenario):
    return tuple(scenario(art) for art in PACKAGES)


# --------------------------------------- tests/test_ant_extras.py :51-:128

def _vc_scenarios(art):
    """The four virtual-cluster scenarios in one three-node cluster of
    ``art``: each one's outcome, node ids named by their resource tag."""
    cluster_utils = _mod(art, "cluster_utils")
    vc = _mod(art, "util.virtual_cluster")
    cluster = cluster_utils.Cluster(head_node_args={
        "num_cpus": 2, "_system_config": {"vc_fence_ttl_s": 0.5}})
    cluster.add_node(num_cpus=2, resources={"tagA": 1})
    cluster.add_node(num_cpus=2, resources={"tagB": 1})
    cluster.connect()
    tags = {}
    for n in art.nodes():
        tag = next((t for t in ("tagA", "tagB") if t in n["Resources"]),
                   "head")
        tags[n["NodeID"]] = tag
    by_tag = {t: nid for nid, t in tags.items()}

    @art.remote
    def where():
        return os.environ["ART_NODE_ID"]

    def cleanup():
        vc.bind_job(None)
        for name in list(vc.list_virtual_clusters()):
            vc.remove_virtual_cluster(name)

    def fences():
        vc.create_virtual_cluster("tenant", node_ids=[by_tag["tagA"]])
        listed = "tenant" in vc.list_virtual_clusters()
        # Unbound job: many tasks, none may land on the tenant's node.
        spots = set(art.get([where.remote() for _ in range(8)],
                            timeout=120))
        return listed, by_tag["tagA"] in spots

    def binds():
        vc.create_virtual_cluster("t2", node_ids=[by_tag["tagB"]])
        vc.bind_job("t2")
        time.sleep(1.0)  # node-side fencing cache (0.5s TTL) expires
        spots = set(art.get([where.remote() for _ in range(6)],
                            timeout=120))
        vc.bind_job(None)
        vc.remove_virtual_cluster("t2")
        return sorted(tags[s] for s in spots), \
            "t2" in vc.list_virtual_clusters()

    def validation():
        node = by_tag["tagA"]
        vc.create_virtual_cluster("v1", node_ids=[node])
        out = []
        for call in (lambda: vc.create_virtual_cluster("v2",
                                                       node_ids=[node]),
                     lambda: vc.create_virtual_cluster("v1", num_nodes=1),
                     lambda: vc.bind_job("nope")):
            try:
                call()
                out.append(None)
            except ValueError as e:
                out.append(str(e).replace(node, "<tagA>"))
        return out

    def nested():
        """Nested submits carry the parent job's identity, so children
        stay inside the tenant's virtual cluster."""
        vc.create_virtual_cluster("nest", node_ids=[by_tag["tagA"]])
        vc.bind_job("nest")
        time.sleep(1.0)  # fencing caches expire

        @art.remote
        def child():
            return os.environ["ART_NODE_ID"]

        @art.remote
        def parent():
            inner = importlib.import_module(art.__name__)
            return inner.get([child.remote() for _ in range(3)],
                             timeout=90)

        spots = set(art.get(parent.remote(), timeout=180))
        vc.bind_job(None)
        return sorted(tags[s] for s in spots)

    out = {}
    try:
        for name, fn in (("fences", fences), ("binds", binds),
                         ("validation", validation), ("nested", nested)):
            try:
                out[name] = ("ok", fn())
            except Exception as e:  # noqa: BLE001 — the outcome compared
                out[name] = ("raise", type(e).__name__, str(e))
            cleanup()
    finally:
        art.shutdown()
        cluster.shutdown()
    return out


@pytest.fixture(scope="module")
def vc_outcomes():
    return {art.__name__: _vc_scenarios(art) for art in PACKAGES}


def _vc_pair(outcomes, name):
    return (outcomes["ant_ray_tpu"][name],
            outcomes["ant_ray_tpu_torch"][name])


def test_virtual_cluster_fences_unbound_jobs(vc_outcomes):
    want, got = _vc_pair(vc_outcomes, "fences")
    assert want == got == ("ok", (True, False))


def test_virtual_cluster_binds_job(vc_outcomes):
    want, got = _vc_pair(vc_outcomes, "binds")
    assert want == got == ("ok", (["tagB"], False))


def test_virtual_cluster_validation(vc_outcomes):
    want, got = _vc_pair(vc_outcomes, "validation")
    assert want == got
    status, (assigned, exists, missing) = got
    assert status == "ok"
    assert "already assigned" in assigned
    assert "exists" in exists
    assert "no virtual cluster" in missing


def test_virtual_cluster_nested_tasks_stay_fenced(vc_outcomes):
    want, got = _vc_pair(vc_outcomes, "nested")
    assert want == got == ("ok", ["tagA"])


@pytest.fixture(scope="module")
def small_clusters():
    jart.init(num_cpus=3, num_tpus=0)
    try:
        tart.init(num_cpus=3, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


# ------------------------------------------- tests/test_util_extras.py :22-95

def test_actor_pool_ordered_map(small_clusters):
    def scenario(art):
        ActorPool = _mod(art, "util.actor_pool").ActorPool

        @art.remote
        class Doubler:
            def double(self, x):
                return x * 2

        actors = [Doubler.remote() for _ in range(2)]
        pool = ActorPool(actors)
        got = list(pool.map(lambda a, v: a.double.remote(v), range(7)))
        for a in actors:
            art.kill(a)
        return got

    want, got = _both(scenario)
    assert want == got == [0, 2, 4, 6, 8, 10, 12]  # order kept, > pool


def test_actor_pool_unordered(small_clusters):
    def scenario(art):
        ActorPool = _mod(art, "util.actor_pool").ActorPool

        @art.remote
        class Sleeper:
            def run(self, t):
                import time as _time

                _time.sleep(t)
                return t

        actors = [Sleeper.remote() for _ in range(2)]
        pool = ActorPool(actors)
        got = set(pool.map_unordered(lambda a, v: a.run.remote(v),
                                     [0.3, 0.0, 0.1]))
        for a in actors:
            art.kill(a)
        return got

    want, got = _both(scenario)
    assert want == got == {0.3, 0.0, 0.1}


def test_actor_pool_submit_get_next(small_clusters):
    def scenario(art):
        ActorPool = _mod(art, "util.actor_pool").ActorPool

        @art.remote
        class Identity:
            def same(self, x):
                return x

        actor = Identity.remote()
        pool = ActorPool([actor])
        pool.submit(lambda a, v: a.same.remote(v), "a")
        pool.submit(lambda a, v: a.same.remote(v), "b")  # queued (1 actor)
        out = [pool.has_next(), pool.has_free(), pool.get_next(timeout=60),
               pool.get_next(timeout=60), pool.has_next(), pool.has_free()]
        try:
            pool.get_next()
        except StopIteration as e:
            out.append(str(e))
        art.kill(actor)
        return out

    want, got = _both(scenario)
    assert want == got == [True, False, "a", "b", False, True,
                           "no pending results"]


def test_queue_fifo_across_processes(small_clusters):
    def scenario(art):
        queue = _mod(art, "util.queue")
        q = queue.Queue(maxsize=8)

        @art.remote
        def producer(q, items):
            for item in items:
                q.put(item)
            return True

        art.get(producer.remote(q, [1, 2, 3]), timeout=60)
        out = [q.qsize(), [q.get(timeout=10) for _ in range(3)], q.empty(),
               q.full()]
        with pytest.raises(queue.Empty):
            q.get(block=False)
        q.shutdown()
        return out

    want, got = _both(scenario)
    assert want == got == [3, [1, 2, 3], True, False]


def test_queue_blocking_get(small_clusters):
    def scenario(art):
        queue = _mod(art, "util.queue")
        q = queue.Queue()

        @art.remote
        def late_producer(q):
            import time as _time

            _time.sleep(0.5)
            q.put("late")
            return True

        ref = late_producer.remote(q)
        got = q.get(timeout=30)   # blocks until the put lands
        art.get(ref, timeout=30)
        q.shutdown()
        return got

    want, got = _both(scenario)
    assert want == got == "late"


def test_queue_full_and_timeouts(small_clusters):
    """A bounded queue raises the local ``Full`` / ``Empty`` for
    non-blocking and timed-out calls, as the JAX package's does."""
    def scenario(art):
        queue = _mod(art, "util.queue")
        q = queue.Queue(maxsize=1)
        out = [q.put("x", block=False), q.full()]
        for call in (lambda: q.put("y", block=False),
                     lambda: q.put("y", timeout=0.2)):
            with pytest.raises(queue.Full):
                call()
        out.append(q.get(block=False))
        with pytest.raises(queue.Empty):
            q.get(timeout=0.2)
        q.shutdown()
        return out

    want, got = _both(scenario)
    assert want == got == [True, True, "x"]
