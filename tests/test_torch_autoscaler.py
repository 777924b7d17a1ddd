"""The port's ``autoscaler/`` (the control loop, the gang planner, the
local and GKE node providers) against the JAX package's.  The twins of
tests/test_autoscaler.py's plain tests (``:48``,
``:90``, ``:103``, ``:146``, ``:177``, ``:187``, ``:199``) run through
both packages, each scenario in a ``Cluster`` of its own package, and
their outcomes must be equal; ``plan_gang`` is held against the
reference on host sets that hypothesis draws; a plain ``STRICT_SPREAD``
gang drives the gang path end to end in both; the GKE REST client and
provider run against one fake API (every test of
tests/test_gke_provider.py has its twin here, its slice story in
``test_slice_launch_registration_gang_release_sequence``); and the slice twins (``:213``,
``:242``, ``:261``, ``:296``) hold the JAX package's v5e "4x4" slice
against the port's gb200 "4x4" slice (the same 16 chips on 4 hosts of
4), with ``tpu_slice_node_type`` the port's ``gpu_slice_node_type``."""

import importlib
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _cluster(art, **head_node_args):
    """A one-head ``Cluster`` of ``art``.  The JAX package's is started
    once more where its GCS exited before it was ready: that GCS binds
    a port its launcher picked earlier, and another process can bind it
    in between (``EADDRINUSE``, ROADMAP §C; the port's GCS binds port 0
    and advertises what it got, see
    ``test_gcs_start_does_not_lose_a_picked_port``)."""
    make = _mod(art, "cluster_utils").Cluster
    try:
        return make(head_node_args=head_node_args)
    except RuntimeError as e:
        if art is not jart or "before ready" not in str(e):
            raise
    return make(head_node_args=head_node_args)


def _in_cluster(scenario, head_cpus=1):
    """``scenario(art, cluster, make)`` in a one-head ``Cluster`` of each
    package in turn; ``make(node_types, **cfg)`` builds an autoscaler
    over a ``LocalSubprocessProvider`` whose daemons are torn down
    before the cluster.  Returns both outcomes, held equal."""
    outs = []
    for art in PACKAGES:
        auto = _mod(art, "autoscaler")
        cluster = _cluster(art, num_cpus=head_cpus)
        cluster.connect()
        providers = []

        def make(node_types, **cfg):
            provider = auto.LocalSubprocessProvider(
                cluster.gcs_address, cluster._session_dir)
            providers.append(provider)
            config = auto.AutoscalerConfig(node_types=node_types, **cfg)
            return auto.Autoscaler(cluster.gcs_address, provider,
                                   config), provider
        try:
            outs.append(scenario(art, auto, make))
        finally:
            for provider in providers:
                for pid in list(provider.non_terminated_nodes()):
                    provider.terminate_node(pid)
            art.shutdown()
            cluster.shutdown()
    assert outs[0] == outs[1]
    return outs[1]


def _drive_until(autoscaler, done, timeout=60, key="launched"):
    out = []
    deadline = time.monotonic() + timeout

    def drive():
        while time.monotonic() < deadline and not done(out):
            out.extend(autoscaler.run_once()[key])
            time.sleep(0.5)

    thread = threading.Thread(target=drive, daemon=True)
    thread.start()
    return thread, out


# ------------------------------------------- tests/test_autoscaler.py twins

def test_scales_up_for_infeasible_task_and_down_when_idle():
    def scenario(art, auto, make):
        autoscaler, provider = make(
            [auto.NodeTypeConfig("widget-node",
                                 {"CPU": 2.0, "widget": 1.0},
                                 max_workers=2)],
            idle_timeout_s=2.0)
        autoscaler.run_once()  # heartbeat: infeasible now waits

        @art.remote
        def probe():
            return 42

        ref = probe.options(resources={"widget": 1.0}).remote()
        thread, launched = _drive_until(autoscaler, bool)
        assert art.get(ref, timeout=90) == 42
        thread.join(timeout=30)
        assert launched == ["widget-node"]
        assert len(provider.non_terminated_nodes()) == 1

        terminated = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not terminated:
            terminated.extend(autoscaler.run_once()["terminated"])
            time.sleep(0.5)
        assert terminated == ["widget-node"]
        assert provider.non_terminated_nodes() == {}
        return launched, terminated

    _in_cluster(scenario)


def test_min_workers_backfill_and_max_cap():
    def scenario(art, auto, make):
        autoscaler, provider = make(
            [auto.NodeTypeConfig("pool", {"CPU": 1.0}, min_workers=2,
                                 max_workers=2)],
            idle_timeout_s=3600.0)
        result = autoscaler.run_once()
        assert result["launched"] == ["pool", "pool"]
        steady = autoscaler.run_once()
        assert steady == {"launched": [], "terminated": []}
        assert len(provider.non_terminated_nodes()) == 2
        return result, steady

    _in_cluster(scenario)


def test_label_selector_demand_matches_typed_node():
    def scenario(art, auto, make):
        autoscaler, provider = make(
            [auto.NodeTypeConfig("generic", {"CPU": 4.0}, max_workers=4),
             auto.NodeTypeConfig("tpu-ish", {"CPU": 2.0},
                                 labels={"tpu-pod-type": "v5e-16"},
                                 max_workers=4)],
            idle_timeout_s=3600.0)
        autoscaler.run_once()

        @art.remote
        def on_labeled():
            return "ok"

        ref = on_labeled.options(
            label_selector={"tpu-pod-type": "v5e-16"}).remote()
        thread, launched = _drive_until(autoscaler, bool)
        assert art.get(ref, timeout=90) == "ok"
        thread.join(timeout=30)
        assert launched == ["tpu-ish"]
        return launched

    _in_cluster(scenario)


class _FakeGkeClient:
    def __init__(self):
        self.sizes = {"pool-v5e": 0}

    def get_pool_size(self, pool):
        return self.sizes[pool]

    def set_pool_size(self, pool, size):
        self.sizes[pool] = size


def test_gke_provider_pool_arithmetic():
    outs = []
    for art in PACKAGES:
        auto = _mod(art, "autoscaler")
        client = _FakeGkeClient()
        provider = auto.GkeTpuNodePoolProvider(
            client, pool_for_type={"v5e-slice": "pool-v5e"})
        node_type = auto.NodeTypeConfig("v5e-slice", {"TPU": 4.0})
        a = provider.create_node(node_type)
        b = provider.create_node(node_type)
        sizes = [client.sizes["pool-v5e"]]
        assert set(provider.non_terminated_nodes().values()) == \
            {"v5e-slice"}
        provider.terminate_node(a)
        sizes.append(client.sizes["pool-v5e"])
        provider.terminate_node(b)
        sizes.append(client.sizes["pool-v5e"])
        with pytest.raises(ValueError):
            auto.GkeTpuNodePoolProvider(None, {})
        outs.append((a, b, sizes))
    assert outs[0] == outs[1]
    assert outs[1][2] == [2, 1, 0]


def _views(*hosts):
    return [{"id": f"h{i}", "labels": labels, "resources": res}
            for i, (labels, res) in enumerate(hosts)]


def _plan(*args):
    plans = [_mod(art, "autoscaler.autoscaler").plan_gang(*args)
             for art in PACKAGES]
    assert plans[0] == plans[1]
    return plans[1]


def test_plan_gang_strict_spread_needs_distinct_hosts():
    bundles = [{"CPU": 1.0}, {"CPU": 1.0}]
    one = _views(({}, {"CPU": 4.0}))
    two = _views(({}, {"CPU": 4.0}), ({}, {"CPU": 4.0}))
    assert _plan(one, bundles, None, "STRICT_SPREAD", None) is None
    assert _plan(two, bundles, None, "STRICT_SPREAD", None) is not None
    assert _plan(one, bundles, None, "STRICT_PACK", None) is not None


def test_plan_gang_same_label_groups():
    bundles = [{"TPU": 4.0}, {"TPU": 4.0}]
    split = _views(({"pod": "a"}, {"TPU": 4.0}),
                   ({"pod": "b"}, {"TPU": 4.0}))
    joined = _views(({"pod": "a"}, {"TPU": 4.0}),
                    ({"pod": "a"}, {"TPU": 4.0}))
    assert _plan(split, bundles, None, "STRICT_SPREAD", "pod") is None
    assert _plan(joined, bundles, None, "STRICT_SPREAD", "pod") is not None


def test_plan_gang_selectors_pin_bundles():
    bundles = [{"TPU": 4.0}, {"TPU": 4.0}]
    selectors = [{"tpu-worker-id": "0"}, {"tpu-worker-id": "1"}]
    hosts = _views(({"tpu-worker-id": "0"}, {"TPU": 4.0}),
                   ({"tpu-worker-id": "1"}, {"TPU": 4.0}))
    assert _plan(hosts, bundles, selectors, "STRICT_SPREAD",
                 None) == ["h0", "h1"]
    assert _plan(hosts, bundles,
                 [{"tpu-worker-id": "0"}, {"tpu-worker-id": "9"}],
                 "STRICT_SPREAD", None) is None


# --------------------------------------------- plan_gang, hypothesis

_RES = st.dictionaries(st.sampled_from(["CPU", "GPU", "widget"]),
                       st.sampled_from([0.5, 1.0, 2.0, 4.0]),
                       min_size=1, max_size=3)
_LABELS = st.dictionaries(st.sampled_from(["pod", "zone"]),
                          st.sampled_from(["a", "b"]), max_size=2)


@settings(max_examples=150, deadline=None)
@given(hosts=st.lists(st.tuples(_LABELS, _RES), min_size=0, max_size=5),
       bundles=st.lists(_RES, min_size=1, max_size=4),
       strategy=st.sampled_from(["PACK", "SPREAD", "STRICT_PACK",
                                 "STRICT_SPREAD"]),
       same_label=st.sampled_from([None, "pod"]),
       use_selectors=st.booleans(),
       data=st.data())
def test_plan_gang_matches_the_reference(hosts, bundles, strategy,
                                         same_label, use_selectors, data):
    selectors = None
    if use_selectors:
        selectors = data.draw(st.lists(_LABELS, min_size=len(bundles),
                                       max_size=len(bundles)))
    views = _views(*hosts)
    _plan(views, bundles, selectors, strategy, same_label)
    planners = [_mod(art, "autoscaler.autoscaler")._plan_gang_in
                for art in PACKAGES]
    outs = [p(views, bundles, selectors, strategy) for p in planners]
    assert outs[0] == outs[1]


# ----------------------------------------------- the gang path, plainly

def _string_ids(monkeypatch):
    """The JAX package's planner keys live nodes by NodeID and planned
    launches by str, and its plain-gang path sorts them together: with
    any live node that raises TypeError.  The port keys live nodes by
    str; patch the same into the reference (in this process only) so
    the two can be compared on the path."""
    ref = _mod(jart, "autoscaler.autoscaler").Autoscaler
    views = ref._node_views

    def string_views(nodes, field="total_resources"):
        return [{**v, "id": str(v["id"])} for v in views(nodes, field)]

    monkeypatch.setattr(ref, "_node_views", staticmethod(string_views))


def test_plain_gang_beside_a_live_node_raises_only_in_the_reference():
    """The pin of the reference's fault above: one live node and a
    two-bundle STRICT_SPREAD gang that needs launches."""
    class Node:
        alive = True
        labels = {}
        total_resources = available_resources = {"CPU": 1.0}

        def __init__(self, node_id):
            self.node_id = node_id
            self.address = "127.0.0.1:1"

    demand = {"pg_id": "pg", "bundles": [{"CPU": 1.0, "widget": 1.0}] * 2,
              "bundle_selectors": [{}, {}], "strategy": "STRICT_SPREAD",
              "same_label": None}
    out = []
    for art in PACKAGES:
        auto = _mod(art, "autoscaler")
        node_id = _mod(art, "_private.ids").NodeID.from_random()
        created = []

        class Provider(auto.NodeProvider):
            def create_node(self, node_type):
                created.append(node_type.name)
                return f"p{len(created)}"

            def non_terminated_nodes(self):
                return {}

        scaler = auto.Autoscaler("127.0.0.1:1", Provider(),
                                 auto.AutoscalerConfig(node_types=[
                                     auto.NodeTypeConfig(
                                         "widget-node",
                                         {"CPU": 2.0, "widget": 1.0},
                                         max_workers=3)]))
        try:
            scaler._scale_up_gang(demand, [Node(node_id)], {}, 8,
                                  time.monotonic(), [])
            out.append(created)
        except TypeError:
            out.append("TypeError")
    assert out == ["TypeError", ["widget-node", "widget-node"]]


def test_strict_spread_gang_launches_two_nodes_and_commits(monkeypatch):
    """A ``STRICT_SPREAD`` group of two ``{"CPU": 1, "widget": 1}``
    bundles fits no live node: its gang demand launches two widget
    nodes in one round, and the group commits across them (the
    reference with the string ids of ``_string_ids``)."""
    _string_ids(monkeypatch)

    def scenario(art, auto, make):
        pg_mod = _mod(art, "util.placement_group")
        autoscaler, provider = make(
            [auto.NodeTypeConfig("widget-node",
                                 {"CPU": 2.0, "widget": 1.0},
                                 max_workers=3)],
            idle_timeout_s=3600.0, gang_provision_grace_s=3600.0)
        autoscaler.run_once()
        pg = pg_mod.placement_group([{"CPU": 1.0, "widget": 1.0}] * 2,
                                    strategy="STRICT_SPREAD")
        stop = threading.Event()
        launched = []

        def drive():
            while not stop.is_set():
                launched.extend(autoscaler.run_once()["launched"])
                time.sleep(0.5)

        thread = threading.Thread(target=drive, daemon=True)
        thread.start()
        try:
            assert pg.ready(timeout=90), "gang never committed"
        finally:
            stop.set()
            thread.join(timeout=10)
        nodes = {pg.bundle_node(0), pg.bundle_node(1)}
        assert len(nodes) == 2
        assert launched == ["widget-node", "widget-node"]
        assert len(provider.non_terminated_nodes()) == 2
        pg_mod.remove_placement_group(pg)
        return launched

    _in_cluster(scenario)


# ----------------------------------------------------------- GKE, faked

CLUSTER = "projects/p1/locations/us-central2-b/clusters/gpu-c"


class _RecordedGkeApi:
    """The GKE REST surface the client speaks (nodePool GET, async
    ``:setSize`` operations that stay RUNNING for ``op_latency``
    requests, 409 on a second resize in flight), in memory."""

    def __init__(self, auto, pools: dict, op_latency: int = 2):
        self.error = auto.GkeApiError
        self.pools = {name: {"name": name, "initialNodeCount": n}
                      for name, n in pools.items()}
        self.op_latency = op_latency
        self.ops: dict = {}
        self.inflight: dict = {}
        self.log: list = []
        self.on_resize = None     # (pool, size) once a resize completes
        self._lock = threading.Lock()
        self._n = 0

    def request(self, method, path, body=None):
        with self._lock:
            return self._request(method, path, body)

    def _request(self, method, path, body):
        self.log.append((method, path.rsplit("/", 1)[1]))
        for op in self.ops.values():
            if op["status"] == "RUNNING":
                op["ttl"] -= 1
                if op["ttl"] <= 0:
                    op["status"] = "DONE"
                    self.pools[op["pool"]]["initialNodeCount"] = \
                        op["target"]
                    self.inflight.pop(op["pool"], None)
                    if self.on_resize is not None:
                        self.on_resize(op["pool"], op["target"])
        if method == "GET" and "/nodePools/" in path:
            pool = path.rsplit("/", 1)[1]
            if pool not in self.pools:
                raise self.error(404, pool)
            return dict(self.pools[pool])
        if method == "POST" and path.endswith(":setSize"):
            pool = path.rsplit("/", 1)[1][:-len(":setSize")]
            if pool in self.inflight:
                raise self.error(409, f"resize in progress on {pool}")
            self._n += 1
            name = f"operation-{self._n}"
            self.ops[name] = {"status": "RUNNING", "ttl": self.op_latency,
                              "pool": pool,
                              "target": int(body["nodeCount"])}
            self.inflight[pool] = name
            return {"name": name, "status": "RUNNING"}
        if method == "GET" and "/operations/" in path:
            name = path.rsplit("/", 1)[1]
            return {"name": name, "status": self.ops[name]["status"]}
        raise self.error(400, f"unroutable {method} {path}")


def _gke_scenario(name, auto):
    api = _RecordedGkeApi(auto, {"pool-h100": 0}, op_latency=2)
    client = auto.GkeRestNodePoolClient(api.request, CLUSTER,
                                        poll_interval_s=0.001)
    if name == "resize":
        client.set_pool_size("pool-h100", 2)
        return client.get_pool_size("pool-h100"), api.log
    if name == "conflict":
        api.request("POST", f"{CLUSTER}/nodePools/pool-h100:setSize",
                    {"nodeCount": 1})
        client.set_pool_size("pool-h100", 2)
        return client.get_pool_size("pool-h100"), api.log
    if name == "unknown":
        with pytest.raises(auto.GkeApiError) as err:
            client.get_pool_size("nope")
        return err.value.status
    if name == "provider":
        provider = auto.GkeTpuNodePoolProvider(
            client, pool_for_type={"h100": "pool-h100"})
        node_type = auto.NodeTypeConfig("h100", {"CPU": 8.0, "GPU": 1.0})
        a = provider.create_node(node_type)
        b = provider.create_node(node_type)
        sizes = [api.pools["pool-h100"]["initialNodeCount"]]
        provider.terminate_node(a)
        provider.terminate_node(a)   # idempotent
        sizes.append(api.pools["pool-h100"]["initialNodeCount"])
        provider.terminate_node(b)
        sizes.append(api.pools["pool-h100"]["initialNodeCount"])
        return a, b, sizes
    if name == "done_with_status_message":
        failing = auto.GkeRestNodePoolClient(
            lambda *a, **k: {"name": "op-9", "status": "DONE",
                             "statusMessage": "node pool went sideways"},
            CLUSTER, poll_interval_s=0.001)
        with pytest.raises(auto.GkeApiError, match="went sideways") as err:
            failing._wait_operation({"name": "op-9", "status": "RUNNING"},
                                    time.monotonic() + 5)
        return err.value.status, str(err.value)
    if name == "missing_status":
        # A reply without ``status`` is not success: it polls on until
        # the deadline.
        polling = auto.GkeRestNodePoolClient(
            lambda *a, **k: {"name": "op-9"}, CLUSTER,
            poll_interval_s=0.001)
        with pytest.raises(auto.GkeApiError) as err:
            polling._wait_operation({"name": "op-9"},
                                    time.monotonic() + 0.3)
        return err.value.status
    if name == "clean_done":
        clean = auto.GkeRestNodePoolClient(
            lambda *a, **k: {"name": "op-9", "status": "DONE"}, CLUSTER,
            poll_interval_s=0.001)
        return clean._wait_operation({"name": "op-9", "status": "DONE"},
                                     time.monotonic() + 5)
    if name == "done_with_error":
        failing = auto.GkeRestNodePoolClient(
            lambda *a, **k: {"name": "op-9", "status": "DONE",
                             "error": {"code": 429, "message": "stockout"}},
            CLUSTER, poll_interval_s=0.001)
        with pytest.raises(auto.GkeApiError, match="stockout") as err:
            failing._wait_operation({"name": "op-9", "status": "RUNNING"},
                                    time.monotonic() + 5)
        return err.value.status
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["resize", "conflict", "unknown",
                                  "provider", "done_with_error",
                                  "done_with_status_message",
                                  "missing_status", "clean_done"])
def test_gke_rest_client_against_a_fake_api(name):
    outs = [_gke_scenario(name, _mod(art, "autoscaler"))
            for art in PACKAGES]
    assert outs[0] == outs[1]
    if name == "missing_status":
        assert outs[1] == 504
    if name == "done_with_error":
        assert outs[1] == 429


# --------------------------------- tests/test_autoscaler.py slice twins
#
# The JAX package's v5e "4x4" slice (16 chips, 4 hosts of 4) is held
# against the port's gb200 "4x4" slice (16 cards, 4 hosts of 4): the
# same geometry, in GPU terms.

def _slice_api(art):
    """(slice_placement_group, slice node type) of ``art``, each taking
    a topology, at the geometry both packages share."""
    auto = _mod(art, "autoscaler")
    if art is jart:
        spg = _mod(art, "util.tpu").slice_placement_group
        return spg, auto.tpu_slice_node_type
    spg = _mod(art, "util.gpu").slice_placement_group
    return ((lambda topology, **kw: spg(topology, "GB200", **kw)),
            (lambda topology, **kw: auto.tpu_slice_node_type(
                topology, "GB200", **kw)))


def _to_gpu_terms(node_type) -> dict:
    """A JAX-package NodeTypeConfig's fields with TPU terms mapped to the
    port's (v4 and v5e slices compared against gb200)."""
    def term(text):
        for a, b in (("TPU-", "GPU-"), ("tpu-", "gpu-"), ("TPU", "GPU"),
                     ("v4-", "gb200-"), ("v5e-", "gb200-")):
            text = text.replace(a, b)
        return {"v4": "gb200", "v5e": "gb200"}.get(text, text)

    fields = _type_fields(node_type)
    return {k: ({term(a): (term(b) if isinstance(b, str) else b)
                 for a, b in v.items()} if isinstance(v, dict)
                else term(v) if isinstance(v, str) else v)
            for k, v in fields.items()}


def _type_fields(node_type) -> dict:
    return {"resources": node_type.resources, "labels": node_type.labels,
            "hosts_per_launch": node_type.hosts_per_launch,
            "launch_shared_label": node_type.launch_shared_label,
            "launch_indexed_label": node_type.launch_indexed_label,
            "head_resources": node_type.head_resources,
            "max_workers": node_type.max_workers}


def _gke_slice_autoscaler(auto, art, cluster_address, slice_type, client):
    provider = auto.GkeTpuNodePoolProvider(
        client, pool_for_type={"v5e-slice": "pool-v5e"})
    return auto.Autoscaler(
        cluster_address, provider,
        auto.AutoscalerConfig(node_types=[slice_type],
                              gang_provision_grace_s=3600.0))


def _in_head_cluster(scenario):
    """``scenario(art, auto, cluster)`` in a one-CPU head ``Cluster`` of
    each package in turn; both outcomes held equal."""
    outs = []
    for art in PACKAGES:
        auto = _mod(art, "autoscaler")
        cluster = _cluster(art, num_cpus=1)
        cluster.connect()
        try:
            outs.append(scenario(art, auto, cluster))
        finally:
            art.shutdown()
            cluster.shutdown()
    assert outs[0] == outs[1]
    return outs[1]


def test_gcs_start_does_not_lose_a_picked_port(monkeypatch):
    """The race behind a failed start of the slice-gang test's cluster:
    a launcher that picks a free port and lets its GCS bind it later
    loses the port to any process that binds it in between.  With the
    pick made to return a port another socket holds, the JAX package's
    GCS exits before it is ready; the port's GCS binds port 0 itself,
    picks nothing, and starts."""
    import shutil
    import socket

    from ant_ray_tpu._private import services as jservices
    from ant_ray_tpu_torch._private import protocol as tprotocol
    from ant_ray_tpu_torch._private import services as tservices

    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen()
    taken = holder.getsockname()[1]
    try:
        monkeypatch.setattr(jservices, "find_free_port", lambda: taken)
        monkeypatch.setattr(tprotocol, "find_free_port", lambda: taken)
        # A launcher that imports the pick by name picks the taken port
        # too.
        monkeypatch.setattr(tservices, "find_free_port", lambda: taken,
                            raising=False)
        session = jservices.new_session_dir()
        try:
            with pytest.raises(RuntimeError, match="before ready"):
                jservices.start_gcs(session)
        finally:
            shutil.rmtree(session, ignore_errors=True)
        cluster = _mod(tart, "cluster_utils").Cluster(
            head_node_args={"num_cpus": 1})
        try:
            port = int(cluster.gcs_address.rsplit(":", 1)[1])
        finally:
            cluster.shutdown()
        assert port != taken
    finally:
        holder.close()


def test_slice_gang_launches_one_whole_unit_via_gke():
    """A slice PG's gang demand drives ONE node-pool resize (the whole
    slice), not per-bundle lone nodes."""
    def scenario(art, auto, cluster):
        spg_fn, type_fn = _slice_api(art)
        client = _FakeGkeClient()
        autoscaler = _gke_slice_autoscaler(
            auto, art, cluster.gcs_address,
            type_fn("4x4", name="v5e-slice", max_workers=2), client)
        autoscaler.run_once()     # heartbeat so the PG waits for capacity
        spg = spg_fn("4x4")       # 4 hosts — unplaceable here
        deadline = time.monotonic() + 30
        launched = []
        while time.monotonic() < deadline and not launched:
            launched.extend(autoscaler.run_once()["launched"])
            time.sleep(0.3)
        sizes = [client.sizes["pool-v5e"]]
        # The gang stays pending (fake client: hosts never register) but
        # the grace period stops duplicate provisioning.
        again = autoscaler.run_once()["launched"]
        sizes.append(client.sizes["pool-v5e"])
        spg.remove()
        return launched, again, sizes

    launched, again, sizes = _in_head_cluster(scenario)
    assert launched == ["v5e-slice"]
    assert again == [] and sizes == [1, 1]   # ONE atomic slice resize


def test_slice_launch_registration_gang_release_sequence():
    """The whole GKE story against the recorded API
    (tests/test_gke_provider.py:155): a slice PG, gang demand, ONE pool
    resize, the hosts booting (local daemons started when the resize
    completes) and registering, the PG committing, no second launch for
    the satisfied gang, and terminate draining the pool."""
    def scenario(art, auto, cluster):
        spg_fn, type_fn = _slice_api(art)
        slice_type = type_fn("4x4", name="v5e-slice", cpus_per_host=1.0,
                             max_workers=1)
        booter = auto.LocalSubprocessProvider(cluster.gcs_address,
                                              cluster._session_dir)
        api = _RecordedGkeApi(auto, {"pool-v5e": 0}, op_latency=1)

        def boot(pool, size):
            if size > 0:
                booter.create_node(slice_type)

        api.on_resize = boot
        client = auto.GkeRestNodePoolClient(api.request, CLUSTER,
                                            poll_interval_s=0.01)
        provider = auto.GkeTpuNodePoolProvider(
            client, pool_for_type={"v5e-slice": "pool-v5e"})
        autoscaler = auto.Autoscaler(
            cluster.gcs_address, provider,
            auto.AutoscalerConfig(node_types=[slice_type],
                                  gang_provision_grace_s=3600.0))
        try:
            autoscaler.run_once()            # heartbeat: PGs wait
            spg = spg_fn("4x4", bundle_extra={"CPU": 0.5})
            stop = threading.Event()
            thread, launched = _drive_until(
                autoscaler, lambda _out: stop.is_set(), timeout=120)
            try:
                ready = spg.ready(timeout=90)
            finally:
                stop.set()
                thread.join(timeout=10)
            assert ready, f"{art.__name__}: slice PG never committed"
            sizes = [api.pools["pool-v5e"]["initialNodeCount"]]
            again = autoscaler.run_once()["launched"]
            spg.remove()
            for pid in list(provider.non_terminated_nodes()):
                provider.terminate_node(pid)
            sizes.append(api.pools["pool-v5e"]["initialNodeCount"])
            return ready, launched, again, sizes
        finally:
            for pid in list(booter.non_terminated_nodes()):
                booter.terminate_node(pid)

    ready, launched, again, sizes = _in_head_cluster(scenario)
    # ONE atomic slice resize; the satisfied gang never relaunches.
    assert (ready, launched, again, sizes) == (True, ["v5e-slice"], [],
                                               [1, 0])


def test_gang_demand_never_launches_mismatched_node():
    """A gang demand that no configured type can host atomically must
    launch NOTHING (an empty shape must never look satisfiable)."""
    def scenario(art, auto, make):
        autoscaler, provider = make(
            [auto.NodeTypeConfig("generic", {"CPU": 16.0}, max_workers=4)],
            idle_timeout_s=3600.0)
        autoscaler.run_once()
        spg = _slice_api(art)[0]("4x4")   # needs slice hosts
        rounds = []
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline:
            rounds.append(autoscaler.run_once()["launched"])
            time.sleep(0.4)
        spg.remove()
        return all(r == [] for r in rounds), provider.non_terminated_nodes()

    assert _in_cluster(scenario) == (True, {})


@pytest.mark.slow
def test_slice_pg_scales_up_and_commits_e2e():
    """A slice placement group on an empty cluster -> gang demand ->
    the autoscaler launches EVERY host of one slice -> the hosts register
    with slice labels -> the PG commits."""
    def scenario(art, auto, make):
        spg_fn, type_fn = _slice_api(art)
        autoscaler, provider = make(
            [type_fn("4x4", name="v5e-slice", cpus_per_host=1.0,
                     max_workers=1)], idle_timeout_s=3600.0)
        autoscaler.run_once()
        spg = spg_fn("4x4", bundle_extra={"CPU": 0.5})
        thread, launched = _drive_until(autoscaler, lambda out: False,
                                        timeout=20)
        try:
            ready = spg.ready(timeout=90)
        finally:
            thread.join(timeout=30)
        units = provider.non_terminated_nodes()
        hosts = [len(provider.node_addresses(u)) for u in units]
        spg.remove()
        return ready, launched, hosts

    ready, launched, hosts = _in_cluster(scenario)
    assert ready, "slice PG never committed"
    assert launched == ["v5e-slice"]   # one gang unit = all 4 hosts
    assert hosts == [4]


def test_two_identical_slice_pgs_get_two_units():
    """Per-PG gang demands: two pending identical-shape slice PGs must
    drive TWO unit launches (they can't share one slice's head claim)."""
    def scenario(art, auto, cluster):
        spg_fn, type_fn = _slice_api(art)
        client = _FakeGkeClient()
        autoscaler = _gke_slice_autoscaler(
            auto, art, cluster.gcs_address,
            type_fn("4x4", name="v5e-slice", max_workers=2), client)
        autoscaler.run_once()
        a, b = spg_fn("4x4"), spg_fn("4x4")
        deadline = time.monotonic() + 30
        launched = []
        while time.monotonic() < deadline and len(launched) < 2:
            launched.extend(autoscaler.run_once()["launched"])
            time.sleep(0.3)
        a.remove()
        b.remove()
        return launched, client.sizes["pool-v5e"]

    assert _in_head_cluster(scenario) == (["v5e-slice", "v5e-slice"], 2)


# ------------------------------------------------------------------ pins

def test_tpu_slice_node_type_raises_naming_item_9():
    """Once a pin on the unported slice geometry; now the JAX package's
    name is the port's ``gpu_slice_node_type``, and the node type it
    gives matches the reference's once TPU terms map to GPU ones (v4
    hosts 4 chips as gb200 hosts 4 cards)."""
    from ant_ray_tpu.autoscaler import tpu_slice_node_type as jslice
    from ant_ray_tpu_torch.autoscaler import tpu_slice_node_type
    from ant_ray_tpu_torch.autoscaler.node_provider import gpu_slice_node_type

    assert tpu_slice_node_type is gpu_slice_node_type
    for topology in ("2x2x2", "4x4", "2x4x4"):
        want = _to_gpu_terms(jslice(topology, "TPU-V4", name="s"))
        got = tpu_slice_node_type(topology, "GB200", name="s")
        assert _type_fields(got) == want, topology
    # Where a slice is smaller than a host, the port's host holds just
    # the slice's cards (the reference's v4 rule gives 4 chips a host).
    assert tpu_slice_node_type("1x1", "GB200").resources["GPU"] == 1.0
    single = gpu_slice_node_type("1x8", "H100")
    assert single.name == "gpu-h100-8-slice"
    assert single.hosts_per_launch == 1
    assert single.resources == {"CPU": 8.0, "GPU": 8.0}
    assert single.head_resources == {"GPU-h100-8-head": 1.0}


def test_exports_match_the_reference():
    ref = _mod(jart, "autoscaler")
    port = _mod(tart, "autoscaler")
    assert port.__all__ == ref.__all__
    assert _mod(tart, "tune").__all__ == _mod(jart, "tune").__all__
