"""The port's ``autoscaler/`` (the control loop, the gang planner, the
local and GKE node providers) against the JAX package's.  The twins of
tests/test_autoscaler.py's tests but the TPU-slice ones (``:48``,
``:90``, ``:103``, ``:146``, ``:177``, ``:187``, ``:199``) run through
both packages, each scenario in a ``Cluster`` of its own package, and
their outcomes must be equal; ``plan_gang`` is held against the
reference on host sets that hypothesis draws; a plain ``STRICT_SPREAD``
gang drives the gang path end to end in both; the GKE REST client and
provider run against one fake API; and ``tpu_slice_node_type`` raises,
naming the ROADMAP item that brings slice geometry."""

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


def _in_cluster(scenario, head_cpus=1):
    """``scenario(art, cluster, make)`` in a one-head ``Cluster`` of each
    package in turn; ``make(node_types, **cfg)`` builds an autoscaler
    over a ``LocalSubprocessProvider`` whose daemons are torn down
    before the cluster.  Returns both outcomes, held equal."""
    outs = []
    for art in PACKAGES:
        auto = _mod(art, "autoscaler")
        cluster = _mod(art, "cluster_utils").Cluster(
            head_node_args={"num_cpus": head_cpus})
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
        self._n = 0

    def request(self, method, path, body=None):
        self.log.append((method, path.rsplit("/", 1)[1]))
        for op in self.ops.values():
            if op["status"] == "RUNNING":
                op["ttl"] -= 1
                if op["ttl"] <= 0:
                    op["status"] = "DONE"
                    self.pools[op["pool"]]["initialNodeCount"] = \
                        op["target"]
                    self.inflight.pop(op["pool"], None)
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
                                  "provider", "done_with_error"])
def test_gke_rest_client_against_a_fake_api(name):
    outs = [_gke_scenario(name, _mod(art, "autoscaler"))
            for art in PACKAGES]
    assert outs[0] == outs[1]


# ------------------------------------------------------------------ pins

def test_tpu_slice_node_type_raises_naming_item_9():
    from ant_ray_tpu_torch.autoscaler import tpu_slice_node_type

    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP queue A item 9"):
        tpu_slice_node_type("4x4", name="v5e-slice")


def test_exports_match_the_reference():
    ref = _mod(jart, "autoscaler")
    port = _mod(tart, "autoscaler")
    assert port.__all__ == ref.__all__
    assert _mod(tart, "tune").__all__ == _mod(jart, "tune").__all__
