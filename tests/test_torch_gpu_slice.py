"""The port's slice-aware gang scheduling (``util/gpu.py``, the
controller's slice reservation) against the JAX package's
(``util/tpu.py``): the twins of the 9 tests of tests/test_tpu_slice.py.

Two fake slices per package, each of two hosts, as labeled node groups
of one ``Cluster``: the JAX package's v4 "2x2x2" slices (4 chips a
host) and the port's gb200 "2x2x2" slices (4 cards a host, the same
geometry).  Each scenario runs in both clusters; its outcome — where
bundles land (pod name, worker id), what is ready, what raises — is
compared after the JAX package's TPU terms are mapped to GPU ones."""

import importlib
import os

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PREFIX = {jart: "tpu", tart: "gpu"}
GEN = {jart: "v4", tart: "gb200"}
ACCEL = {jart: "TPU-V4", tart: "GB200"}
RES = {jart: "TPU", tart: "GPU"}


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _slice_node(art, cluster, pod_name: str, worker_id: int):
    p = PREFIX[art]
    return cluster.add_node(
        num_cpus=2,
        resources={RES[art]: 4},
        labels={
            f"{p}-generation": GEN[art],
            f"{p}-pod-name": pod_name,
            f"{p}-worker-id": str(worker_id),
            f"{p}-pod-type": f"{GEN[art]}-8",
            f"{p}-topology": "2x2x2",
        })


@pytest.fixture(scope="module")
def two_slices():
    clusters = {}
    try:
        for art in (jart, tart):
            cluster = _mod(art, "cluster_utils").Cluster(
                head_node_args={"num_cpus": 2})
            clusters[art] = cluster
            for pod in ("slice-A", "slice-B"):
                for wid in (0, 1):
                    _slice_node(art, cluster, pod, wid)
            cluster.connect()
        yield clusters
    finally:
        for art, cluster in clusters.items():
            art.shutdown()
            cluster.shutdown()


def _slices(art):
    if art is jart:
        return _mod(art, "util.tpu")
    return _mod(art, "util.gpu")


def _labels(art, address):
    for n in art.nodes():
        if n["Address"] == address:
            return {k.split("-", 1)[1]: v for k, v in n["Labels"].items()
                    if k.startswith(PREFIX[art] + "-")}
    raise AssertionError(f"no node at {address}")


def _both(scenario):
    outs = [scenario(art) for art in (jart, tart)]
    assert outs[0] == outs[1], outs
    return outs[1]


def test_slice_pg_lands_on_one_slice(two_slices):
    def scenario(art):
        spg_fn = _slices(art).slice_placement_group
        spg = spg_fn("2x2x2", ACCEL[art])
        out = [spg.num_hosts, spg.chips_per_host,
               spg.pod_type.replace(GEN[art], "gen"), spg.ready(timeout=60)]
        labels = [_labels(art, spg.placement_group.bundle_node(i))
                  for i in range(2)]
        # Both bundles on ONE slice, rank i on worker-id i.
        out += [labels[0]["pod-name"] == labels[1]["pod-name"],
                [la["worker-id"] for la in labels]]
        # A second slice group takes the OTHER slice.
        spg2 = spg_fn("2x2x2", ACCEL[art])
        out.append(spg2.ready(timeout=60))
        other = _labels(art, spg2.placement_group.bundle_node(0))
        out.append(other["pod-name"] != labels[0]["pod-name"])
        # No third slice exists: reservation must not become ready.
        spg3 = spg_fn("2x2x2", ACCEL[art])
        out.append(spg3.ready(timeout=3))
        for g in (spg3, spg2, spg):
            g.remove()
        return out

    assert _both(scenario) == [2, 4, "gen-8", True, True, ["0", "1"],
                               True, True, False]


def test_head_resource_advertised(two_slices):
    """Worker-0 hosts advertise <TPU|GPU>-<pod_type>-head (slice
    exclusivity): one per slice."""
    def scenario(art):
        return art.cluster_resources().get(
            f"{RES[art]}-{GEN[art]}-8-head")

    assert _both(scenario) == 2.0


def test_task_label_selector(two_slices):
    def scenario(art):
        @art.remote(label_selector={f"{PREFIX[art]}-pod-name": "slice-B"})
        def where():
            return os.environ["ART_NODE_ID"]

        spots = {art.get(where.remote(), timeout=60) for _ in range(4)}
        return sorted({n["Labels"][f"{PREFIX[art]}-pod-name"]
                       for n in art.nodes() if n["NodeID"] in spots})

    assert _both(scenario) == ["slice-B"]


def test_actor_label_selector(two_slices):
    def scenario(art):
        p = PREFIX[art]

        @art.remote(label_selector={f"{p}-worker-id": "1",
                                    f"{p}-pod-name": "slice-A"})
        class Pinned:
            def where(self):
                return os.environ["ART_NODE_ID"]

        a = Pinned.remote()
        node_id = art.get(a.where.remote(), timeout=60)
        node = next(n for n in art.nodes() if n["NodeID"] == node_id)
        art.kill(a)
        return node["Labels"][f"{p}-pod-name"], \
            node["Labels"][f"{p}-worker-id"]

    assert _both(scenario) == ("slice-A", "1")


def test_infeasible_label_selector_errors(two_slices):
    def scenario(art):
        @art.remote(label_selector={f"{PREFIX[art]}-pod-name":
                                    "no-such-slice"})
        def nowhere():
            return 1

        with pytest.raises(art.exceptions.ArtError) as err:
            art.get(nowhere.remote(), timeout=60)
        return type(err.value).__name__

    _both(scenario)


@pytest.mark.slow
def test_train_fit_on_fake_slice(two_slices, tmp_path_factory):
    """End-to-end: the trainer gang-places its rank actors INSIDE the
    slice bundles (rank i on slice host i) and completes a run."""
    def scenario(art):
        train = _mod(art, "train")
        p = PREFIX[art]

        def loop():
            ctx = train.get_context()
            train.report({"rank": ctx.world_rank,
                          "node": os.environ["ART_NODE_ID"],
                          "world": ctx.world_size})

        if art is jart:
            scaling = train.ScalingConfig(
                num_workers=2, use_tpu=True, topology="2x2x2",
                accelerator_type="TPU-V4", chips_per_worker=4)
            trainer_cls = train.JaxTrainer
        else:
            scaling = train.ScalingConfig(
                num_workers=2, use_gpu=True, topology="2x2x2",
                accelerator_type="GB200")
            trainer_cls = train.TorchTrainer
        result = trainer_cls(
            loop, scaling_config=scaling,
            run_config=train.RunConfig(
                name="slice-e2e",
                storage_path=str(tmp_path_factory.mktemp("train")))).fit()
        assert result.error is None, result.error
        rank0 = next(n for n in art.nodes()
                     if n["NodeID"] == result.metrics["node"])
        return (result.metrics["world"], rank0["Labels"][f"{p}-worker-id"],
                rank0["Labels"][f"{p}-pod-name"] in ("slice-A", "slice-B"))

    assert _both(scenario) == (2, "0", True)


def test_multi_slice_pg_spans_distinct_slices(two_slices):
    """ONE placement group covering BOTH slices: per-slice bundle
    blocks land on distinct pods, rank order inside each block follows
    the worker id."""
    def scenario(art):
        mspg = _slices(art).multi_slice_placement_group
        ms = mspg("2x2x2", num_slices=2, accelerator_type=ACCEL[art])
        try:
            out = [ms.num_hosts, ms.hosts_per_slice, ms.ready(timeout=60)]
            labels = [_labels(art, ms.placement_group.bundle_node(i))
                      for i in range(4)]
            pods = [la["pod-name"] for la in labels]
            out += [pods[0] == pods[1] and pods[2] == pods[3],
                    pods[0] != pods[2],
                    [la["worker-id"] for la in labels],
                    [ms.slice_of_bundle(i) for i in range(4)]]
        finally:
            ms.remove()
        # Only two physical slices exist: a 3-slice group can't be placed.
        ms3 = mspg("2x2x2", num_slices=3, accelerator_type=ACCEL[art])
        with pytest.raises(RuntimeError, match="infeasible"):
            ms3.ready(timeout=3)
        ms3.remove()
        return out

    assert _both(scenario) == [4, 2, True, True, True,
                               ["0", "1", "0", "1"], [0, 0, 1, 1]]


def _controller(art, **scaling):
    train_config = _mod(art, "train.config")
    controller = _mod(art, "train.controller")
    if art is jart:
        scaling = train_config.ScalingConfig(
            use_tpu=True, accelerator_type="TPU-V4", chips_per_worker=4,
            **scaling)
    else:
        scaling = train_config.ScalingConfig(
            use_gpu=True, accelerator_type="GB200", **scaling)
    return controller.TrainController(
        loop_fn=lambda: None, loop_config=None, scaling=scaling,
        run_config=train_config.RunConfig(name="slice-test"))


def test_train_controller_reserves_multi_slice(two_slices):
    """num_slices=2 routes gang reservation through the multi-slice
    placement group: 4 ranks, contiguous 2-rank blocks per slice."""
    def scenario(art):
        controller = _controller(art, num_workers=4, num_slices=2,
                                 topology="2x2x2")
        pg, ms = controller._reserve_gang(controller._scaling)
        try:
            labels = [_labels(art, pg.bundle_node(i)) for i in range(4)]
            pods = [la["pod-name"] for la in labels]
            return (ms.num_hosts, pods[0] == pods[1] and pods[2] == pods[3],
                    pods[0] != pods[2])
        finally:
            controller._worker_pg = pg
            controller._worker_slice = ms
            controller._release_gang()

    assert _both(scenario) == (4, True, True)


def test_train_controller_reserves_slice(two_slices):
    """The controller gang-reserves a slice and pins rank i to slice
    host i (ref: worker_group.py:269 PG creation)."""
    def scenario(art):
        controller = _controller(art, num_workers=2, topology="2x2x2")
        pg, spg = controller._reserve_gang(controller._scaling)
        try:
            labels = [_labels(art, pg.bundle_node(i)) for i in range(2)]
            return (spg.num_hosts,
                    labels[0]["pod-name"] == labels[1]["pod-name"],
                    [la["worker-id"] for la in labels])
        finally:
            controller._worker_pg = pg
            controller._worker_slice = spg
            controller._release_gang()

    assert _both(scenario) == (2, True, ["0", "1"])
