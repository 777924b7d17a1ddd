"""The port's collective groups (``util/collective``) against the JAX
package's: the twins of tests/test_collective.py's ``:19`` (backend
names, mirrored: ``nccl`` in, ``xla`` refused), ``:28`` (a group's
lifecycle, on gloo in the port where the reference's is xla), ``:36``
(an unknown group) and ``:124`` (gloo across two actors in a cluster
of each package, results equal).  Also: an NCCL group on a host
without CUDA raises, naming the cause, and is never made over gloo;
the gloo rendezvous binds before it advertises, so a port taken between
the JAX package's pick and bind (its ``EADDRINUSE``) cannot hit the
port's.  The NCCL group at world size 1 on the card is a ``gpu`` test
in tests/test_torch_cuda.py."""

import socket
import threading

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from ant_ray_tpu.util import collective as jcol
from ant_ray_tpu_torch.util import collective as col
from ant_ray_tpu_torch.util.collective import ReduceOp


@pytest.fixture
def gloo1():
    col.init_collective_group(world_size=1, rank=0, backend="gloo",
                              group_name="g")
    yield "g"
    col.destroy_collective_group("g")


@pytest.fixture
def jxla1():
    jcol.init_collective_group(world_size=1, rank=0, backend="xla",
                               group_name="g")
    yield "g"
    jcol.destroy_collective_group("g")


# ------------------------------------------- tests/test_collective.py :19

def test_backend_normalize():
    from ant_ray_tpu.util.collective.types import Backend as JBackend
    from ant_ray_tpu_torch.util.collective.types import Backend

    assert JBackend.normalize("TPU") == "xla"
    assert JBackend.normalize("cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        JBackend.normalize("nccl")
    # The port mirrors it: nccl in, xla out.
    for name in ("nccl", "NCCL", "cuda", "gpu"):
        assert Backend.normalize(name) == "nccl"
    for name in ("cpu", "gloo", "torch_gloo"):
        assert Backend.normalize(name) == JBackend.normalize(name) == "gloo"
    for name in ("xla", "TPU", "ici"):
        with pytest.raises(ValueError, match="nccl"):
            Backend.normalize(name)
    with pytest.raises(ValueError, match="Unknown"):
        Backend.normalize("mpi")


# ------------------------------------------- tests/test_collective.py :28

def test_group_lifecycle(gloo1, jxla1):
    for c in (jcol, col):
        assert c.is_group_initialized("g")
        assert c.get_rank("g") == 0
        assert c.get_collective_group_size("g") == 1
    with pytest.raises(RuntimeError):
        jcol.init_collective_group(1, 0, backend="xla", group_name="g")
    with pytest.raises(RuntimeError, match="already exists"):
        col.init_collective_group(1, 0, backend="gloo", group_name="g")
    # World size 1: the per-rank verbs hand the input back, in both.
    x = np.arange(4.0)
    for c in (jcol, col):
        np.testing.assert_array_equal(np.asarray(c.allreduce(x, "g")), x)
        np.testing.assert_array_equal(np.asarray(c.broadcast(x, 0, "g")), x)
        assert len(c.allgather(x, "g")) == 1
        c.barrier("g")


def test_destroyed_group_is_gone(gloo1, tmp_path):
    col.destroy_collective_group("g")
    assert not col.is_group_initialized("g")
    # A group made again under the name; an explicit init_method (here
    # a file store) skips the rendezvous, as in the JAX package.
    col.init_collective_group(1, 0, backend="gloo", group_name="g",
                              init_method=f"file://{tmp_path}/store")
    np.testing.assert_array_equal(col.allreduce(np.ones(3), "g"),
                                  np.ones(3))


# ------------------------------------------- tests/test_collective.py :36

def test_uninitialized_group_errors():
    for c in (jcol, col):
        with pytest.raises(RuntimeError, match="not initialized"):
            c.allreduce(np.ones(2), group_name="nope")


# ---------------------------------------------------- NCCL without a card

def test_nccl_group_raises_without_cuda_naming_the_cause():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the NCCL group is made there")
    with pytest.raises(RuntimeError, match="CUDA") as ei:
        col.init_collective_group(1, 0, backend="nccl", group_name="n")
    assert "gloo" in str(ei.value)          # says it is not replaced
    assert not col.is_group_initialized("n")
    # and no gloo group took its place: the default process group is free
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        col.init_collective_group(1, 0, backend="cuda", group_name="n")


# ------------------------------------------ tests/test_collective.py :124

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


def _gloo_across_actors(art, c):
    """Two actor processes allreduce over the gloo backend with GCS-KV
    rendezvous (ref: distributed_cpu_tests)."""

    @art.remote
    class Ranker(c.CollectiveActorMixin):
        def allreduce_ones(self, world):
            out = c.allreduce(np.ones(4), group_name="gloo_g")
            return np.asarray(out).tolist()

        def verbs(self):
            rank = c.get_rank("gloo_g")
            x = np.arange(6, dtype=np.float32) + 10 * rank
            out = {
                "max": np.asarray(c.allreduce(x.copy(), "gloo_g",
                                              c.ReduceOp.MAX)).tolist(),
                "bcast": np.asarray(c.broadcast(x.copy(), 1,
                                                "gloo_g")).tolist(),
                "gather": [np.asarray(p).tolist()
                           for p in c.allgather(x.copy(), "gloo_g")],
                "scatter": np.asarray(c.reducescatter(
                    x.copy(), "gloo_g")).tolist(),
            }
            c.barrier("gloo_g")
            return out

    actors = [Ranker.remote() for _ in range(2)]
    try:
        c.create_collective_group(actors, world_size=2, ranks=[0, 1],
                                  backend="gloo", group_name="gloo_g")
        results = art.get([a.allreduce_ones.remote(2) for a in actors])
        verbs = art.get([a.verbs.remote() for a in actors])
    finally:
        for a in actors:
            art.kill(a)
    return results, verbs


def test_gloo_group_across_actors(clusters):
    want = _retry_reference_race(lambda: _gloo_across_actors(jart, jcol))
    got = _gloo_across_actors(tart, col)
    for r in got[0]:
        assert r == [2.0, 2.0, 2.0, 2.0]
    assert got == want


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


# ------------------------------------------------- rendezvous: bind first

class _FakeGcs:
    """The GCS KV calls a rendezvous makes, in this process."""

    def __init__(self):
        self.kv = {}

    def call(self, method, payload, **_kw):
        if method == "KVPut":
            self.kv[payload["key"]] = payload["value"]
            return True
        if method == "KVGet":
            return self.kv.get(payload["key"])
        if method == "KVDel":
            return self.kv.pop(payload["key"], None) is not None
        raise AssertionError(method)


def test_gloo_rendezvous_binds_before_it_advertises(monkeypatch):
    """A port taken between the JAX package's pick (``find_free_port``)
    and its bind makes its rendezvous fail with ``EADDRINUSE``; the
    port's rank 0 binds port 0 first and advertises what it got, so the
    same taken port cannot reach it."""
    import torch.distributed as dist

    from ant_ray_tpu._private import protocol as jprotocol
    from ant_ray_tpu._private.worker import global_worker as jworker
    from ant_ray_tpu.util.collective.collective_group import (
        gloo_group as jgloo,
    )
    from ant_ray_tpu_torch._private import protocol
    from ant_ray_tpu_torch._private.worker import global_worker
    from ant_ray_tpu_torch.util.collective.collective_group import gloo_group

    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    port = taken.getsockname()[1]
    try:
        for module in (jprotocol, protocol):
            monkeypatch.setattr(module, "find_free_port", lambda: port)
        runtime = type("Runtime", (), {"_gcs": _FakeGcs()})()
        monkeypatch.setattr(jworker, "runtime", runtime)
        monkeypatch.setattr(global_worker, "runtime", runtime)

        # The JAX package: the advertised port is the taken one, and
        # rank 0's store cannot bind it.
        method = jgloo.rendezvous_init_method("race", 0)
        assert method == f"tcp://127.0.0.1:{port}"
        with pytest.raises(Exception, match="(?i)address already in use"):
            dist.TCPStore("127.0.0.1", port, 2, is_master=True,
                          wait_for_workers=False)

        # The port: rank 0 binds, then advertises; rank 1 meets it.
        stores = {}

        def rank(r):
            stores[r] = gloo_group.rendezvous_store("race", r, 2, "gloo",
                                                    timeout_s=30)

        peer = threading.Thread(target=rank, args=(1,))
        peer.start()
        rank(0)
        peer.join(30)
        advertised = runtime._gcs.kv["collective:race:gloo_store"].decode()
        assert advertised == f"127.0.0.1:{stores[0].port}"
        assert stores[0].port != port
        stores[0].set("k", b"v")
        assert stores[1].get("k") == b"v"
        gloo_group.forget_rendezvous("race", "gloo")
        assert "collective:race:gloo_store" not in runtime._gcs.kv
    finally:
        taken.close()


def test_gloo_group_takes_a_store_and_reduces_in_two_threads():
    """Two ranks of one store in one process reduce through the shared
    bucket path's primitives (the default process group is per process,
    so the second rank is a plain gloo process group here)."""
    import torch
    import torch.distributed as dist

    from ant_ray_tpu_torch.util.collective.collective_group import (
        torch_group,
    )

    store = dist.HashStore()
    pgs = {}

    def make(r):
        pgs[r] = dist.ProcessGroupGloo(store, r, 2)

    t = threading.Thread(target=make, args=(1,))
    t.start()
    make(0)
    t.join(30)
    groups = {}
    for r in range(2):
        g = torch_group.TorchDistGroup(2, r, "two")
        g._pg, g._wire = pgs[r], torch.device("cpu")
        groups[r] = g
    outs = {}

    def run(r):
        x = torch.full((5,), float(r + 1))
        outs[r] = (groups[r]._all_reduce(x.clone(), ReduceOp.AVERAGE),
                   groups[r]._all_gather(x))

    t = threading.Thread(target=run, args=(1,))
    t.start()
    run(0)
    t.join(30)
    for r in range(2):
        assert outs[r][0].tolist() == [1.5] * 5
        assert [p.tolist() for p in outs[r][1]] == [[1.0] * 5, [2.0] * 5]
