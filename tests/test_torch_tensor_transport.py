"""The port's tensor transports (``experimental/tensor_transport.py``)
against the JAX package's: the twins of the 7 tests of
tests/test_tensor_transport.py.  The JAX package shards an (8, 16) fp32
array over a (2, 4) mesh of 8 virtual CPU devices; the port shards the
same values as a ``ShardedTensor`` over a (2, 4) mesh of 8 ``cpu``
cells.  Values are compared exactly (integers in fp32), and so are the
selected transport, the layout and the shard counts."""

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

MESH_SHAPE = (2, 4)
ARR_SHAPE = (8, 16)


@pytest.fixture(scope="module")
def transport_cluster():
    jart.init(num_cpus=4)
    try:
        tart.init(num_cpus=4)
        try:
            yield None
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _values(scale=1.0):
    return (np.arange(ARR_SHAPE[0] * ARR_SHAPE[1], dtype=np.float32)
            .reshape(ARR_SHAPE) * scale)


def _make_sharded_jax(value_scale=1.0):
    import jax

    mesh = jax.sharding.Mesh(
        np.asarray(jax.local_devices()[:8]).reshape(MESH_SHAPE), ("x", "y"))
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("x", "y"))
    return jax.device_put(_values(value_scale), sharding)


def _make_sharded_torch(value_scale=1.0):
    import torch

    from ant_ray_tpu_torch.parallel import spmd
    from ant_ray_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(MESH_SHAPE),
                ("x", "y"))
    return spmd.shard(torch.from_numpy(_values(value_scale)),
                      spmd.NamedSharding(mesh, spmd.PartitionSpec("x", "y")))


def _package(name):
    return tart if name == "torch" else jart


def _tt(art):
    if art is jart:
        from ant_ray_tpu.experimental import tensor_transport
    else:
        from ant_ray_tpu_torch.experimental import tensor_transport
    return tensor_transport


class _Peer:
    """Actor that can hold/fetch device objects over a collective group
    (``kind``: "jax" or "torch", the package it runs)."""

    def __init__(self, kind):
        self.kind = kind

    def _art(self):
        return _package(self.kind)

    def _do(self):
        if self.kind == "jax":
            from ant_ray_tpu.experimental import device_objects
        else:
            from ant_ray_tpu_torch.experimental import device_objects
        return device_objects

    def _make(self, scale):
        return (_make_sharded_jax(scale) if self.kind == "jax"
                else _make_sharded_torch(scale))

    def init_collective_group(self, world_size, rank, backend, group_name):
        if self.kind == "jax":
            from ant_ray_tpu.util.collective import collective as col
        else:
            from ant_ray_tpu_torch.util.collective import collective as col
        col.init_collective_group(world_size, rank, backend, group_name)
        return True

    def put_sharded(self, group_name):
        self.arr = self._make(1.0)
        return self._do().put(self.arr, group_name=group_name)

    def put_sharded_no_group(self):
        self.arr = self._make(3.0)
        return self._do().put(self.arr)

    def fetch(self, ref):
        """(selected transport name, value, n_shards, sharded)."""
        from importlib import import_module

        art = self._art()
        worker = import_module(art.__name__ + "._private.worker")
        runtime = worker.global_worker.runtime
        meta = ref if isinstance(ref, dict) else art.get(ref)
        name = _tt(art).select_transport(meta, runtime).name
        arr = self._do().get(ref)
        if self.kind == "jax":
            shards = getattr(arr, "addressable_shards", [])
            return (name, np.asarray(arr), len(shards),
                    getattr(arr, "sharding", None) is not None)
        from ant_ray_tpu_torch.parallel.spmd import ShardedTensor

        sharded = isinstance(arr, ShardedTensor)
        value = arr.full() if sharded else arr
        return (name, value.numpy(), len(arr.shards) if sharded else 0,
                sharded)


def _peer(art):
    kind = "jax" if art is jart else "torch"
    return art.remote(_Peer).remote(kind)


def _collective_run(art, group):
    a, b = _peer(art), _peer(art)
    art.get([a.init_collective_group.remote(2, 0, "gloo", group),
             b.init_collective_group.remote(2, 1, "gloo", group)],
            timeout=60)
    ref = art.get(a.put_sharded.remote(group), timeout=60)
    return art.get(b.fetch.remote(ref), timeout=120)


def test_collective_transport_moves_sharded_array(transport_cluster):
    outs = [_collective_run(art, f"dt-{art.__name__}")
            for art in (jart, tart)]
    for name, value, n_shards, sharded in outs:
        # Auto-selected the collective path from the layout metadata...
        assert name == "collective"
        np.testing.assert_array_equal(value, _values())
        # ...and the consumer reassembled a SHARDED tensor on its own
        # mesh (8 shards — never one host buffer).
        assert n_shards == 8 and sharded


def test_dma_fallback_outside_group(transport_cluster):
    for art in (jart, tart):
        a, c = _peer(art), _peer(art)       # c never joins a group
        ref = art.get(a.put_sharded_no_group.remote(), timeout=60)
        name, value, _n, _s = art.get(c.fetch.remote(ref), timeout=120)
        assert name == "dma"
        np.testing.assert_array_equal(value, _values(3.0))


def test_transport_registry_prefers_custom(transport_cluster):
    for art in (jart, tart):
        tt = _tt(art)

        class NullTransport(tt.TensorTransport):
            name = "null"

            @staticmethod
            def can_fetch(meta, runtime):
                return meta.get("want_null", False)

            @staticmethod
            def fetch(meta, runtime, timeout, device=None):  # pragma: no cover
                return None

        tt.register_transport(NullTransport)
        try:
            assert tt.select_transport({"want_null": True}, None) \
                is NullTransport
            assert tt.select_transport({}, None) is tt.DmaTransport
        finally:
            tt.TRANSPORTS.remove(NullTransport)
        assert [t.name for t in tt.TRANSPORTS] == ["collective", "dma"]


def test_shard_layout_metadata(transport_cluster):
    import jax.numpy as jnp
    import torch

    want = _tt(jart).shard_layout(_make_sharded_jax())
    got = _tt(tart).shard_layout(_make_sharded_torch())
    for layout in (want, got):
        assert tuple(layout["mesh_shape"]) == MESH_SHAPE
        assert layout["axis_names"] == ("x", "y")
        assert len(layout["shards"]) == 8
        assert all(s["shape"] == (4, 4) for s in layout["shards"])
    assert got["spec"] == tuple(want["spec"]) == ("x", "y")
    assert [(s["pos"], s["shape"], s["dtype"]) for s in got["shards"]] == \
        sorted((s["pos"], s["shape"], s["dtype"]) for s in want["shards"])
    assert got["cell_devices"] == ("cpu",) * 8
    # Single-device arrays carry no layout (dma handles them).
    assert _tt(jart).shard_layout(jnp.ones((4,))) is None
    assert _tt(tart).shard_layout(torch.ones(4)) is None


# ---- send-side hardening: per-destination locks, bounded deadline,
# ---- poison healing on group teardown


def test_send_locks_are_per_destination():
    for art in (jart, tart):
        tt = _tt(art)
        a = tt._send_lock_for("g-locks", 1)
        b = tt._send_lock_for("g-locks", 2)
        c = tt._send_lock_for("g-locks", 1)
        assert a is c and a is not b       # same pair → same lock, only
        tt.clear_group("g-locks")


def _wedged_run(art, monkeypatch, arr):
    import threading
    import time

    if art is jart:
        from ant_ray_tpu.util.collective import collective as col
    else:
        from ant_ray_tpu_torch.util.collective import collective as col
    tt = _tt(art)
    calls = []
    started = threading.Event()

    def wedged_send(data, dst, group):
        calls.append(dst)
        started.set()
        time.sleep(30)                 # consumer never recvs

    monkeypatch.setattr(col, "send", wedged_send)
    t0 = time.monotonic()
    tt.send_shards(arr, 1, "g-wedge", deadline_s=0.3)
    out = [time.monotonic() - t0 < 5, started.wait(1),
           ("g-wedge", 1) in tt._poisoned_pairs]
    # Poisoned pair: further sends to it are skipped outright...
    n_calls = len(calls)
    tt.send_shards(arr, 1, "g-wedge", deadline_s=0.3)
    out.append(len(calls) == n_calls)
    # ...but a different destination on the same group still sends.
    monkeypatch.setattr(col, "send", lambda d, dst, g: calls.append(dst))
    tt.send_shards(arr, 2, "g-wedge", deadline_s=5.0)
    out.append(calls[-1])
    # Group teardown heals the pair for the next incarnation.
    col.destroy_collective_group("g-wedge")
    out += [("g-wedge", 1) not in tt._poisoned_pairs,
            all(k[0] != "g-wedge" for k in tt._send_locks)]
    return out


def test_send_shards_bounded_deadline_poisons_pair(monkeypatch):
    """A consumer that never posts its recvs must not wedge the holder:
    the send is abandoned at the deadline and the pair poisoned, while
    sends to OTHER destinations stay unaffected (per-dest locks)."""
    want = _wedged_run(jart, monkeypatch, _make_sharded_jax())
    got = _wedged_run(tart, monkeypatch, _make_sharded_torch())
    assert got == want == [True, True, True, True, 2, True, True]


def test_destroy_group_clears_transport_state_even_if_uninitialized():
    for art in (jart, tart):
        tt = _tt(art)
        if art is jart:
            from ant_ray_tpu.util.collective import collective as col
        else:
            from ant_ray_tpu_torch.util.collective import collective as col
        tt._poisoned_pairs.add(("g-ghost", 3))
        tt._pair_lock("g-ghost", 3)
        tt._send_lock_for("g-ghost", 3)
        col.destroy_collective_group("g-ghost")   # never existed here
        assert ("g-ghost", 3) not in tt._poisoned_pairs
        assert all(k[0] != "g-ghost" for k in tt._fetch_locks)
        assert all(k[0] != "g-ghost" for k in tt._send_locks)


def test_host_assemble_rebuilds_the_global_tensor():
    """The degraded path (a consumer without the holder's cells): the
    shards, placed by the layout's spec, rebuild the global tensor."""
    import torch

    tt = _tt(tart)
    x = _make_sharded_torch()
    layout = tt.shard_layout(x)
    out = tt._host_assemble(layout, [s.clone() for s in x.shards],
                            {"shape": tuple(x.shape)})
    assert torch.equal(out, torch.from_numpy(_values()))
