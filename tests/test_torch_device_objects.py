"""The port's device objects (``experimental/device_objects.py``,
tensors that stay in their producer's process, moved on demand) against
the JAX package's: the twins of the 3 tests of tests/test_device_objects.py
(one ``slow``), each through a cluster of each package with the same
numpy values (a torch tensor where the JAX package puts a
``jax.Array``; sums compared exactly, fp32 values that sum without
rounding), and the port's own cases: bfloat16 crossing bitwise, the
holder dropping the tensor once every ref is gone, and a CUDA-tagged
object fetched where no card is present."""

import time

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart


def test_local_mode_has_no_device_store():
    """Local mode has no per-worker device store (the JAX package's
    error; this test runs before the module's clusters start)."""
    from ant_ray_tpu_torch.experimental import device_objects

    tart.init(local_mode=True)
    try:
        with pytest.raises(RuntimeError, match="cluster mode"):
            device_objects.put(np.ones(2))
    finally:
        tart.shutdown()


@pytest.fixture(scope="module")
def device_cluster():
    jart.init(num_cpus=2)
    try:
        tart.init(num_cpus=2)
        try:
            yield None
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _device_objects(art):
    if art is jart:
        from ant_ray_tpu.experimental import device_objects
    else:
        from ant_ray_tpu_torch.experimental import device_objects
    return device_objects


def _array(art, value):
    """``value`` (numpy) as the package's device array."""
    if art is jart:
        import jax.numpy as jnp

        return jnp.asarray(value)
    import torch

    return torch.from_numpy(np.array(value))


def _roundtrip(art):
    @art.remote
    class Producer:
        def make(self, n):
            self.arr = _array(art, np.arange(n, dtype=np.float32) * 2.0)
            return _device_objects(art).put(self.arr)

        def is_local_hit(self, ref):
            return _device_objects(art).get(ref) is self.arr

    @art.remote
    class Consumer:
        def total(self, ref):
            return float(_device_objects(art).get(ref).sum())

    p = Producer.remote()
    c = Consumer.remote()
    ref = art.get(p.make.remote(1000))
    return (art.get(p.is_local_hit.remote(ref), timeout=60),
            art.get(c.total.remote(ref), timeout=60))


def test_device_object_roundtrip_actors(device_cluster):
    want = _roundtrip(jart)
    got = _roundtrip(tart)
    assert got == want == (
        True, float(np.arange(1000, dtype=np.float32).sum() * 2.0))


def _get_and_free(art):
    device_objects = _device_objects(art)

    @art.remote
    class Holder:
        def make(self):
            return _device_objects(art).put(
                _array(art, np.ones((8, 8), np.float32)))

        def held(self):
            from importlib import import_module

            worker = import_module(art.__name__ + "._private.worker")
            return len(worker.global_worker.runtime._device_objects)

    h = Holder.remote()
    ref = art.get(h.make.remote())
    arr = device_objects.get(ref, timeout=60)
    out = [tuple(arr.shape), float(np.asarray(arr).sum())]
    device_objects.free(ref)
    time.sleep(0.3)  # oneway free drains
    out.append(art.get(h.held.remote(), timeout=60))
    with pytest.raises(art.exceptions.ObjectLostError):
        device_objects.get(ref, timeout=30)
    return out


def test_device_object_driver_get_and_free(device_cluster):
    want = _get_and_free(jart)
    got = _get_and_free(tart)
    assert got == want == [(8, 8), 64.0, 0]


def _driver_side_put(art):
    device_objects = _device_objects(art)
    local = _array(art, np.full((4,), 3.0, np.float32))
    ref = device_objects.put(local)
    hit = device_objects.get(ref) is local  # driver-local zero copy

    @art.remote
    def remote_sum(r):
        return float(_device_objects(art).get(r).sum())

    return hit, art.get(remote_sum.remote(ref), timeout=60)


@pytest.mark.slow
def test_driver_side_put(device_cluster):
    want = _driver_side_put(jart)
    got = _driver_side_put(tart)
    assert got == want == (True, 12.0)


# ------------------------------------------------------------ port only

def test_bfloat16_crosses_bitwise(device_cluster):
    """The dma reply carries raw bytes and the metadata's dtype, so a
    bfloat16 tensor arrives bit for bit, with its shape."""
    import torch

    from ant_ray_tpu_torch.experimental import device_objects

    @tart.remote
    class Holder:
        def make(self):
            g = torch.Generator().manual_seed(0)
            self.t = torch.randn(3, 5, 7, generator=g).to(torch.bfloat16)
            return device_objects.put(self.t, transport="dma")

        def raw(self):
            return self.t.view(torch.int16).numpy().tobytes()

    h = Holder.remote()
    ref = tart.get(h.make.remote())
    got = device_objects.get(ref, timeout=60)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 5, 7)
    assert got.view(torch.int16).numpy().tobytes() == \
        tart.get(h.raw.remote())
    meta = tart.get(ref)
    assert (meta["dtype"], meta["device"], meta["shape"]) == \
        ("bfloat16", "cpu", (3, 5, 7))


def test_holder_drops_the_tensor_once_every_ref_is_gone(device_cluster):
    """Lifetime rides the metadata object's refcount: with the grace pin
    shortened in the holder, the driver dropping its last ref frees the
    holder's tensor."""
    import gc

    from ant_ray_tpu_torch.experimental import device_objects

    @tart.remote
    class Holder:
        def make(self):
            import functools

            import torch

            from ant_ray_tpu_torch._private.worker import global_worker

            rt = global_worker.runtime
            if not isinstance(rt.pin_for_grace, functools.partial):
                rt.pin_for_grace = functools.partial(rt.pin_for_grace,
                                                     grace_s=0.5)
            return device_objects.put(torch.ones(16))

        def held(self):
            from ant_ray_tpu_torch._private.worker import global_worker

            return len(global_worker.runtime._device_objects)

    h = Holder.remote()
    ref = tart.get(h.make.remote())
    assert float(device_objects.get(ref, timeout=60).sum()) == 16.0
    assert tart.get(h.held.remote()) == 1
    del ref
    gc.collect()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and tart.get(h.held.remote()):
        time.sleep(0.2)
    assert tart.get(h.held.remote()) == 0


def test_cuda_object_without_a_card_raises_unless_device_cpu(device_cluster):
    """A device object put from a CUDA tensor lands on ``cuda`` in the
    consumer; where the consumer has no card it raises, naming the way
    out, and ``device="cpu"`` gives a CPU tensor."""
    import torch

    from ant_ray_tpu_torch.experimental import device_objects

    @tart.remote
    class Holder:
        def make(self):
            self.t = torch.arange(6, dtype=torch.float32)
            return device_objects.put(self.t)

    h = Holder.remote()
    ref = tart.get(h.make.remote())
    # The metadata of the same bytes as if they had been put from a card.
    meta = {**tart.get(ref), "device": "cuda"}
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        device_objects.get(meta, timeout=30)
    got = device_objects.get(meta, timeout=30, device="cpu")
    assert got.device.type == "cpu"
    assert got.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
