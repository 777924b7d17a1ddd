"""The port's object plane (ids, serialization, the node-local object
store and its native arena) against the JAX package's, with the same
inputs made from a seeded numpy generator.

* ID derivations are byte-equal (the random part of an id drawn from one
  seeded generator in both packages).
* ``SerializedObject.to_payload()`` is byte-equal for values that name no
  package class, and a payload made by one package is read by the other.
* A jax array serialized by the JAX package and the same values as a
  tensor serialized by the port deserialize to equal numpy values (fp32
  and bf16), their buffers byte-equal.
* The same create/seal/pin/evict/spill sequence on both ``ObjectStore``s
  gives the same ``used``, eviction order and ``object_stats()``, and the
  same alloc/free sequence on both native arenas the same offsets.  Each
  scenario is a counterpart of a test in tests/test_object_store.py and
  keeps its assertions.
* The tensor path's own hazards: dtypes numpy lacks, views that send only
  their own bytes, buffer order, detached results, no aliasing of an
  arena slot, by-value pickling that skips the port's own modules.

Tolerance: exact everywhere (bytes, offsets, sizes, values).
"""

import dataclasses
import os
import pickle
import random
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_ray_tpu._private import ids as jids
from ant_ray_tpu._private import native as jnative_mod
from ant_ray_tpu._private import object_store as jstore
from ant_ray_tpu._private import serialization as jser
from ant_ray_tpu._private import specs as jspecs
from ant_ray_tpu import object_ref as jref
from ant_ray_tpu_torch._private import ids as tids
from ant_ray_tpu_torch._private import native as tnative_mod
from ant_ray_tpu_torch._private import object_store as tstore
from ant_ray_tpu_torch._private import serialization as tser
from ant_ray_tpu_torch._private import specs as tspecs
from ant_ray_tpu_torch import object_ref as tref

JAX = types.SimpleNamespace(name="jax", ids=jids, store=jstore, ser=jser,
                            ref=jref, load_native=jnative_mod.load_native)
PORT = types.SimpleNamespace(name="torch", ids=tids, store=tstore, ser=tser,
                             ref=tref, load_native=tnative_mod.load_native)
BOTH = [JAX, PORT]


def _both(scenario, *args):
    """Run a scenario through each package; return (jax's, the port's)."""
    return tuple(scenario(pkg, *args) for pkg in BOTH)


def _equal_across_packages(scenario, *args):
    want, got = _both(scenario, *args)
    assert got == want
    return got


# ----------------------------------------------------------------- ids


def test_id_derivations_are_byte_equal(monkeypatch):
    rng = np.random.default_rng(0)
    job_b = rng.bytes(4)
    actor_b = rng.bytes(12)
    task_b = rng.bytes(20)

    def derive(pkg):
        # One seeded generator for the random part of derived ids.
        monkeypatch.setattr(pkg.ids, "_rng", random.Random(1234))
        ids = pkg.ids
        job, actor, task = (ids.JobID(job_b), ids.ActorID(actor_b),
                            ids.TaskID(task_b))
        objs = [ids.ObjectID.for_task_return(task, i)
                for i in (0, 1, 3, 0x8000_0001)]
        counter = ids._PutIndexCounter()
        derived = [ids.TaskID.for_actor_task(actor),
                   ids.TaskID.for_actor_task(actor),
                   ids.TaskID.for_normal_task(job),
                   ids.TaskID.for_driver_task(job),
                   ids.ActorID.of(job), ids.ActorID.nil_of_job(job)]
        return ([o.binary() for o in objs],
                [o.return_index() for o in objs],
                [o.task_id().binary() for o in objs],
                [o.job_id().binary() for o in objs],
                [d.binary() for d in derived],
                derived[0].actor_id().binary(), derived[0].job_id().binary(),
                derived[2].actor_id().is_nil(),
                [counter.next(task) for _ in range(3)],
                ids.NodeID.nil().binary(), ids.NodeID.nil().is_nil())

    out = _equal_across_packages(derive)
    assert out[0][0] == task_b + (0).to_bytes(4, "big")
    assert out[4][0][:12] == actor_b


def test_id_sizes_lineage_and_errors():
    def lineage(pkg):
        ids = pkg.ids
        job = ids.JobID.from_random()
        actor = ids.ActorID.of(job)
        task = ids.TaskID.for_actor_task(actor)
        obj = ids.ObjectID.for_task_return(task, 3)
        assert actor.job_id() == job and task.actor_id() == actor
        assert obj.task_id() == task and obj.job_id() == job
        normal = ids.TaskID.for_normal_task(job)
        assert normal.actor_id() == ids.ActorID.nil_of_job(job)
        node = ids.NodeID.from_random()
        assert ids.NodeID.from_hex(node.hex()) == node
        assert len({ids.NodeID.from_random() for _ in range(100)}) == 100
        with pytest.raises(ValueError) as e:
            ids.JobID(b"toolongtoolong")
        sizes = {c.__name__: c.SIZE for c in (
            ids.JobID, ids.ActorID, ids.TaskID, ids.ObjectID, ids.NodeID,
            ids.WorkerID, ids.PlacementGroupID)}
        return (sizes, obj.return_index(), normal.actor_id().is_nil(),
                str(e.value), repr(ids.JobID(b"\x01\x02\x03\x04")),
                pickle.loads(pickle.dumps(obj)) == obj)

    out = _equal_across_packages(lineage)
    # A normal task's actor id is its job's nil actor, not the nil id.
    assert out[1] == 3 and out[2] is False


def test_task_spec_reduce_covers_every_field():
    """Counterpart of the JAX package's guard, plus the same fields in
    the same order in both packages."""
    spec = tspecs.TaskSpec(
        task_id=tids.TaskID.for_normal_task(tids.JobID(b"\x01" * 4)),
        function_id=b"f" * 8, function_name="fn", args_payload=b"args",
        num_returns=2, owner_address="127.0.0.1:1", resources={"CPU": 1.0},
        max_retries=3, retry_exceptions=False, actor_id=None,
        method_name=None, sequence_no=7, concurrency_group=None,
        placement_group_id=None, placement_group_bundle_index=-1,
        runtime_env={"env_vars": {"A": "1"}}, label_selector={"k": "v"},
        scheduling_strategy="SPREAD")
    ctor, args = spec.__reduce__()
    assert ctor is tspecs.TaskSpec
    assert args == tuple(getattr(spec, f.name)
                         for f in dataclasses.fields(tspecs.TaskSpec))
    assert ctor(*args) == spec
    for cls in ("TaskSpec", "ActorSpec", "NodeInfo"):
        assert ([(f.name, str(f.type)) for f in dataclasses.fields(
            getattr(tspecs, cls))] == [(f.name, str(f.type)) for f in
                                       dataclasses.fields(getattr(jspecs,
                                                                  cls))])


# ------------------------------------------------------- serialization


def _plain_values():
    rng = np.random.default_rng(0)
    small = 1024
    big = tser._OOB_BYTES_THRESHOLD // 8 + 16
    return {
        "int": 12345678901234567890,
        "float": 0.1,
        "none": None,
        "str": "héllo",
        "long_str": "x" * 5000,
        "bytes_under": rng.bytes(1000),
        "bytes_over": rng.bytes(tser._OOB_BYTES_THRESHOLD + 1),
        "nested": {"a": [1, {"b": (2, 3)}, "c"], "d": [[1.5], []]},
        "many_keys": {f"k{i}": i for i in range(20)},
        "array_under": rng.standard_normal(small // 8),
        "array_over": rng.standard_normal(big),
        "int_matrix": rng.integers(-5, 5, (30, 7)).astype(np.int32),
        "mixed": {"x": rng.standard_normal(100), "y": 1,
                  "z": [rng.bytes(tser._OOB_BYTES_THRESHOLD + 5), "s"]},
    }


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("name", list(_plain_values()))
def test_plain_payloads_are_byte_equal_and_cross_readable(name):
    value = _plain_values()[name]
    jpayload, tpayload = (pkg.ser.serialize(value).to_payload()
                          for pkg in BOTH)
    assert tpayload == jpayload
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        payload = writer.ser.serialize(value).to_payload()
        out = reader.ser.deserialize(
            reader.ser.SerializedObject.from_payload(payload))
        assert _same(value, out)


def test_numpy_rides_out_of_band_in_both():
    arr = np.random.default_rng(1).random(1000)

    def shape(pkg):
        ser = pkg.ser.serialize(arr)
        assert len(ser.inband) < 1000
        np.testing.assert_array_equal(pkg.ser.deserialize(ser), arr)
        return (len(ser.inband), [memoryview(b).nbytes for b in ser.buffers],
                ser.payload_nbytes(), len(ser.to_payload()))

    out = _equal_across_packages(shape)
    assert out[1] == [arr.nbytes] and out[2] == out[3]


def test_contained_refs_are_recorded_in_both():
    oid = np.random.default_rng(2).bytes(24)

    def refs(pkg):
        ref = pkg.ref.ObjectRef(pkg.ids.ObjectID(oid), _skip_refcount=True)
        ser = pkg.ser.serialize({"nested": [ref], "n": 1})
        out = pkg.ser.deserialize(ser)
        assert out["nested"][0] == ref
        return ([r.binary() for r in ser.contained_refs],
                type(out["nested"][0]).__module__.split(".")[0])

    (jrefs, jmod), (trefs, tmod) = _both(refs)
    assert trefs == jrefs == [oid]
    assert (jmod, tmod) == ("ant_ray_tpu", "ant_ray_tpu_torch")


def test_code_round_trips_in_both():
    k = 17

    def f(x):
        return x + k

    out = [pkg.ser.loads_code(pkg.ser.dumps_code(f))(1) for pkg in BOTH]
    assert out == [18, 18]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_array_and_tensor_deserialize_to_equal_numpy(dtype):
    values = np.random.default_rng(3).standard_normal((8, 33)).astype(
        np.float32)
    jarr = jnp.asarray(values, dtype=getattr(jnp, dtype))
    tens = torch.from_numpy(values).to(getattr(torch, dtype))
    jser_obj = jser.serialize({"w": jarr})
    tser_obj = tser.serialize({"w": tens})
    # The same bytes travel: bf16 rounds alike on both sides.  The port
    # sends them as one out-of-band buffer; the JAX package's host numpy
    # array does too in fp32, while numpy pickles ml_dtypes' bfloat16 in
    # the stream itself.
    (tbuf,) = [bytes(memoryview(b)) for b in tser_obj.buffers]
    assert tbuf == np.asarray(jarr).tobytes()
    assert tbuf in jser_obj.to_payload()
    jout = np.asarray(jser.deserialize(jser.SerializedObject.from_payload(
        jser_obj.to_payload()))["w"]).astype(np.float32)
    tout = tser.deserialize(tser.SerializedObject.from_payload(
        tser_obj.to_payload()))["w"]
    assert tout.dtype == getattr(torch, dtype) and tout.shape == (8, 33)
    np.testing.assert_array_equal(tout.float().numpy(), jout)


# ------------------------------------------------- the tensor's hazards

DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.float8_e4m3fn, torch.float8_e5m2, torch.int8, torch.uint8,
          torch.int16, torch.int32, torch.int64, torch.bool,
          torch.complex64]


def _random_tensor(dtype, shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_complex:
        return torch.randn(shape, generator=gen, dtype=dtype)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 4).to(dtype)
    return torch.randint(-100 if dtype != torch.uint8 else 0, 100, shape,
                         generator=gen).to(dtype)


def _bits(t):
    """A tensor's elements as bytes (bitwise comparison, NaNs included)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _via_payload(value):
    return tser.deserialize(tser.SerializedObject.from_payload(
        tser.serialize(value).to_payload()))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_tensor_round_trips_bitwise_for_every_dtype(dtype):
    t = _random_tensor(dtype, (5, 7))
    out = _via_payload(t)
    assert (out.dtype, out.shape, out.device.type) == (dtype, t.shape, "cpu")
    assert _bits(out) == _bits(t)


def test_views_send_only_their_own_elements():
    base = _random_tensor(torch.bfloat16, (4, 6, 8, 16))
    views = {"slot": base[:, 2], "strided": base[..., ::3],
             "transposed": base.transpose(1, 3), "offset": base[3, 5],
             "scalar": base[1, 2, 3, 4], "empty": base[:, :0]}
    for name, view in views.items():
        ser = tser.serialize(view)
        assert [memoryview(b).nbytes for b in ser.buffers] == \
            [view.numel() * view.element_size()], name
        out = tser.deserialize(ser)
        assert out.shape == view.shape and out.is_contiguous(), name
        assert torch.equal(out, view), name


def test_tensor_buffer_keeps_the_order_of_other_buffers():
    rng = np.random.default_rng(4)
    a, c = rng.standard_normal(300), rng.integers(0, 9, 500)
    blob = rng.bytes(tser._OOB_BYTES_THRESHOLD + 3)
    t = _random_tensor(torch.bfloat16, (3, 64))
    value = (a, t, {"c": c, "blob": blob, "t2": t[:, 1:]}, torch.tensor(7))
    out = _via_payload(value)
    np.testing.assert_array_equal(out[0], a)
    assert _bits(out[1]) == _bits(t)
    np.testing.assert_array_equal(out[2]["c"], c)
    assert out[2]["blob"] == blob
    assert torch.equal(out[2]["t2"], t[:, 1:])
    assert out[3].shape == () and out[3].item() == 7


def test_grad_tracking_and_parameters_become_plain_detached_tensors():
    w = torch.nn.Parameter(torch.randn(3, 4))
    y = (w * 2).sum(dim=0)      # non-leaf, tracks grad
    out = _via_payload({"param": w, "act": y})
    for name, src in (("param", w), ("act", y)):
        got = out[name]
        assert type(got) is torch.Tensor, name
        assert not got.requires_grad and got.grad_fn is None, name
        assert torch.equal(got, src.detach()), name


def test_rebuilt_cpu_tensor_never_writes_into_the_arena(tmp_path):
    """A tensor rebuilt from a WRITABLE arena mapping (no pin wrapper)
    owns its memory: writes to it leave the stored object as it was."""
    store = tstore.ObjectStore(str(tmp_path / "store"), 1 << 20)
    try:
        assert store.uses_arena
        oid = tids.ObjectID(np.random.default_rng(5).bytes(24))
        t = _random_tensor(torch.float32, (16, 16))
        ser = tser.serialize({"t": t})
        store.create_buffer(oid, ser.payload_nbytes())
        ser.write_into(store.view_unsealed(oid))
        store.seal_buffer(oid)
        info = store.locate(oid)
        view = tstore.ArenaClient().view(info["path"], info["offset"],
                                         info["size"])
        assert not view.readonly
        before = bytes(view)
        out = tser.deserialize(tser.SerializedObject.from_payload(view))["t"]
        out.fill_(0)
        assert bytes(view) == before
        again = tser.deserialize(tser.SerializedObject.from_payload(view))
        assert torch.equal(again["t"], t)
    finally:
        store.destroy()


def test_a_rebuilt_tensor_does_not_hold_the_arena_pin():
    """From a pinned (read-only) arena view the tensor is copied out, so
    the pin owner is dropped as soon as the value is built."""
    import weakref

    class Owner:
        pass

    t = _random_tensor(torch.bfloat16, (8, 8))
    payload = tser.serialize({"t": t, "n": np.arange(3)}).to_payload()
    owner = Owner()
    alive = weakref.ref(owner)
    obj = tser.SerializedObject.from_payload(payload, pin_owner=owner)
    del owner
    out = tser.deserialize(obj)
    del obj
    assert torch.equal(out["t"], t)
    # numpy arrays still view the pinned bytes (zero-copy, as in the JAX
    # package); drop them and nothing holds the pin.
    assert alive() is not None
    del out["n"]
    assert alive() is None


class _Forged:
    """Pickles as a tensor whose dtype tag names no dtype."""

    def __reduce__(self):
        raw = np.zeros(4, dtype=np.uint8)
        return (tser._rebuild_tensor,
                (pickle.PickleBuffer(raw), "Tensor", (4,), "cpu"))


def test_only_dense_tensors_and_real_dtypes_cross():
    with pytest.raises(TypeError, match="strided"):
        tser.serialize(torch.eye(3).to_sparse())
    with pytest.raises(TypeError, match="not a torch dtype"):
        _via_payload(_Forged())


def test_port_modules_are_never_pickled_by_value():
    from ant_ray_tpu_torch.actor import ActorHandle

    for obj in (ActorHandle, tser.SerializedObject, tref.ObjectRef):
        tser._register_driver_module_by_value(obj)
    assert not any(m.startswith("ant_ray_tpu_torch")
                   for m in tser._by_value_modules)
    blob = tser.dumps_code(ActorHandle)
    assert b"ant_ray_tpu_torch.actor" in blob and len(blob) < 200
    assert tser.loads_code(blob) is ActorHandle


# ------------------------------------------------ object store / arena


def _native(pkg):
    native = pkg.load_native()
    assert native is not None, f"{pkg.name}: the C++ extension must build"
    return native


def test_both_native_modules_load_side_by_side():
    jn, tn = _native(JAX), _native(PORT)
    assert (jn.__name__, tn.__name__) == ("art_native", "art_torch_native")
    assert jn.Arena is not tn.Arena
    assert tn.Arena.__module__ == "art_torch_native"
    assert tnative_mod.library_path().startswith(tnative_mod.BUILD_DIR)


def test_arena_alloc_free_sequence_gives_equal_offsets(tmp_path):
    rng = np.random.default_rng(6)
    sizes = [int(s) for s in rng.integers(1, 5000, 40)]
    frees = [int(i) for i in rng.permutation(40)[:25]]

    def sequence(pkg):
        arena = _native(pkg).Arena(str(tmp_path / f"{pkg.name}.buf"),
                                   capacity=1 << 18, create=True)
        try:
            offsets = [arena.alloc(s) for s in sizes[:30]]
            for i in frees:
                if i < 30:
                    arena.free(offsets[i])
            offsets += [arena.alloc(s) for s in sizes[30:]]
            state = (arena.used, arena.num_blocks, arena.capacity,
                     arena.heap_start)
            for i, off in enumerate(offsets):
                if i >= 30 or i not in frees:
                    arena.free(off)
            assert arena.used == 0
            big = arena.alloc((1 << 18) - 256)   # fully coalesced
            with pytest.raises(MemoryError):
                arena.alloc(1 << 18)
            return offsets, state, big
        finally:
            arena.close()

    _equal_across_packages(sequence)


def test_arena_cross_mapping_in_both(tmp_path):
    def cross(pkg):
        native = _native(pkg)
        path = str(tmp_path / f"{pkg.name}.buf")
        a = native.Arena(path, capacity=1 << 16, create=True)
        off = a.alloc(64)
        a.view(off, 64)[:5] = b"12345"
        b = native.Arena(path)
        out = (off, bytes(b.view(off, 5)))
        a.close()
        b.close()
        return out

    assert _equal_across_packages(cross)[1] == b"12345"


def _payloads(n, size, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(size) for _ in range(n)]


def _oids(pkg, n, seed):
    rng = np.random.default_rng(seed)
    return [pkg.ids.ObjectID(rng.bytes(24)) for _ in range(n)]


def _stats(store):
    return [{k: v for k, v in s.items() if k != "created_age_s"}
            for s in store.object_stats()]


def _store(pkg, tmp_path, spill=False):
    root = tmp_path / pkg.name
    return pkg.store.ObjectStore(
        str(root / "store"), capacity_bytes=1 << 20,
        spill_dir=str(root / "spill") if spill else None)


def test_store_create_locate_and_seal_protocol_agree(tmp_path):
    payload = _payloads(1, 4096, 7)[0]

    def scenario(pkg):
        store = _store(pkg, tmp_path)
        try:
            assert store.uses_arena
            a, b = _oids(pkg, 2, 8)
            store.create(a, payload)
            info = store.locate(a)
            got = bytes(pkg.store.ArenaClient().view(
                info["path"], info["offset"], info["size"]))
            assert got == payload
            offset = store.create_buffer(b, 128)
            assert store.locate(b) is None      # unsealed: invisible
            store.view_unsealed(b)[:3] = b"abc"
            store.seal_buffer(b)
            info_b = store.locate(b)
            assert info_b["offset"] == store.arena_file_offset(offset)
            return (info["offset"], info["size"], offset, info_b["offset"],
                    store.used, _stats(store))
        finally:
            store.destroy()

    _equal_across_packages(scenario)


def test_store_eviction_order_and_pins_agree(tmp_path):
    payloads = _payloads(6, 256 * 1024, 9)
    extra = _payloads(6, 200 * 1024, 10)

    def scenario(pkg):
        store = _store(pkg, tmp_path)
        try:
            oids = _oids(pkg, 6, 11)
            resident = []
            for oid, p in zip(oids, payloads):
                store.create(oid, p)
                resident.append([o.hex() for o in store.list_objects()])
            assert not store.contains(oids[0]) and store.contains(oids[-1])
            assert store.used <= store.capacity
            pinned = oids[-1]
            store.pin(pinned, token=1)
            for oid, p in zip(_oids(pkg, 6, 12), extra):
                store.create(oid, p)
            assert store.contains(pinned)
            after_pin = ([o.hex() for o in store.list_objects()],
                         store.used, _stats(store))
            store.unpin(pinned, token=1)
            return resident, after_pin
        finally:
            store.destroy()

    _equal_across_packages(scenario)


def test_store_full_when_all_pinned_agrees(tmp_path):
    payloads = _payloads(2, 900 * 1024, 13)

    def scenario(pkg):
        store = _store(pkg, tmp_path)
        try:
            a, b = _oids(pkg, 2, 14)
            store.create(a, payloads[0])
            store.pin(a, token=1)
            with pytest.raises(pkg.store.ObjectStoreFullError) as e:
                store.create(b, payloads[1])
            store.unpin(a, token=1)
            return str(e.value), store.used
        finally:
            store.destroy()

    _equal_across_packages(scenario)


def test_read_chunk_agrees(tmp_path):
    payload = bytes(range(256)) * 64

    def scenario(pkg):
        store = _store(pkg, tmp_path)
        try:
            (oid,) = _oids(pkg, 1, 15)
            store.create(oid, payload)
            out = [store.read_chunk(oid, o, n)
                   for o, n in ((0, 100), (1000, 100), (len(payload), 10))]
            assert out == [payload[:100], payload[1000:1100], b""]
            return out
        finally:
            store.destroy()

    _equal_across_packages(scenario)


def test_unsealed_grants_and_abort_agree(tmp_path):
    fill = _payloads(8, 100 * 1024, 16)

    def scenario(pkg):
        store = _store(pkg, tmp_path)
        try:
            grant, dup = _oids(pkg, 2, 17)
            store.create_buffer(grant, 256 * 1024)
            for oid, p in zip(_oids(pkg, 8, 18), fill):
                store.create(oid, p)
            assert store.contains(grant)
            stats = _stats(store)
            store.abort_buffer(grant)
            assert not store.contains(grant)
            store.create_buffer(dup, 64)
            with pytest.raises(pkg.store.BufferExistsError) as e:
                store.create_buffer(dup, 64)
            assert e.value.sealed is False
            store.abort_buffer(dup)
            retry = store.create_buffer(dup, 64)
            store.seal_buffer(dup)
            return stats, str(e.value), retry, store.used
        finally:
            store.destroy()

    _equal_across_packages(scenario)


def test_spill_and_restore_sequence_agrees(tmp_path):
    payloads = _payloads(6, 256 * 1024, 19)
    big = _payloads(2, 900 * 1024, 20)

    def scenario(pkg):
        store = _store(pkg, tmp_path, spill=True)
        try:
            oids = _oids(pkg, 6, 21)
            for oid, p in zip(oids, payloads):
                store.create(oid, p)
            assert store.contains(oids[0])       # spilled, still ours
            spilled = (store.spilled_bytes, _stats(store))
            info = store.locate(oids[0])         # restore from disk
            restored = bytes(pkg.store.ArenaClient().view(
                info["path"], info["offset"], info["size"]))
            assert restored == payloads[0]
            after_restore = (store.spilled_bytes, store.used, _stats(store))
            a, b = _oids(pkg, 2, 22)
            store.create(a, big[0])
            store.create(b, big[1])
            store.pin(b, token=7)
            blocked = store.locate(a)            # restore blocked by the pin
            assert blocked is None and store.contains(a)
            store.unpin(b, token=7)
            info = store.locate(a)
            assert info is not None
            return spilled, after_restore, store.spilled_bytes, _stats(store)
        finally:
            store.destroy()

    _equal_across_packages(scenario)


def test_spilled_restore_falls_back_to_a_file_in_both(tmp_path, monkeypatch):
    payloads = _payloads(6, 256 * 1024, 23)

    def scenario(pkg):
        store = _store(pkg, tmp_path, spill=True)
        try:
            oids = _oids(pkg, 6, 24)
            for oid, p in zip(oids, payloads):
                store.create(oid, p)

            def fragmented(size):
                raise pkg.store.ObjectStoreFullError(
                    "arena fragmented and nothing evictable")

            monkeypatch.setattr(store, "_arena_alloc", fragmented)
            info = store.locate(oids[0])
            assert info is not None and info["offset"] is None
            assert bytes(pkg.store.open_object(info["path"])) == payloads[0]
            return os.path.basename(info["path"]), _stats(store)
        finally:
            monkeypatch.undo()
            store.destroy()

    _equal_across_packages(scenario)


@pytest.mark.parametrize("shm_free_gib", [1, 4096])
def test_default_store_capacity_agrees(monkeypatch, shm_free_gib):
    """30 % of memory, capped at 80 % of the tmpfs: both packages read
    the same (fixed) /dev/shm."""
    fake = os.statvfs_result((4096, 4096, 0, 0, shm_free_gib << 18, 0, 0,
                              0, 0, 255))
    monkeypatch.setattr(os, "statvfs", lambda path: fake)
    got = tstore.default_store_capacity()
    assert got == jstore.default_store_capacity()
    if shm_free_gib == 1:
        assert got == int((1 << 30) * 0.8)
