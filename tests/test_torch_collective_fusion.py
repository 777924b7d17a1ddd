"""The port's fused bucketed collectives (``util/collective/fusion.py``)
against the JAX package's: a twin of every test of
tests/test_collective_fusion.py that is not XLA-only, the reference's
assertions kept, with its ``xla_group`` cases run on the port's gloo
group (the NCCL group at world size 1 runs on the card: chip_smoke's
collective phase).  Where the reference holds a numpy bfloat16 leaf
(ml_dtypes) the port holds a torch bfloat16 tensor of the same values.
Also: the port plans the same buckets as the reference for the same
leaf signatures, ``quantize_blockwise`` gives the reference's bytes on
the same float32 input (bitwise), and fused results equal the
reference's on the same seeded inputs (bitwise for float32, and for
bfloat16 leaves reduced at float32 in both)."""

import dataclasses
import itertools
import threading

import numpy as np
import pytest
import torch

from ant_ray_tpu.util import collective as jcol
from ant_ray_tpu.util.collective import fusion as jfusion
from ant_ray_tpu_torch.util import collective as col
from ant_ray_tpu_torch.util.collective import ReduceOp, fusion
from ant_ray_tpu_torch.util.collective.types import AllReduceCoalescedOptions


def _jbf16():
    import ml_dtypes

    return ml_dtypes.bfloat16


def _plan_tuple(plan):
    return dataclasses.astuple(plan)


# ------------------------------------------------------------------ plan

def test_plan_segregates_dtypes_and_respects_budget():
    leaves = [np.ones((100,), np.float32), np.ones((50,), np.int32),
              np.ones((100,), np.float32)]
    plan = fusion.plan_buckets(leaves, bucket_bytes=1 << 20)
    assert plan.n_leaves == 3
    dtypes = sorted(b.dtype for b in plan.buckets)
    assert dtypes == ["float32", "int32"]
    f32 = next(b for b in plan.buckets if b.dtype == "float32")
    assert f32.size == 200 and len(f32.slots) == 2
    # torch leaves of the same shapes and dtypes: the same plan
    tleaves = [torch.ones(100), torch.ones(50, dtype=torch.int32),
               torch.ones(100)]
    assert fusion.plan_buckets(tleaves, bucket_bytes=1 << 20) is plan


def test_plan_splits_at_budget_and_keeps_oversized_leaf_whole():
    leaves = [np.ones((80,), np.float32), np.ones((40,), np.float32),
              np.ones((300,), np.float32)]
    plan = fusion.plan_buckets(leaves, bucket_bytes=400)
    sizes = sorted(b.size for b in plan.buckets)
    assert sizes == [40, 80, 300]
    assert all(len(b.slots) == 1 for b in plan.buckets)


def test_plan_cached_per_signature():
    leaves = [np.ones((7, 3), np.float32)]
    before = fusion.plan_cache_info().hits
    p1 = fusion.plan_buckets(leaves, bucket_bytes=1 << 20)
    p2 = fusion.plan_buckets([torch.zeros(7, 3)], bucket_bytes=1 << 20)
    assert p1 is p2                       # same signature → same plan
    assert fusion.plan_cache_info().hits >= before + 1


@pytest.mark.parametrize("bucket_bytes,transport,reverse", [
    (1 << 20, None, False), (256, None, False), (256, None, True),
    (1 << 20, "bfloat16", False), (300, "int8", True)])
def test_bucket_plans_equal_the_reference(bucket_bytes, transport, reverse):
    """The same leaf signatures give the reference's plan, slot by slot:
    llama-400m's parameter shapes (bf16) beside mixed small leaves."""
    from ant_ray_tpu_torch.models import llama

    shapes = llama.param_shapes(llama.CONFIGS["llama-400m"])
    leaves_sig = []
    for name in sorted(shapes):
        value = shapes[name]
        if isinstance(value, dict):
            leaves_sig += [(tuple(value[k]), "bfloat16")
                           for k in sorted(value)]
        else:
            leaves_sig.append((tuple(value), "bfloat16"))
    leaves_sig += [((3, 5), "float32"), ((17,), "int32"), ((40,), "float32"),
                   ((2, 2, 2), "float64"), ((9,), "float16"), ((),
                                                              "float32")]
    import ml_dtypes  # noqa: F401 — registers numpy's "bfloat16"

    jplan = jfusion._plan_for_signature(tuple(leaves_sig), bucket_bytes,
                                        transport, reverse)
    plan = fusion._plan_for_signature(tuple(leaves_sig), bucket_bytes,
                                      transport, reverse)
    assert _plan_tuple(plan) == _plan_tuple(jplan)


def test_leaf_signature_names_torch_dtypes_as_numpy_does():
    tleaves = [torch.zeros(2, 3), torch.zeros(4, dtype=torch.bfloat16),
               torch.zeros(1, dtype=torch.int64), torch.zeros((),
                                                              dtype=torch.bool)]
    nleaves = [np.zeros((2, 3), np.float32), np.zeros(4, _jbf16()),
               np.zeros(1, np.int64), np.zeros((), np.bool_)]
    assert fusion.leaf_signature(tleaves) == jfusion.leaf_signature(nleaves)
    assert fusion.leaf_signature(nleaves[::2]) == \
        jfusion.leaf_signature(nleaves[::2])


def test_flatten_order_equals_the_reference():
    tree = {"b": [np.ones(2), (np.zeros(1), {"z": np.ones(3), "a": 1.0})],
            "a": {"y": np.ones(4), "x": np.ones(5)}}
    leaves, treedef = fusion.flatten_pytree(tree)
    jleaves, _ = jfusion.flatten_pytree(tree)
    assert [id(x) for x in leaves] == [id(x) for x in jleaves]
    back = fusion.unflatten_pytree(treedef, leaves)
    assert list(back) == ["a", "b"] and back["b"][1][1]["a"] == 1.0
    assert isinstance(back["b"][1], tuple)


def test_pack_unpack_roundtrip_restores_shapes_and_dtypes():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 4)).astype(np.float32),
              rng.integers(0, 100, (5,)).astype(np.int32),
              rng.standard_normal((2, 2, 2)).astype(np.float32)]
    plan = fusion.plan_buckets(leaves, bucket_bytes=1 << 20)
    out = [None] * len(leaves)
    for bucket in plan.buckets:
        flat = fusion.pack_bucket(bucket, leaves)
        fusion.unpack_bucket(bucket, flat, out, leaves)
    for leaf, restored in zip(leaves, out):
        restored = fusion._restore_leaf_type(leaf, restored)
        assert restored.shape == leaf.shape
        assert restored.dtype == leaf.dtype
        np.testing.assert_array_equal(restored, leaf)
    # torch leaves keep their dtype (bfloat16 included) and come back
    # as tensors
    tleaves = [torch.from_numpy(leaves[0]), torch.arange(6, dtype=torch.int32),
               torch.randn(5).to(torch.bfloat16)]
    plan = fusion.plan_buckets(tleaves, bucket_bytes=1 << 20)
    out = [None] * len(tleaves)
    for bucket in plan.buckets:
        fusion.unpack_bucket(bucket, fusion.pack_bucket(bucket, tleaves),
                             out, tleaves)
    for leaf, restored in zip(tleaves, out):
        restored = fusion._restore_leaf_type(leaf, restored)
        assert isinstance(restored, torch.Tensor)
        assert restored.dtype == leaf.dtype and torch.equal(restored, leaf)


def test_transport_cast_applies_only_to_wide_floats():
    leaves = [torch.ones(4), torch.ones(4, dtype=torch.int32),
              torch.ones(4, dtype=torch.bfloat16)]
    plan = fusion.plan_buckets(leaves, bucket_bytes=1 << 20,
                               transport_dtype="bfloat16")
    by_dtype = {b.dtype: b for b in plan.buckets}
    assert by_dtype["float32"].transport_dtype == "bfloat16"
    assert by_dtype["int32"].transport_dtype == "int32"
    assert by_dtype["bfloat16"].transport_dtype == "bfloat16"


# -------------------------------------------------------------- pipeline

def test_pipelined_runner_overlaps_next_prepare_with_collective():
    """Deterministic two-sided rendezvous (the reference's): only a
    pipelined runner can finish, and the two stage windows intersect."""
    prepare_started = [threading.Event() for _ in range(3)]
    collective_started = [threading.Event() for _ in range(3)]

    def prepare(item, k):
        prepare_started[k].set()
        if k == 1:
            assert collective_started[0].wait(timeout=10.0)
        return item

    def collective(staged, k):
        collective_started[k].set()
        if k == 0:
            assert prepare_started[1].wait(timeout=10.0)
        return staged * 2

    ticks = itertools.count()
    runner = fusion.PipelinedRunner(prepare, collective, overlap=True,
                                    clock=lambda: next(ticks))
    assert runner.run([1, 2, 3]) == [2, 4, 6]
    edges = {(edge, k): t for edge, k, t in runner.events}
    assert edges[("prepare_start", 1)] < edges[("collective_end", 0)]
    assert runner.overlap_seconds() > 0


def test_pipelined_runner_sequential_mode_has_no_overlap():
    ticks = itertools.count()
    runner = fusion.PipelinedRunner(lambda x, k: x, lambda x, k: x,
                                    overlap=False,
                                    clock=lambda: next(ticks))
    assert runner.run([1, 2, 3]) == [1, 2, 3]
    assert runner.overlap_seconds() == 0


def test_pipelined_runner_propagates_prepare_error():
    def prepare(item, k):
        if k == 1:
            raise ValueError("boom")
        return item

    runner = fusion.PipelinedRunner(prepare, lambda x, k: x, overlap=True)
    with pytest.raises(ValueError, match="boom"):
        runner.run([1, 2, 3])


# ------------------------------------------------------------- backends

@pytest.fixture
def gloo_group():
    col.init_collective_group(world_size=1, rank=0, backend="gloo",
                              group_name="fg")
    yield "fg"
    col.destroy_collective_group("fg")


def _mixed(torch_bf16: bool):
    rng = np.random.default_rng(7)
    bf16 = rng.standard_normal((16,)).astype(np.float32)
    return [rng.standard_normal((64,)).astype(np.float32),
            rng.standard_normal((8, 8)).astype(np.float32),
            rng.integers(-50, 50, (32,)).astype(np.int32),
            torch.from_numpy(bf16).to(torch.bfloat16) if torch_bf16
            else bf16.astype(_jbf16())]


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX,
                                ReduceOp.AVERAGE])
def test_fused_matches_naive_world1_gloo(gloo_group, op):
    """The reference's ``_world1_gloo`` and ``_world1_xla`` twins, on
    the port's gloo group: fused equals the per-tensor verb, dtype and
    shape kept."""
    tensors = _mixed(torch_bf16=True)
    if op is ReduceOp.AVERAGE:   # floats only, as in the reference
        tensors = tensors[:2]
    fused = col.allreduce_coalesced(tensors, group_name="fg", op=op)
    naive = [col.allreduce(t.clone() if isinstance(t, torch.Tensor)
                           else t, group_name="fg", op=op)
             for t in tensors]
    for f, n, t in zip(fused, naive, tensors):
        assert f.dtype == t.dtype and tuple(f.shape) == tuple(t.shape)
        assert type(f) is type(t)
        np.testing.assert_allclose(
            np.asarray(torch.as_tensor(f).double()),
            np.asarray(torch.as_tensor(n).double()), rtol=1e-5)


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX,
                                ReduceOp.AVERAGE])
def test_fused_equals_the_reference_bitwise(op):
    """The same seeded inputs through the reference's gloo group and
    the port's: equal results (bfloat16 reduced at float32 in both)."""
    tensors = _mixed(torch_bf16=False)
    if op is ReduceOp.AVERAGE:
        tensors = tensors[:2]
    from ant_ray_tpu._private.protocol import find_free_port

    def reference():
        jcol.init_collective_group(1, 0, backend="gloo", group_name="jb",
                                   init_method=f"tcp://127.0.0.1:"
                                               f"{find_free_port()}")
        try:
            return jcol.allreduce_coalesced(tensors, group_name="jb",
                                            op=jcol.ReduceOp[op.name])
        finally:
            jcol.destroy_collective_group("jb")

    try:
        want = reference()
    except Exception as e:  # noqa: BLE001 — the reference's pick-then-bind
        if "EADDRINUSE" not in str(e):      # race (ROADMAP §C): once more
            raise
        want = reference()
    mine = [torch.from_numpy(t.astype(np.float32)).to(torch.bfloat16)
            if t.dtype == _jbf16() else t for t in tensors]
    col.init_collective_group(1, 0, backend="gloo", group_name="tb")
    try:
        got = col.allreduce_coalesced(mine, group_name="tb", op=op)
    finally:
        col.destroy_collective_group("tb")
    for g, w in zip(got, want):
        g = torch.as_tensor(g)
        w = np.asarray(w)
        if w.dtype == _jbf16():
            w = w.astype(np.float32)
            g = g.float()
        np.testing.assert_array_equal(g.numpy(), w)


def test_fused_edge_cases(gloo_group):
    group = gloo_group
    assert col.allreduce_coalesced([], group_name=group) == []
    one = col.allreduce_coalesced([np.full((5,), 3.0, np.float32)],
                                  group_name=group)
    np.testing.assert_allclose(np.asarray(one[0]), 3.0)
    big = np.arange(1024, dtype=np.float32)
    out = col.allreduce_coalesced([big, np.ones((4,), np.float32)],
                                  group_name=group, bucket_bytes=256)
    np.testing.assert_allclose(np.asarray(out[0]), big)
    np.testing.assert_allclose(np.asarray(out[1]), 1.0)
    out = col.allreduce_coalesced(
        [np.array([1, -2, 3], np.int32), np.ones((2,), np.float32)],
        group_name=group)
    np.testing.assert_array_equal(np.asarray(out[0]),
                                  np.array([1, -2, 3], np.int32))


def test_transport_bf16_parity(gloo_group):
    rng = np.random.default_rng(3)
    tensors = [rng.standard_normal((128,)).astype(np.float32)
               for _ in range(4)]
    out = col.allreduce_coalesced(tensors, group_name="fg",
                                  transport_dtype="bfloat16")
    for f, t in zip(out, tensors):
        assert np.asarray(f).dtype == np.float32
        np.testing.assert_allclose(np.asarray(f), t, rtol=1e-2, atol=1e-2)
    # the lossy cast is the reference's (round to nearest even)
    want = [np.asarray(t.astype(_jbf16()).astype(np.float32))
            for t in tensors]
    for f, w in zip(out, want):
        np.testing.assert_array_equal(np.asarray(f), w)


def test_fusion_stats_surface(gloo_group):
    tensors = [np.ones((32,), np.float32) for _ in range(6)]
    col.allreduce_coalesced(tensors, group_name="fg")
    col.allreduce_coalesced(tensors, group_name="fg")
    stats = col.fusion_stats("fg")
    assert stats["calls"] == 2
    assert stats["tensors"] == 12
    assert stats["buckets"] == 2
    assert stats["plan_cache_hits"] >= 1
    for key in ("pack_s", "transfer_s", "collective_s", "unpack_s",
                "overlap_fraction"):
        assert key in stats
    assert stats["last"]["plan_cache_hit"] is True


def test_sync_pytree_preserves_structure(gloo_group):
    tree = {"layer1": {"w": np.ones((4, 4), np.float32),
                       "b": np.zeros((4,), np.float32)},
            "scale": np.array([2.0], np.float32)}
    out = col.sync_pytree(tree, group_name="fg", op=ReduceOp.SUM)
    assert set(out) == {"layer1", "scale"}
    assert set(out["layer1"]) == {"w", "b"}
    np.testing.assert_allclose(np.asarray(out["layer1"]["w"]), 1.0)
    np.testing.assert_allclose(np.asarray(out["scale"]), 2.0)


def test_base_group_naive_fallback():
    from ant_ray_tpu_torch.util.collective.collective_group.base import (
        BaseGroup,
    )

    class Loopback(BaseGroup):
        def allreduce(self, tensors, opts):
            return [np.asarray(tensors[0]) * 2]

    group = Loopback(1, 0, "loop")
    out = group.allreduce_coalesced(
        [np.ones((3,), np.float32), np.ones((2,), np.float32)],
        AllReduceCoalescedOptions())
    np.testing.assert_allclose(out[0], 2.0)
    assert group.fusion_stats()["calls"] == 0


# ------------------------------------------------- int8 wire quantization

def test_quantize_blockwise_roundtrip_odd_tail_and_zero_block():
    from ant_ray_tpu_torch.util.collective.fusion import QUANT_BLOCK

    rng = np.random.default_rng(11)
    size = QUANT_BLOCK * 2 + 37
    flat = (rng.standard_normal((size,)) * 5).astype(np.float32)
    flat[:QUANT_BLOCK] = 0.0
    q, scales = fusion.quantize_blockwise(flat)
    assert q.dtype == torch.int8 and q.numel() == size
    assert scales.dtype == torch.float32
    assert tuple(scales.shape) == (fusion.quant_blocks(size),) == (3,)
    assert scales[0] == 1.0
    assert not q[:QUANT_BLOCK].any()
    back = fusion.dequantize_blockwise(q, scales)
    assert tuple(back.shape) == (size,) and back.dtype == torch.float32
    bound = np.repeat(scales.numpy(), QUANT_BLOCK)[:size] * 0.5 + 1e-6
    assert np.all(np.abs(back.numpy() - flat) <= bound)


@pytest.mark.parametrize("size,scale", [(256 * 2 + 37, 5.0), (1, 1.0),
                                        (4096, 1e-3), (1000, 300.0)])
def test_quantize_blockwise_bytes_equal_the_reference(size, scale):
    rng = np.random.default_rng(size)
    flat = (rng.standard_normal((size,)) * scale).astype(np.float32)
    flat[: min(size, 256) // 2] = 0.0
    jq, js = jfusion.quantize_blockwise(flat)
    q, s = fusion.quantize_blockwise(flat)
    assert q.numpy().tobytes() == jq.tobytes()
    assert s.numpy().tobytes() == js.tobytes()
    assert fusion.dequantize_blockwise(q, s).numpy().tobytes() == \
        jfusion.dequantize_blockwise(jq, js).tobytes()


def test_int8_payload_wire_bytes_under_ratio():
    flat = np.ones((4096,), np.float32)
    payload = fusion.quantize_blockwise(flat)
    assert fusion.payload_nbytes(payload) / flat.nbytes <= 0.35
    assert fusion.payload_nbytes(payload) == \
        jfusion.payload_nbytes(jfusion.quantize_blockwise(flat))


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVERAGE])
def test_int8_transport_parity(gloo_group, op):
    rng = np.random.default_rng(5)
    tensors = [(rng.standard_normal((300,)) * (i + 1)).astype(np.float32)
               for i in range(3)]
    out = col.allreduce_coalesced(tensors, group_name="fg", op=op,
                                  transport_dtype="int8")
    atol = max(float(np.abs(t).max()) for t in tensors) / 127 + 1e-6
    for f, t in zip(out, tensors):
        assert np.asarray(f).dtype == np.float32
        np.testing.assert_allclose(np.asarray(f), t, rtol=0, atol=atol)
    last = col.fusion_stats("fg")["last"]
    assert last["transport_dtype"] == "int8"
    assert last["wire_bytes"] <= 0.35 * last["bytes"]


def test_int8_transport_falls_back_for_min_max(gloo_group):
    t = [np.array([3.0, -7.0, 2.0], np.float32)]
    out = col.allreduce_coalesced(t, group_name="fg", op=ReduceOp.MIN,
                                  transport_dtype="int8")
    np.testing.assert_array_equal(np.asarray(out[0]), t[0])
    assert col.fusion_stats("fg")["last"]["transport_dtype"] != "int8"


def test_int8_transport_leaves_ints_exact(gloo_group):
    from ant_ray_tpu_torch.util.collective.fusion import QUANT_BLOCK

    ints = np.array([7, -9, 1 << 20], np.int32)
    out = col.allreduce_coalesced(
        [ints, np.full((QUANT_BLOCK + 5,), 2.5, np.float32)],
        group_name="fg", op=ReduceOp.SUM, transport_dtype="int8")
    np.testing.assert_array_equal(np.asarray(out[0]), ints)
    np.testing.assert_allclose(np.asarray(out[1]), 2.5, atol=2.5 / 127)
    assert col.allreduce_coalesced([], group_name="fg",
                                   transport_dtype="int8") == []


# --------------------------------------------------- gradient-ready overlap

def test_gradient_syncer_matches_one_shot(gloo_group):
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((64,)).astype(np.float32),
            "b": {"c": rng.standard_normal((8, 8)).astype(np.float32),
                  "d": rng.standard_normal((257,)).astype(np.float32)}}
    leaves, _ = fusion.flatten_pytree(tree)
    syncer = col.gradient_syncer(group_name=gloo_group, op=ReduceOp.AVERAGE,
                                 bucket_bytes=512)
    syncer.begin(tree)
    for i in reversed(range(len(leaves))):
        syncer.ready(i, leaves[i])
    out = syncer.wait()
    out2 = syncer.sync(tree)
    for got in (out, out2):
        flat, _ = fusion.flatten_pytree(got)
        for g, want in zip(flat, leaves):
            assert np.asarray(g).dtype == np.float32
            np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5)


def test_gradient_syncer_on_post_accumulate_grad_hooks(gloo_group):
    """The torch way to mark a leaf ready: each parameter's
    ``register_post_accumulate_grad_hook`` calls ``ready(i, p.grad)``
    as backward finishes its gradient; the result equals the one-shot
    sync of the same gradients, and the hooks fire in backward order."""
    torch.manual_seed(0)
    params = {"w1": torch.randn(8, 16, requires_grad=True),
              "w2": torch.randn(16, 4, requires_grad=True),
              "b": torch.randn(4, requires_grad=True)}
    leaves, _ = fusion.flatten_pytree(params)
    syncer = col.gradient_syncer(group_name=gloo_group, bucket_bytes=256)
    order = []

    def hook(p, i):
        order.append(i)
        syncer.ready(i, p.grad)

    handles = [p.register_post_accumulate_grad_hook(
        lambda p, i=i: hook(p, i)) for i, p in enumerate(leaves)]
    syncer.begin(params)
    x = torch.randn(3, 8)
    ((x @ params["w1"]) @ params["w2"] + params["b"]).square().sum().backward()
    hooked = syncer.wait()
    for h in handles:
        h.remove()
    assert sorted(order) == [0, 1, 2]
    one_shot = col.sync_pytree({k: v.grad for k, v in params.items()},
                               group_name=gloo_group)
    for k in params:
        assert torch.equal(hooked[k], one_shot[k])
        assert torch.equal(hooked[k], params[k].grad)


def test_gradient_syncer_out_of_order_ready(gloo_group):
    leaves = [np.full((70,), float(i), np.float32) for i in range(4)]
    syncer = col.gradient_syncer(group_name="fg", op=ReduceOp.SUM,
                                 bucket_bytes=280)
    syncer.begin(leaves)
    for i in range(len(leaves)):
        syncer.ready(i)
    out = syncer.wait()
    for i, g in enumerate(out):
        np.testing.assert_allclose(np.asarray(g), float(i))


def test_gradient_syncer_single_leaf_and_in_flight_guard(gloo_group):
    syncer = col.gradient_syncer(group_name="fg", op=ReduceOp.SUM)
    out = syncer.sync([np.ones((3,), np.float32)])
    np.testing.assert_allclose(np.asarray(out[0]), 1.0)
    with pytest.raises(RuntimeError, match="no gradient sync"):
        syncer.ready(0)
    with pytest.raises(RuntimeError, match="no gradient sync"):
        syncer.wait()
    syncer.begin([np.ones((3,), np.float32)])
    with pytest.raises(RuntimeError, match="already in flight"):
        syncer.begin([np.ones((3,), np.float32)])
    with pytest.raises(IndexError):
        syncer.ready(7)
    syncer.ready(0)
    syncer.wait()


def test_gradient_syncer_overlap_accounting_logical_clock(gloo_group):
    from ant_ray_tpu_torch.util.collective.collective import _group_mgr

    group = _group_mgr.get_group("fg")
    ticks = itertools.count()
    syncer = col.gradient_syncer(group_name="fg", op=ReduceOp.SUM,
                                 clock=lambda: next(ticks))
    reduced = threading.Event()
    orig = group.bucket_reduce

    def traced(staged, bucket, opts):
        out = orig(staged, bucket, opts)
        reduced.set()
        return out

    group.bucket_reduce = traced
    try:
        syncer.begin([np.ones((500,), np.float32)])
        syncer.ready(0)
        assert reduced.wait(timeout=10), "bucket collective never ran"
        out = syncer.wait()
    finally:
        group.bucket_reduce = orig
    np.testing.assert_allclose(np.asarray(out[0]), 1.0)
    last = group.fusion_stats()["last"]
    assert last["collective_s_clock"] > 0
    assert last["overlap_s"] == last["collective_s_clock"]


# -------------------------------------------------- hierarchical allreduce

def test_slice_topology_accessors_and_validation():
    topo = col.SliceTopology.regular(8, 2)
    assert topo.num_slices == 2
    assert topo.slices == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert topo.slice_of(5) == 1
    assert topo.peers(5) == (4, 5, 6, 7)
    assert topo.leader(1) == 4
    assert topo.leaders() == (0, 4)
    topo.validate(8)
    with pytest.raises(ValueError):
        topo.validate(6)
    with pytest.raises(ValueError):
        col.SliceTopology.regular(8, 3)
    assert hash(topo) == hash(col.SliceTopology.regular(8, 2))
    assert topo == col.SliceTopology(jcol.SliceTopology.regular(8, 2).slices)


def test_per_level_bucket_plans_differ_as_configured():
    topo = col.SliceTopology.regular(4, 2).with_bucket_bytes(
        ici=400, dcn=4 << 20)
    assert topo.per_level_bucket_bytes(1 << 20) == (400, 4 << 20)
    half = col.SliceTopology.regular(4, 2).with_bucket_bytes(ici=400)
    assert half.per_level_bucket_bytes(1 << 20) == (400, 1 << 20)

    leaves = [np.ones((80,), np.float32) for _ in range(6)]
    levels = fusion.plan_buckets_per_level(leaves, topo,
                                           bucket_bytes=1 << 20)
    assert len(levels["ici"].buckets) == 6
    assert len(levels["dcn"].buckets) == 1
    assert levels["ici"].total_bytes == levels["dcn"].total_bytes
    assert hash(topo) != hash(col.SliceTopology.regular(4, 2))


def test_per_level_buckets_drive_wire_plan_world1(gloo_group):
    topo = col.SliceTopology.regular(1, 1).with_bucket_bytes(
        ici=400, dcn=4 << 20)
    tensors = [np.arange(80, dtype=np.float32) + k for k in range(6)]
    out = col.allreduce_coalesced(tensors, group_name=gloo_group,
                                  hierarchy=topo)
    for got, want in zip(out, tensors):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)
    last = col.fusion_stats(gloo_group)["last"]
    assert last["buckets"] == 6
    assert last["level_buckets"] == {"ici": 6, "dcn": 1}


def test_slice_topology_from_labels():
    labels = ["pod-a", "pod-b", "pod-a", "pod-b"]
    topo = col.SliceTopology.from_labels(labels)
    assert topo.num_slices == 2
    assert sorted(topo.slices) == [(0, 2), (1, 3)]
    assert topo.slices == jcol.SliceTopology.from_labels(labels).slices
    mixed = ["n1", "", None, "n1"]
    assert col.SliceTopology.from_labels(mixed).slices == \
        jcol.SliceTopology.from_labels(mixed).slices


def test_hierarchy_world1_identity(gloo_group):
    topo = col.SliceTopology.regular(1, 1)
    t = [np.arange(600, dtype=np.float32)]
    out = col.allreduce_coalesced(t, group_name=gloo_group, hierarchy=topo)
    np.testing.assert_allclose(np.asarray(out[0]), t[0], rtol=1e-6)


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


# ------------------------------------------ across actors, both packages

@pytest.fixture(scope="module")
def clusters():
    import ant_ray_tpu as jart
    import ant_ray_tpu_torch as tart

    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield jart, tart
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _hierarchical(art, c):
    topo = c.SliceTopology.regular(4, 2)

    @art.remote
    class Ranker(c.CollectiveActorMixin):
        def sync(self, rank):
            tensors = [np.full((300,), float(rank + 1), np.float32)]
            hier_sum = c.allreduce_coalesced(
                tensors, group_name="hier_g", op=c.ReduceOp.SUM,
                hierarchy=topo)
            dcn = c.fusion_stats("hier_g")["dcn_participants"]
            hier_avg = c.allreduce_coalesced(
                tensors, group_name="hier_g", op=c.ReduceOp.AVERAGE,
                hierarchy=topo)
            flat_sum = c.allreduce_coalesced(
                tensors, group_name="hier_g", op=c.ReduceOp.SUM)
            q8 = c.allreduce_coalesced(
                [np.linspace(-1, 1, 700, dtype=np.float32) * (rank + 1)],
                group_name="hier_g", op=c.ReduceOp.SUM, hierarchy=topo,
                transport_dtype="int8")
            return (float(np.asarray(hier_sum[0])[0]),
                    float(np.asarray(hier_avg[0])[0]),
                    float(np.asarray(flat_sum[0])[0]), dcn,
                    np.asarray(q8[0]).tolist())

    actors = [Ranker.remote() for _ in range(4)]
    try:
        c.create_collective_group(actors, world_size=4, ranks=[0, 1, 2, 3],
                                  backend="gloo", group_name="hier_g")
        return art.get([a.sync.remote(rank)
                        for rank, a in enumerate(actors)])
    finally:
        for a in actors:
            art.kill(a)


def test_gloo_hierarchical_across_actors(clusters):
    """4 ranks in 2 slices in each package: the two-level allreduce
    equals the flat verb for SUM and the divide-once AVERAGE, with one
    DCN participant per slice, and the re-quantized int8 hop gives the
    reference's values bitwise."""
    jart, tart = clusters
    want = _retry_reference_race(lambda: _hierarchical(jart, jcol))
    got = _hierarchical(tart, col)
    for hier_sum, hier_avg, flat_sum, dcn, _q8 in got:
        assert hier_sum == flat_sum == 10.0
        assert hier_avg == 2.5
        assert dcn == 2
    assert got == want


def _fused(art, c):
    @art.remote
    class Ranker(c.CollectiveActorMixin):
        def sync(self, rank):
            tensors = [np.full((16,), float(rank + 1), np.float32),
                       np.arange(8, dtype=np.int32) * (rank + 1)]
            fused = c.allreduce_coalesced(tensors, group_name="fusion_g")
            naive = [c.allreduce(t, group_name="fusion_g") for t in tensors]
            return ([np.asarray(f).tolist() for f in fused],
                    [np.asarray(n).tolist() for n in naive])

    actors = [Ranker.remote() for _ in range(2)]
    try:
        c.create_collective_group(actors, world_size=2, ranks=[0, 1],
                                  backend="gloo", group_name="fusion_g")
        return art.get([a.sync.remote(rank)
                        for rank, a in enumerate(actors)])
    finally:
        for a in actors:
            art.kill(a)


def test_gloo_fused_across_actors(clusters):
    jart, tart = clusters
    want = _retry_reference_race(lambda: _fused(jart, jcol))
    got = _fused(tart, col)
    for fused, naive in got:
        assert fused == naive
        np.testing.assert_allclose(fused[0], 3.0)
        np.testing.assert_array_equal(fused[1], (np.arange(8) * 3).tolist())
    assert got == want
