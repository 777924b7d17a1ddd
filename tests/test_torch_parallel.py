"""The port's parallel layer (ant_ray_tpu_torch/parallel) against the JAX
package's: every test of tests/test_parallel.py on meshes, sharding rules,
ring attention, Ulysses and GPipe, the port on a virtual mesh of 8 CPU
cells and the JAX package on its virtual mesh of 8 CPU devices, from the
same numpy inputs.

Tolerance: outputs to atol = rtol = 2e-5 of the JAX function's (fp32;
the reference's own bound against its oracle), GPipe to 1e-5 as there.
Both sides sum in another order; a wrong block, mask or rotation gives
errors of order 1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_ray_tpu import parallel as jp
from ant_ray_tpu.parallel.pipeline import gpipe as jgpipe
from ant_ray_tpu.parallel.ring import reference_attention as jref
from ant_ray_tpu_torch import parallel as tp
from ant_ray_tpu_torch.parallel.pipeline import gpipe as tgpipe
from ant_ray_tpu_torch.parallel.ring import reference_attention as tref

TOL = 2e-5
CELLS = ["cpu"] * 8


def _meshes(*args, **kwargs):
    return (jp.build_mesh(*args, **kwargs),
            tp.build_mesh(*args, devices=CELLS, **kwargs))


def _close(got, want, tol=TOL):
    got = got.full() if isinstance(got, tp.ShardedTensor) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_build_mesh_explicit():
    for mesh in _meshes(dp=2, tp=4):
        assert mesh.shape["dp"] == 2
        assert mesh.shape["tp"] == 4
        assert mesh.shape["pp"] == 1
        assert mesh.axis_names == tp.AxisNames.ORDER == jp.AxisNames.ORDER
    port = _meshes(dp=2, tp=4)[1]
    assert port.size == 8 and port.is_virtual
    assert port.device_set == {torch.device("cpu")}


def test_build_mesh_wildcard():
    for mesh in _meshes(tp.MeshConfig(tp=2, fsdp=-1)):
        assert mesh.shape["fsdp"] == 4
        assert mesh.shape["tp"] == 2


def test_build_mesh_errors():
    for build in (jp.build_mesh, lambda *a, **k: tp.build_mesh(
            *a, devices=CELLS, **k)):
        with pytest.raises(ValueError, match="needs"):
            build(dp=3)
        with pytest.raises(ValueError, match="at most one"):
            build(tp.MeshConfig(dp=-1, tp=-1))


def test_build_mesh_without_devices_takes_the_cards_only():
    """No device list: the visible cards, never a repeated one, so with
    fewer cards than the axes need it raises as the reference's does."""
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {cards + 1} devices, have "
                       f"{cards}"):
        tp.build_mesh(tp=cards + 1)


def test_logical_to_spec():
    spec = tp.logical_to_spec(("batch", "seq", "embed"))
    assert spec == jp.logical_to_spec(("batch", "seq", "embed"))
    assert spec == tp.PartitionSpec(("dp", "fsdp"), "sp", None)
    assert tp.DEFAULT_LLAMA_RULES == jp.DEFAULT_LLAMA_RULES
    with pytest.raises(KeyError):
        tp.logical_to_spec(("unknown_dim",))


def test_shard_pytree():
    jmesh, tmesh = _meshes(fsdp=2, tp=4)
    params = {"w": np.arange(128, dtype=np.float32).reshape(8, 16),
              "b": np.arange(16, dtype=np.float32)}
    logical = {"w": ("embed_param", "mlp"), "b": ("mlp",)}
    want = jp.shard_pytree(params, logical, jmesh)
    got = tp.shard_pytree(params, logical, tmesh)
    assert got["w"].shards[0].shape == \
        want["w"].addressable_shards[0].data.shape == (4, 4)
    assert got["b"].shards[0].shape == \
        want["b"].addressable_shards[0].data.shape == (4,)
    # Every cell holds the block its JAX device holds, and the pieces
    # assemble to the input bit for bit.
    for name in params:
        by_device = {s.device: np.asarray(s.data)
                     for s in want[name].addressable_shards}
        for cell, device in enumerate(jmesh.devices.reshape(-1)):
            np.testing.assert_array_equal(got[name].shards[cell].numpy(),
                                          by_device[device])
        assert torch.equal(got[name].full(), torch.from_numpy(params[name]))
    assert got["w"].sharding == tp.NamedSharding(
        tmesh, tp.PartitionSpec("fsdp", "tp"))
    assert tp.constrain(got["w"], ("embed_param", "mlp")) is got["w"]
    with pytest.raises(ValueError, match="constraint"):
        tp.constrain(got["w"], ("mlp", "embed_param"))


def _qkv(batch=2, seq=64, heads=4, kv_heads=None, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    kv_heads = kv_heads or heads
    return (rng.randn(batch, seq, heads, dim).astype(np.float32),
            rng.randn(batch, seq, kv_heads, dim).astype(np.float32),
            rng.randn(batch, seq, kv_heads, dim).astype(np.float32))


def _both(fn_j, fn_t, meshes, qkv, **kwargs):
    jmesh, tmesh = meshes
    want = fn_j(*(jnp.asarray(x) for x in qkv), mesh=jmesh, **kwargs)
    got = fn_t(*(torch.from_numpy(x) for x in qkv), mesh=tmesh, **kwargs)
    return got, want


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference(causal):
    qkv = _qkv()
    got, want = _both(jp.ring_attention, tp.ring_attention, _meshes(sp=8),
                      qkv, causal=causal)
    _close(got, want)
    _close(got, jref(*(jnp.asarray(x) for x in qkv), causal=causal))
    _close(tref(*(torch.from_numpy(x) for x in qkv), causal=causal),
           jref(*(jnp.asarray(x) for x in qkv), causal=causal))


def test_ring_attention_gqa():
    got, want = _both(jp.ring_attention, tp.ring_attention,
                      _meshes(sp=4, tp=2), _qkv(heads=8, kv_heads=2),
                      causal=True)
    _close(got, want)


def test_ring_attention_with_dp_and_tp():
    got, want = _both(jp.ring_attention, tp.ring_attention,
                      _meshes(dp=2, sp=2, tp=2),
                      _qkv(batch=4, seq=32, heads=4), causal=True)
    assert got.spec == tp.PartitionSpec(("dp", "fsdp"), "sp", "tp", None)
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_reference(causal):
    got, want = _both(jp.ulysses_attention, tp.ulysses_attention,
                      _meshes(tp.MeshConfig(sp=4, dp=-1)),
                      _qkv(heads=8, seq=32), causal=causal)
    _close(got, want)


def test_ulysses_rejects_indivisible_heads():
    jmesh, tmesh = _meshes(sp=8)
    q, k, v = _qkv(heads=4, seq=32)  # 4 heads < 8-way sp
    with pytest.raises(Exception, match="divisible"):
        jp.ulysses_attention(*(jnp.asarray(x) for x in (q, k, v)),
                             mesh=jmesh)
    with pytest.raises(ValueError, match="divisible"):
        tp.ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             mesh=tmesh)


def test_gpipe_matches_sequential():
    n_stages, num_micro, batch, dim = 4, 6, 4, 8
    jmesh, tmesh = _meshes(pp=n_stages, dp=2)
    rng = np.random.RandomState(0)
    weights = rng.randn(n_stages, dim, dim).astype(np.float32) * 0.3
    xs = rng.randn(num_micro, batch, dim).astype(np.float32)
    want = jgpipe(lambda p, x: jnp.tanh(x @ p["w"]),
                  {"w": jnp.asarray(weights)}, jnp.asarray(xs), mesh=jmesh)
    got = tgpipe(lambda p, x: torch.tanh(x @ p["w"]),
                 {"w": torch.from_numpy(weights)}, torch.from_numpy(xs),
                 mesh=tmesh)
    _close(got, want, tol=1e-5)
    expected = torch.from_numpy(xs)
    for s in range(n_stages):
        expected = torch.tanh(expected @ torch.from_numpy(weights[s]))
    _close(got, expected.numpy(), tol=1e-5)


def test_gpipe_single_stage_degenerate():
    jmesh, tmesh = _meshes(pp=1, dp=8)
    want = jgpipe(lambda p, x: x @ p["w"], {"w": jnp.ones((1, 4, 4))},
                  jnp.ones((3, 8, 4)), mesh=jmesh)
    got = tgpipe(lambda p, x: x @ p["w"], {"w": torch.ones(1, 4, 4)},
                 torch.ones(3, 8, 4), mesh=tmesh)
    _close(got, want)
    np.testing.assert_allclose(got.full().numpy(), 4.0)


def test_collectives_on_a_mesh_are_list_operations():
    """psum, all_gather, all_to_all and ppermute along one axis, against
    numpy on the same per-cell values; the other axes keep their own
    groups."""
    from ant_ray_tpu_torch.parallel import spmd

    mesh = tp.build_mesh(devices=CELLS, dp=2, tp=4)
    vals = [torch.full((4,), float(c)) + torch.arange(4.) for c in range(8)]
    summed = spmd.psum(vals, mesh, "tp")
    for c in range(8):
        group = range(4 * (c // 4), 4 * (c // 4) + 4)
        np.testing.assert_array_equal(
            summed[c].numpy(), sum(vals[g].numpy() for g in group))
    gathered = spmd.all_gather(vals, mesh, "tp", 0)
    assert gathered[5].shape == (16,) and torch.equal(
        gathered[5][4:8], vals[5])
    swapped = spmd.all_to_all(vals, mesh, "tp", 0, 0)
    assert torch.equal(swapped[1], torch.stack(
        [vals[g][1] for g in range(4)]))
    rotated = spmd.ppermute(vals, mesh, "tp")
    assert torch.equal(rotated[0], vals[3]) and torch.equal(rotated[5],
                                                            vals[4])
