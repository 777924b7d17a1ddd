"""The port's sharded Llama against the JAX package's: tests/test_llama.py's
sharded cases (fsdp x tp, sequence-parallel ring attention, expert-parallel
MoE, the GPipe loss and its gradients), and the gradient of the sharded
loss against ``jax.grad`` of the JAX sharded loss.  Each side places the
same weights (the JAX ``init_params``, carried across as numpy by
``params_from_jax_numpy``) with its own ``param_shardings`` on the same
mesh shape: the JAX package on its virtual mesh of 8 CPU devices, the port
on a virtual mesh of 8 CPU cells.

Tolerance: logits, losses and gradients to atol 2e-4 (fp32; the
reference's own bound between its sharded and unsharded forward); the
port's placed leaves assemble to the plain ones bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_ray_tpu.models import llama as jl
from ant_ray_tpu.parallel import MeshConfig, build_mesh as jbuild
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
from ant_ray_tpu_torch.parallel import build_mesh as tbuild
from ant_ray_tpu_torch.parallel import device_put, spmd

TOL = 2e-4
CELLS = ["cpu"] * 8


def _pair(name, seed):
    jcfg, tcfg = jl.CONFIGS[name], tl.CONFIGS[name]
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny", 0)


@pytest.fixture(scope="module")
def moe():
    return _pair("moe-tiny", 1)


def _tokens(batch=2, seq=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (batch, seq))


def _placed(pair, config):
    jcfg, tcfg, jparams, tparams = pair
    jmesh = jbuild(config)
    tmesh = tbuild(config, devices=CELLS)
    return (jmesh, jax.device_put(jparams, jl.param_shardings(jcfg, jmesh)),
            tmesh, device_put(tparams, tl.param_shardings(tcfg, tmesh)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _sharded_forward_case(pair, config):
    jcfg, tcfg, jparams, tparams = pair
    jmesh, jplaced, tmesh, tplaced = _placed(pair, config)
    toks = _tokens()
    want = jax.jit(lambda p, t: jl.forward(p, t, jcfg, mesh=jmesh))(
        jplaced, jnp.asarray(toks, jnp.int32))
    got = tl.forward(tplaced, torch.from_numpy(toks), tcfg)
    assert isinstance(got, spmd.ShardedTensor) and got.mesh == tmesh
    np.testing.assert_allclose(got.full().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    base = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.full().numpy(), base.numpy(), atol=TOL,
                               rtol=TOL)
    for name, leaf in _leaves(tplaced):
        plain = dict(_leaves(tparams))[name]
        assert torch.equal(leaf.full(), plain), name


def test_sharded_matches_unsharded(tiny):
    """FSDP+TP: tp=4 splits tiny's 2 KV heads mid-head in storage, as
    the reference's spec does; each cell gathers the KV heads it reads."""
    _sharded_forward_case(tiny, MeshConfig(fsdp=2, tp=4))


def test_ring_sharded_matches_unsharded(tiny):
    _sharded_forward_case(tiny, MeshConfig(sp=4, dp=-1))


def test_moe_expert_sharded_matches_unsharded(moe):
    _sharded_forward_case(moe, MeshConfig(ep=2, tp=2, dp=-1))


def test_pp_loss_matches_dense_loss(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    jmesh, jplaced, tmesh, tplaced = _placed(tiny, MeshConfig(pp=2, tp=2,
                                                              dp=-1))
    toks = _tokens(4, 65)
    want = float(jax.jit(
        lambda p, b: jl.loss_fn_pp(p, b, jcfg, mesh=jmesh,
                                   num_microbatches=2))(
            jplaced, {"tokens": jnp.asarray(toks, jnp.int32)}))
    got = tl.loss_fn_pp(tplaced, {"tokens": torch.from_numpy(toks)}, tcfg,
                        mesh=tmesh, num_microbatches=2)
    base = tl.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert abs(float(got) - want) < TOL, (float(got), want)
    assert abs(float(got) - float(base)) < TOL
    with pytest.raises(ValueError, match="microbatches"):
        tl.loss_fn_pp(tplaced, {"tokens": torch.from_numpy(toks)}, tcfg,
                      mesh=tmesh, num_microbatches=3)


def _requiring_grad(tree):
    return {k: _requiring_grad(v) if isinstance(v, dict)
            else v.clone().requires_grad_() for k, v in tree.items()}


def _grads(tree):
    return {name: leaf.grad for name, leaf in _leaves(tree)}


def test_pp_grads_flow(tiny):
    """Backward through the pipeline reaches every stage's params, and
    equals jax.grad of the JAX pipeline loss."""
    jcfg, tcfg, jparams, tparams = tiny
    jmesh, jplaced, tmesh, _ = _placed(tiny, MeshConfig(pp=2, tp=2, dp=-1))
    toks = _tokens(4, 65)
    want = jax.jit(jax.grad(
        lambda p: jl.loss_fn_pp(p, {"tokens": jnp.asarray(toks, jnp.int32)},
                                jcfg, mesh=jmesh, num_microbatches=2)))(
            jplaced)
    leaves = _requiring_grad(tparams)
    placed = device_put(leaves, tl.param_shardings(tcfg, tmesh))
    tl.loss_fn_pp(placed, {"tokens": torch.from_numpy(toks)}, tcfg,
                  mesh=tmesh, num_microbatches=2).backward()
    got = _grads(leaves)
    for name in ("wq", "w_gate", "w_down"):
        g = got["layers." + name].numpy()
        assert np.abs(g[0]).sum() > 0 and np.abs(g[1]).sum() > 0, name
    for name, w in _leaves(jax.tree.map(np.asarray, want)):
        np.testing.assert_allclose(got[name].numpy(), w, atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("config,remat", [
    (MeshConfig(fsdp=2, tp=4), "full"),
    (MeshConfig(dp=2, fsdp=2, tp=2), "none"),
    (MeshConfig(sp=2, tp=2, dp=-1), "none"),
])
def test_sharded_loss_grads_match_jax_grad(tiny, config, remat):
    """loss_fn(mesh=) and every gradient leaf against jax.value_and_grad
    of the JAX loss on the same mesh shape; gradients reach the plain
    leaves the shards were placed from."""
    jcfg, tcfg, jparams, tparams = tiny
    jmesh = jbuild(config)
    tmesh = tbuild(config, devices=CELLS)
    toks = _tokens(4, 33, seed=3)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jl.loss_fn(p, jbatch, jcfg, mesh=jmesh)))(
            jax.device_put(jparams, jl.param_shardings(jcfg, jmesh)))
    leaves = _requiring_grad(tparams)
    loss = tl.loss_fn(device_put(leaves, tl.param_shardings(tcfg, tmesh)),
                      {"tokens": torch.from_numpy(toks)}, tcfg, mesh=tmesh,
                      remat=remat)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < TOL
    got = _grads(leaves)
    for name, w in _leaves(jax.tree.map(np.asarray, want)):
        np.testing.assert_allclose(got[name].numpy(), w, atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_sharded_masked_loss_and_logits_at(tiny):
    """The mask's average over the cells' blocks, and the one position
    of ``logits_at`` from the sequence cell that holds it."""
    _jcfg, tcfg, _jparams, tparams = tiny
    mesh = tbuild(MeshConfig(sp=4, dp=2), devices=CELLS)
    toks = torch.from_numpy(_tokens(2, 65, seed=4))
    mask = torch.from_numpy(
        (np.random.RandomState(5).rand(2, 65) > 0.3).astype(np.float32))
    batch = {"tokens": toks, "mask": mask}
    want = tl.loss_fn(tparams, batch, tcfg)
    got = tl.loss_fn(tparams, batch, tcfg, mesh=mesh)
    assert abs(float(got) - float(want)) < TOL
    at = tl.forward(tparams, toks[:, :64], tcfg, mesh=mesh, logits_at=37)
    np.testing.assert_allclose(
        at.full().numpy(), tl.forward(tparams, toks[:, :64], tcfg)[:, 37],
        atol=TOL, rtol=TOL)
