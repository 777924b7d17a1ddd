"""The port's training half against the JAX package's: ``loss_fn`` and
every gradient leaf against ``jax.value_and_grad(jl.loss_fn)`` with the
JAX weights carried across by ``params_from_jax_numpy``, AdamW against
``optax.adamw``, ``flops_per_token``, and ``train_step``.

fp32 on the CPU.  Loss to atol 1e-5; each gradient leaf to a max abs
error of at most 1e-4 of that leaf's max |grad| (sums in another order
through two layers and the flash kernels' plain versions on one side,
the Pallas kernels in interpret mode on the other); AdamW to rtol 1e-5
(the same update, rounded in another order).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_ray_tpu.models import llama as jl
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
from ant_ray_tpu_torch.train import make_optimizer, train_step
from ant_ray_tpu_torch.train.step import param_leaves

# TF32 off, so fp32 matmuls compare in full fp32 wherever a card runs them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRAD_REL_TOL = 1e-4

# head_dim 64, sequence 128: shapes the flash path takes.
SMALL = dict(dim=256, n_heads=4, n_kv_heads=2, mlp_dim=256, n_layers=2,
             max_seq=256)

# head_dim 256 (dim 512 over 2 heads), one KV head.
HEAD_DIM_256 = dict(dim=512, n_heads=2, n_kv_heads=1, mlp_dim=256,
                    n_layers=2, max_seq=256)

# The fp32 head_dim-256 training path's head layout (Gemma-2B's: 8 heads
# of 256 on one KV head, so dim 2048), with a small MLP and two layers.
D256_PATH_HEADS = dict(dim=2048, n_heads=8, n_kv_heads=1, mlp_dim=256,
                       n_layers=2, max_seq=256)


def _configs(name, **changes):
    return (dataclasses.replace(jl.CONFIGS[name], **changes),
            dataclasses.replace(tl.CONFIGS[name], **changes))


def _params(jcfg, tcfg, seed):
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jparams, tparams


def _flat(tree):
    """(path, leaf) pairs of a nested dict, sorted by path."""
    out = []
    for name, value in tree.items():
        if isinstance(value, dict):
            out += [(f"{name}.{sub}", leaf) for sub, leaf in _flat(value)]
        else:
            out.append((name, value))
    return sorted(out, key=lambda kv: kv[0])


def _check_loss_and_grads(name, changes, batch, jax_impl, torch_impl, remat,
                          seed=0):
    jcfg, tcfg = _configs(name, **changes)
    jparams, tparams = _params(jcfg, tcfg, seed)
    jbatch = {key: jnp.asarray(val, jnp.int32) for key, val in batch.items()}
    want_loss, want_grads = jax.value_and_grad(jl.loss_fn)(
        jparams, jbatch, jcfg, attn_impl=jax_impl, remat=remat)

    flat = _flat(tparams)
    for _, leaf in flat:
        leaf.requires_grad_()
    tbatch = {key: torch.from_numpy(val) for key, val in batch.items()}
    loss = tl.loss_fn(tparams, tbatch, tcfg, attn_impl=torch_impl,
                      remat=remat)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                               atol=1e-5)
    want = dict(_flat(want_grads))
    assert sorted(want) == [path for path, _ in flat]
    for (path, _), got in zip(flat, grads):
        ref = np.asarray(want[path])
        err = np.abs(got.numpy() - ref).max()
        assert err <= GRAD_REL_TOL * np.abs(ref).max(), (path, err)


def _tokens(seed, batch, seq, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq))


REMATS = ["none", "full", "dots", "matmuls"]


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("impls", [("pallas", "flash"),
                                   ("blockwise", "blockwise")])
def test_loss_and_grads_match_jax(impls, remat):
    _check_loss_and_grads("tiny", SMALL, {"tokens": _tokens(1, 2, 129)},
                          *impls, remat)


def test_head_dim_256_loss_and_grads_match_jax():
    """A Llama whose heads are 256 wide (Gemma-2B's head_dim, one KV
    head): the flash kernels' plain versions at D=256 against the
    Pallas kernels in interpret mode, through the whole model."""
    _check_loss_and_grads("tiny", HEAD_DIM_256,
                          {"tokens": _tokens(7, 2, 129)}, "pallas", "flash",
                          "none")


def test_head_dim_256_path_layout_loss_and_grads_match_jax():
    """The fp32 head_dim-256 path's heads (8 of 256 sharing one KV head,
    as chip_smoke's d256 fp32 phase has them): the flash kernels' plain
    versions against the Pallas kernels in interpret mode, GQA groups of
    eight, sequence 128, fp32."""
    _check_loss_and_grads("tiny", D256_PATH_HEADS,
                          {"tokens": _tokens(9, 2, 129)}, "pallas", "flash",
                          "none")


def test_masked_loss_and_grads_match_jax():
    mask = np.ones((2, 129), np.int64)
    mask[0, 100:] = 0
    mask[1, :17] = 0
    _check_loss_and_grads("tiny", SMALL,
                          {"tokens": _tokens(2, 2, 129), "mask": mask},
                          "pallas", "flash", "none")


@pytest.mark.parametrize("remat", ["none", "matmuls"])
def test_moe_grads_match_jax_router_included(remat):
    _check_loss_and_grads("moe-tiny", {}, {"tokens": _tokens(3, 2, 33)},
                          "auto", "auto", remat, seed=4)


def test_unknown_remat_policy_raises():
    _, tcfg = _configs("tiny")
    params = tl.init_params(tcfg, device="cpu")
    toks = torch.from_numpy(_tokens(5, 1, 17))
    with pytest.raises(ValueError, match="remat"):
        tl.loss_fn(params, {"tokens": toks}, tcfg, remat="some")


@pytest.mark.parametrize("name", ["tiny", "moe-tiny", "llama-400m",
                                  "llama3-8b"])
@pytest.mark.parametrize("seq", [128, 2048])
def test_flops_per_token_matches_jax(name, seq):
    assert tl.flops_per_token(tl.CONFIGS[name], seq) == \
        jl.flops_per_token(jl.CONFIGS[name], seq)


def test_adamw_matches_optax_over_three_steps():
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "layers": {"b": rng.standard_normal((3, 7)).astype(np.float32)}}
    grads = [jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        for _ in range(3)]

    opt = optax.adamw(3e-4, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = opt.init(jparams)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = jax.tree.map(torch.from_numpy, tree)
    optimizer = make_optimizer(tparams)
    assert all(p.requires_grad for p in param_leaves(tparams))
    for g in grads:
        for p, gp in zip(param_leaves(tparams),
                         param_leaves(jax.tree.map(torch.from_numpy, g))):
            p.grad = gp
        optimizer.step()
    for p, want in zip(param_leaves(tparams), param_leaves(jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
    state = optimizer.state[param_leaves(tparams)[0]]
    assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == \
        torch.float32


@pytest.mark.parametrize("remat", REMATS)
def test_train_step_learns(remat):
    """A few steps on a repetitive sequence cut the loss, as the JAX
    package's tests/test_llama.py shows for its own step."""
    cfg = tl.CONFIGS["tiny"]
    params = tl.init_params(cfg, generator=torch.Generator().manual_seed(7),
                            device="cpu")
    optimizer = make_optimizer(params, lr=3e-3)
    pattern = np.tile(np.arange(8), 9)[None, :65].repeat(2, 0)
    losses = [train_step(params, optimizer, pattern, cfg, remat=remat,
                         device="cpu").item() for _ in range(10)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0]


def test_train_step_without_a_device_raises():
    cfg = tl.CONFIGS["tiny"]
    params = tl.init_params(cfg, device="cpu")
    optimizer = make_optimizer(params)
    tokens = _tokens(8, 1, 17)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="parameters live on"):
            train_step(params, optimizer, tokens, cfg)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_step(params, optimizer, tokens, cfg)
