"""The port's GPT-2 family against the JAX package's
(ant_ray_tpu/models/gpt2.py): logits, loss and every gradient leaf on
the same weights (made by the JAX ``init_params``, carried across as
numpy by ``params_from_jax_numpy``), HF loading against the JAX
conversion and against HF's own logits, the parameter and FLOP counts,
and ``train_step``.

Tolerances.  fp32: logits to atol 1e-5 (sums in another order through
two layers); loss to atol 1e-5 and each gradient leaf to a max abs
error of at most 1e-4 of that leaf's max |grad|, as
tests/test_torch_train.py holds the Llama family.  bf16: logits to a
max abs error of at most 2e-2 of max |logit| (about 4 bf16 ulps at the
largest logit).  Both sides round LayerNorm's mean and variance to bf16
once and every matmul's result to bf16, but XLA on the CPU may keep
elementwise chains in fp32 where torch rounds each op, so single values
can sit a few bf16 ulps (2^-8 relative) apart; a wrong layout or
rounding point gives errors of order 1.  HF logits to atol = rtol =
2e-3, the reference's own test (tests/test_gpt2.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_ray_tpu.models import gpt2 as jg
from ant_ray_tpu_torch.models import gpt2 as tg
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
from ant_ray_tpu_torch.train import make_optimizer, train_step
from ant_ray_tpu_torch.train.step import param_leaves

torch.backends.cuda.matmul.allow_tf32 = False

GRAD_REL_TOL = 1e-4
BF16_LOGIT_REL_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(name="tiny", dtype="float32", **changes):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jg.CONFIGS[name], dtype=jdt, **changes),
            dataclasses.replace(tg.CONFIGS[name], dtype=tdt, **changes))


def _params(jcfg, tcfg, seed):
    jparams = jg.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jparams, tparams


def _tokens(seed, batch, seq, vocab=257):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq))


def _flat(tree):
    out = []
    for name, value in tree.items():
        if isinstance(value, dict):
            out += [(f"{name}.{sub}", leaf) for sub, leaf in _flat(value)]
        else:
            out.append((name, value))
    return sorted(out, key=lambda kv: kv[0])


def _as_float_numpy(t):
    return t.detach().float().numpy()


def test_fp32_logits_match_jax():
    jcfg, tcfg = _configs()
    jparams, tparams = _params(jcfg, tcfg, 0)
    toks = _tokens(1, 2, 48)
    want = np.asarray(jg.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.no_grad():
        got = tg.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 48, 257)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bf16_logits_match_jax():
    jcfg, tcfg = _configs(dtype="bfloat16")
    jparams, tparams = _params(jcfg, tcfg, 2)
    toks = _tokens(3, 2, 48)
    want = np.asarray(jg.forward(jparams, jnp.asarray(toks), jcfg)
                      ).astype(np.float32)
    with torch.no_grad():
        got = tg.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(_as_float_numpy(got) - want).max()
    assert err <= BF16_LOGIT_REL_TOL * np.abs(want).max(), err


def _check_loss_and_grads(batch, attn_impl, seed=4, **changes):
    jcfg, tcfg = _configs(**changes)
    jparams, tparams = _params(jcfg, tcfg, seed)
    jbatch = {key: jnp.asarray(val, jnp.int32) for key, val in batch.items()}
    want_loss, want_grads = jax.value_and_grad(jg.loss_fn)(
        jparams, jbatch, jcfg)

    flat = _flat(tparams)
    for _, leaf in flat:
        leaf.requires_grad_()
    tbatch = {key: torch.from_numpy(val) for key, val in batch.items()}
    loss = tg.loss_fn(tparams, tbatch, tcfg, attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                               atol=1e-5)
    want = dict(_flat(want_grads))
    assert sorted(want) == [path for path, _ in flat]
    for (path, _), got in zip(flat, grads):
        ref = np.asarray(want[path])
        err = np.abs(got.numpy() - ref).max()
        assert err <= GRAD_REL_TOL * np.abs(ref).max(), (path, err)


# "flash" runs the kernels' plain versions here, against the reference's
# blockwise attention (its "auto" on the CPU), at head_dim 64 and a
# length of 128, where the card takes the kernels.
@pytest.mark.parametrize("attn_impl,changes", [
    ("auto", {}),
    ("flash", dict(dim=128, n_heads=2, n_positions=256)),
])
def test_loss_and_grads_match_jax(attn_impl, changes):
    _check_loss_and_grads({"tokens": _tokens(5, 2, 129)}, attn_impl,
                          **changes)


def test_masked_loss_and_grads_match_jax():
    mask = np.ones((2, 49), np.int64)
    mask[0, 30:] = 0
    mask[1, :7] = 0
    _check_loss_and_grads({"tokens": _tokens(6, 2, 49), "mask": mask},
                          "auto")


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    hf_config = transformers.GPT2Config(
        vocab_size=257, n_positions=128, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_config).eval()


def test_hf_conversion_equals_the_jax_conversion(hf_model):
    state = hf_model.state_dict()
    want = dict(_flat(jax.tree.map(np.asarray, jg.from_hf_state_dict(
        state, jg.CONFIGS["tiny"]))))
    got = _flat(tg.from_hf_state_dict(state, tg.CONFIGS["tiny"],
                                      device="cpu"))
    assert [path for path, _ in got] == sorted(want)
    for path, leaf in got:
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    # The leaves are copies: training them leaves the HF model untouched.
    assert dict(got)["lnf_b"].data_ptr() != state[
        "transformer.ln_f.bias"].data_ptr()


def test_hf_logits_match(hf_model):
    params = tg.from_hf_state_dict(hf_model.state_dict(),
                                   tg.CONFIGS["tiny"], device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 257, (2, 48)))
    with torch.no_grad():
        ref = hf_model(toks).logits.numpy()
        ours = tg.forward(params, toks, tg.CONFIGS["tiny"]).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("name", list(jg.CONFIGS))
def test_counts_match_jax(name):
    jcfg, tcfg = jg.CONFIGS[name], tg.CONFIGS[name]
    assert tcfg.num_params() == jcfg.num_params()
    assert (tcfg.head_dim, tcfg.mlp_dim) == (jcfg.head_dim, jcfg.mlp_dim)
    assert tg.param_shapes(tcfg) == jg.param_shapes(jcfg)
    for seq in (128, 1024):
        assert tg.flops_per_token(tcfg, seq) == jg.flops_per_token(jcfg, seq)


def test_published_configs_are_fp32():
    assert all(cfg.dtype == torch.float32 for cfg in tg.CONFIGS.values())


def test_conversion_checks_the_tree_against_the_config():
    jcfg, tcfg = _configs()
    tree = jax.tree.map(np.asarray, jg.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tree["layers"]["fc_w"] = tree["layers"]["fc_w"][:, :, :8]
    with pytest.raises(ValueError, match="fc_w"):
        params_from_jax_numpy(tree, tcfg, device="cpu")
    del tree["layers"]["fc_w"]
    with pytest.raises(ValueError, match="do not match"):
        params_from_jax_numpy(tree, tcfg, device="cpu")


def test_init_params_shapes_and_values():
    cfg = tg.CONFIGS["tiny"]
    params = tg.init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    shapes = dict(_flat(tg.param_shapes(cfg)))
    for path, leaf in _flat(params):
        assert tuple(leaf.shape) == shapes[path] and leaf.dtype == cfg.dtype
        if path.endswith("_b"):
            assert not leaf.any()
        elif path.endswith("_g"):
            assert (leaf == 1).all()
        else:
            assert 0.015 < leaf.std().item() < 0.025, path


def test_train_step_learns():
    """A few AdamW steps on one batch cut the loss, as the reference's
    tests/test_gpt2.py shows for its own step."""
    cfg = tg.CONFIGS["tiny"]
    params = tg.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    optimizer = make_optimizer(params, lr=1e-3)
    tokens = _tokens(1, 4, 33)
    losses = [train_step(params, optimizer, tokens, cfg,
                         device="cpu").item() for _ in range(21)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(p.grad is not None for p in param_leaves(params))


def test_train_step_takes_no_remat_for_gpt2():
    cfg = tg.CONFIGS["tiny"]
    params = tg.init_params(cfg, device="cpu")
    optimizer = make_optimizer(params)
    with pytest.raises(ValueError, match="remat"):
        train_step(params, optimizer, _tokens(2, 1, 17), cfg, remat="none",
                   device="cpu")
