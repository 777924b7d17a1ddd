"""The flash-attention backward's plain version against the JAX package's
Pallas backward kernels, which run here in interpret mode, and gradients
through ``attention(impl="flash")`` against ``jax.grad`` through the
JAX ``attention(impl="pallas")``.

Both sides get the same numpy inputs; ``out`` and ``lse`` come from the
forward's plain version (held to the Pallas forward by
tests/test_torch_flash.py).  Tolerances: fp32 rtol = atol = 1e-4, as
the forward's parity test; bf16 max abs error over max |ref| <= 1e-2
per tensor, since the two sides round p and ds to bf16 at the same
points but sum in another order, so a value near a bf16 rounding
boundary may land one ulp (2^-8 relative) apart.

The CUDA kernels themselves run only on the card; chip_smoke.py and
tests/test_torch_cuda.py hold them against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_ray_tpu.ops.attention import attention as jax_attention
from ant_ray_tpu.ops.pallas.flash_attention import (
    flash_attention_backward as jax_flash_backward,
)
from ant_ray_tpu_torch.ops import flash_attention as fa
from ant_ray_tpu_torch.ops.attention import attention

# TF32 off, so fp32 matmuls compare in full fp32 wherever a card runs them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_TOL = 1e-2


def _inputs(seed, q_len, kv_len, heads, kv_heads, dim):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (rand(1, q_len, heads, dim), rand(1, kv_len, kv_heads, dim),
            rand(1, kv_len, kv_heads, dim), rand(1, q_len, heads, dim))


def _both(q, k, v, do, causal, dtype=torch.float32):
    """(port's plain backward, JAX Pallas backward) on the same inputs,
    as numpy fp32."""
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd_lse_ref(tq, tk, tv, causal=causal)
    got = fa.flash_attention_backward_ref(tq, tk, tv, out, lse, tdo,
                                          causal=causal)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jdo, jout = (jnp.asarray(x.float().numpy(), jdtype)
                             for x in (tq, tk, tv, tdo, out))
    want = jax_flash_backward(jq, jk, jv, jout, jnp.asarray(lse.numpy()),
                              jdo, causal=causal, interpret=True)
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == x.dtype and tuple(g.shape) == tuple(w.shape)
    return ([g.float().numpy() for g in got],
            [np.asarray(w.astype(jnp.float32)) for w in want])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("dim", [64, 128, 256])
def test_plain_backward_matches_pallas_kernels(causal, groups, dim):
    got, want = _both(*_inputs(21, 256, 256, 4, 4 // groups, dim), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_kernels_in_groups_of_eight(causal):
    """The fp32 head_dim-256 training path's heads: 8 query heads of 256
    on one KV head, so the dK/dV sweep sums eight heads into each KV
    row."""
    got, want = _both(*_inputs(24, 256, 256, 8, 1, 256), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_plain_backward_causal_alignment_is_top_left():
    """Sq=128 against Skv=256: keys 128..255 are seen by no query, so
    their dk and dv are zero."""
    got, want = _both(*_inputs(22, 128, 256, 4, 2, 64), causal=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert not got[1][:, 128:].any() and not got[2][:, 128:].any()


def test_plain_backward_bf16_matches_pallas_kernels():
    got, want = _both(*_inputs(23, 256, 256, 4, 2, 64), causal=True,
                      dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= BF16_REL_TOL * np.abs(w).max()


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_through_flash_matches_jax_grad(causal, groups):
    """torch.autograd.grad through attention(impl='flash') (the kernels'
    plain versions on the CPU) against jax.grad through the JAX
    attention(impl='pallas') (its Pallas kernels in interpret mode)."""
    q, k, v, w = _inputs(24, 256, 256, 4, 4 // groups, 64)

    def jax_loss(q, k, v):
        return (jax_attention(q, k, v, causal=causal, impl="pallas")
                * w).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention(tq, tk, tv, causal=causal, impl="flash")
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_backward_wrapper_on_cpu_runs_the_plain_version_without_launching():
    q, k, v, do = map(torch.from_numpy, _inputs(25, 128, 128, 4, 2, 64))
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=True)
    assert fa.bwd_dq_launch_count == fa.bwd_dkv_launch_count == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


def test_backward_wrapper_rejects_mismatched_residuals():
    q, k, v, do = map(torch.from_numpy, _inputs(26, 128, 128, 4, 2, 64))
    out, lse = fa.flash_attention_fwd_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, out, lse[:, :, :64], do,
                                    causal=True)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_backward(q, k, v, out, lse, do[:, :64],
                                    causal=True)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_backward(q, k, v, out, lse, do.double(),
                                    causal=True)


def test_flash_under_inference_mode_builds_no_graph():
    q, k, v, _ = map(torch.from_numpy, _inputs(27, 128, 128, 4, 2, 64))
    q.requires_grad_()
    with torch.inference_mode():
        out = attention(q, k, v, impl="flash")
    assert not out.requires_grad and out.grad_fn is None
    k.requires_grad_()
    v.requires_grad_()
    out = attention(q, k, v, impl="flash")
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(g.shape == t.shape and torch.isfinite(g).all() and g.any()
               for g, t in zip(grads, (q, k, v)))
