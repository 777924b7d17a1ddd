"""The flash-attention kernel's plain version against the JAX package's
Pallas kernel, which runs here in interpret mode (as
tests/test_parallel.py runs it).  fp32, tolerance 1e-4 on out and lse,
as the JAX package's own lse test holds its kernel.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_ray_tpu.ops.pallas.flash_attention import (
    flash_attention_fwd_lse as jax_flash,
)
from ant_ray_tpu_torch.ops import flash_attention

# TF32 off, so fp32 matmuls compare in full fp32 wherever a card runs them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, q_len, kv_len, heads, kv_heads, dim):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, q_len, heads, dim)).astype(np.float32)
    k = rng.standard_normal((1, kv_len, kv_heads, dim)).astype(np.float32)
    v = rng.standard_normal((1, kv_len, kv_heads, dim)).astype(np.float32)
    return q, k, v


def _check(q, k, v, causal):
    want_out, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   interpret=True)
    got_out, got_lse = flash_attention.flash_attention_fwd_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert got_out.dtype == torch.float32 and got_lse.dtype == torch.float32
    assert tuple(got_lse.shape) == tuple(want_lse.shape)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dim", [64, 128, 256])
def test_plain_version_matches_pallas_kernel(causal, groups, dim):
    _check(*_inputs(11, 256, 256, 4, 4 // groups, dim), causal)


def test_causal_alignment_is_top_left():
    """Sq=128 against Skv=256: query i sees keys 0..i (k_pos > q_pos is
    masked), not the bottom-right alignment some libraries use."""
    _check(*_inputs(12, 128, 256, 4, 2, 64), causal=True)


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    q, k, v = map(torch.from_numpy, _inputs(13, 128, 128, 4, 2, 64))
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, v)
    want_out, want_lse = flash_attention.flash_attention_fwd_lse_ref(q, k, v)
    assert flash_attention.launch_count == 0
    torch.testing.assert_close(out, want_out)
    torch.testing.assert_close(lse, want_lse)


def test_wrapper_rejects_mismatched_inputs():
    q, k, v = map(torch.from_numpy, _inputs(14, 128, 128, 4, 2, 64))
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd_lse(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd_lse(q, k.double(), v)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd_lse(q, k, v[..., :32])
