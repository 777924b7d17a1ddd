"""The port's ops against the JAX package's, on the CPU in fp32.

Inputs come from numpy (``default_rng``) and go through both frameworks.
Tolerance: rtol = atol = 1e-5 for RMSNorm and RoPE (one fp32 rounding
apart at most), 1e-4 for attention (sums over the sequence taken in
another order and, for blockwise, in other blocks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_ray_tpu.models.llama import _rope_one as jax_rope_one
from ant_ray_tpu.ops.attention import (
    blockwise_attention as jax_blockwise,
)
from ant_ray_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
from ant_ray_tpu.ops.rope import apply_rope as jax_apply_rope
from ant_ray_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from ant_ray_tpu.parallel.ring import reference_attention as jax_reference
from ant_ray_tpu_torch.ops import flash_attention
from ant_ray_tpu_torch.ops.attention import (
    attention,
    blockwise_attention,
    reference_attention,
)
from ant_ray_tpu_torch.ops.rmsnorm import rmsnorm
from ant_ray_tpu_torch.ops.rope import apply_rope, rope_frequencies, rope_one

# TF32 off, so fp32 matmuls compare in full fp32 wherever a card runs them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    _close(rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5), TOL)


def test_rope_tables_and_rotation_match_jax():
    rng = np.random.default_rng(1)
    hd, max_seq = 32, 64
    cos, sin = rope_frequencies(hd, max_seq, 500000.0, device="cpu")
    jcos, jsin = jax_rope_frequencies(hd, max_seq, 500000.0)
    _close(cos, jcos, TOL)
    _close(sin, jsin, TOL)

    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    _close(apply_rope(torch.from_numpy(x), cos, sin),
           jax_apply_rope(jnp.asarray(x), jcos, jsin), TOL)
    pos = rng.integers(0, max_seq, (2, 9))
    _close(apply_rope(torch.from_numpy(x), cos, sin, torch.from_numpy(pos)),
           jax_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos)), TOL)

    rows = rng.standard_normal((5, 3, hd)).astype(np.float32)
    rpos = rng.integers(0, max_seq, (5,))
    tpos = torch.from_numpy(rpos)
    _close(rope_one(torch.from_numpy(rows), cos[tpos][:, None],
                    sin[tpos][:, None]),
           jax_rope_one(jnp.asarray(rows), jcos[rpos][:, None],
                        jsin[rpos][:, None]), TOL)


def test_apply_rope_clamps_positions_past_the_table():
    """JAX clamps cos[pos] past the table's end; the port clamps too."""
    cos, sin = rope_frequencies(16, 8, device="cpu")
    x = torch.ones((1, 2, 1, 16))
    far = apply_rope(x, cos, sin, torch.tensor([[7, 100]]))
    last = apply_rope(x, cos, sin, torch.tensor([[7, 7]]))
    torch.testing.assert_close(far, last)


def _qkv(seed, q_len, kv_len, heads, kv_heads, dim):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, q_len, heads, dim)).astype(np.float32)
    k = rng.standard_normal((2, kv_len, kv_heads, dim)).astype(np.float32)
    v = rng.standard_normal((2, kv_len, kv_heads, dim)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 4])
def test_blockwise_and_reference_attention_match_jax(causal, groups):
    q, k, v = _qkv(2, 64, 64, 4, 4 // groups, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(blockwise_attention(tq, tk, tv, causal=causal, block_k=16),
           jax_blockwise(jq, jk, jv, causal=causal, block_k=16), ATTN_TOL)
    _close(reference_attention(tq, tk, tv, causal=causal),
           jax_reference(jq, jk, jv, causal=causal), ATTN_TOL)


def test_attention_auto_picks_blockwise_on_cpu():
    q, k, v = _qkv(3, 128, 128, 4, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = flash_attention.launch_count
    got = attention(tq, tk, tv, impl="auto")
    assert flash_attention.launch_count == before
    torch.testing.assert_close(got, blockwise_attention(tq, tk, tv))
    with pytest.raises(ValueError):
        attention(tq, tk, tv, impl="pallas")
