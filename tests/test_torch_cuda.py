"""The hand-written CUDA flash-attention kernel against its plain PyTorch
version, on the card.  These tests need a CUDA device and ``nvcc``: they
skip on a machine without a card.  This file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: bf16 out max abs error <= 2e-2 (p and
out round to bf16 at other points of the tiled loop), lse <= 1e-3; fp32
both <= 1e-4.  TF32 is switched off, so fp32 matmuls of the plain
version run in full fp32.
"""

import pytest
import torch

from ant_ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, q_len, kv_len, heads, kv_heads, dim, dtype):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (rand(2, q_len, heads, dim), rand(2, kv_len, kv_heads, dim),
            rand(2, kv_len, kv_heads, dim))


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,dim,dtype,causal", [
    (256, 256, 8, 2, 128, torch.bfloat16, True),
    (256, 256, 8, 8, 128, torch.bfloat16, False),
    (128, 256, 4, 1, 64, torch.float32, True),
    (192, 192, 4, 2, 256, torch.float32, False),
    (128, 128, 4, 4, 256, torch.bfloat16, True),
])
def test_kernel_matches_plain_version(cuda, q_len, kv_len, heads, kv_heads,
                                      dim, dtype, causal):
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, dim, dtype)
    before = fa.launch_count
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - want_out.float()).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


def test_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd_lse(q, k, v)
    q, k, v = _qkv(cuda, 100, 100, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention_fwd_lse(q, k, v)
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_fwd_lse(q, k, v)
