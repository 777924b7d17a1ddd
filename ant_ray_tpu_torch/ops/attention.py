"""Attention implementations and the dispatch layer (counterpart of
ant_ray_tpu/ops/attention.py).

* :func:`blockwise_attention` — flash-style attention in plain PyTorch:
  a loop over KV blocks with online softmax, O(seq · block) memory.
* :class:`_FlashFunction` — the hand-written CUDA flash kernels
  (ops/flash_attention.py) under autograd, in the role of the JAX
  package's ``_flash`` custom VJP: the forward kernel saves (q, k, v,
  out, lse), the backward runs the dQ and dK/dV kernels.
* :func:`reference_attention` — plain full attention (the testing
  oracle, from ant_ray_tpu/parallel/ring.py).
* :func:`attention` — dispatcher: the flash kernels on CUDA when shapes
  tile cleanly, blockwise otherwise.  Every variant is differentiable.
"""

from __future__ import annotations

import torch

from ant_ray_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    NEG_INF,
    flash_attention_backward,
    flash_attention_fwd_lse,
)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None, block_k: int = 512):
    """Flash-style attention.

    q: (batch, q_len, heads, dim); k/v: (batch, kv_len, kv_heads, dim).
    The reference keeps bf16 matmul inputs with fp32 accumulation
    (``preferred_element_type``); torch returns bf16 from a bf16 matmul,
    so the operands are upcast here (bf16 products are exact in fp32)
    and p is rounded to the input dtype before P·V as there.
    """
    batch, q_len, num_heads, head_dim = q.shape
    kv_len, num_kv_heads = k.shape[1], k.shape[2]
    groups = num_heads // num_kv_heads
    scale = scale if scale is not None else head_dim ** -0.5
    block_k = min(block_k, kv_len)
    if kv_len % block_k != 0:
        raise ValueError(f"kv_len {kv_len} % block_k {block_k} != 0")

    qt = q.transpose(1, 2).float()                               # b h q d
    kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).float()
    vt = v.repeat_interleave(groups, dim=2).transpose(1, 2)
    q_pos = torch.arange(q_len, device=q.device)

    o = torch.zeros((batch, num_heads, q_len, head_dim),
                    dtype=torch.float32, device=q.device)
    l = torch.zeros((batch, num_heads, q_len), dtype=torch.float32,
                    device=q.device)
    m = torch.full((batch, num_heads, q_len), NEG_INF, dtype=torch.float32,
                   device=q.device)
    for start in range(0, kv_len, block_k):
        k_b = kt[:, :, start:start + block_k]
        v_b = vt[:, :, start:start + block_k]
        scores = torch.matmul(qt, k_b.transpose(-1, -2)) * scale
        if causal:
            kv_pos = start + torch.arange(block_k, device=q.device)
            mask = kv_pos[None, :] > q_pos[:, None]
            scores = scores.masked_fill(mask, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        o = o * corr[..., None] + torch.matmul(p.to(q.dtype).float(),
                                               v_b.float())
        l = l * corr + p.sum(dim=-1)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (o / l[..., None]).transpose(1, 2)
    return out.to(q.dtype)


def reference_attention(q, k, v, causal: bool = True,
                        scale: float | None = None):
    """Plain full attention (testing oracle for the other variants)."""
    _batch, q_len, num_heads, head_dim = q.shape
    groups = num_heads // k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    k = k.float().repeat_interleave(groups, dim=2)
    v = v.float().repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k)
    if causal:
        q_pos = torch.arange(q_len, device=q.device)
        mask = q_pos[None, :, None] < torch.arange(
            k.shape[1], device=q.device)[None, None, :]
        scores = scores.masked_fill(mask[:, None], float("-inf"))
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.to(q.dtype)


class _FlashFunction(torch.autograd.Function):
    """Flash attention with its own backward kernels: the counterpart of
    ``_flash`` (ant_ray_tpu/ops/attention.py), whose custom VJP saves the
    forward kernel's (q, k, v, out, lse) and runs the two backward
    kernels.  Under ``torch.inference_mode()`` or ``no_grad`` no graph is
    built and only the forward kernel runs.  Non-reentrant activation
    checkpointing re-runs :meth:`forward` in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                           scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              impl: str = "auto"):
    """Dispatch: 'flash' | 'blockwise' | 'reference' | 'auto'.

    'auto' takes the flash kernel for CUDA tensors whose lengths are
    multiples of 128 and whose head_dim is 64, 128 or 256 (the
    reference's rule, with "on TPU" read as "on CUDA"), blockwise
    otherwise.  'flash' runs the kernels through :class:`_FlashFunction`
    (on CPU tensors, their plain versions)."""
    if impl == "auto":
        seq_ok = q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
        dim_ok = q.shape[-1] in HEAD_DIMS
        impl = ("flash" if q.device.type == "cuda" and seq_ok and dim_ok
                else "blockwise")
    if impl == "flash":
        return _FlashFunction.apply(q, k, v, causal, scale)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, scale=scale)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
