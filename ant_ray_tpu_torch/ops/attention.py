"""Attention implementations and the dispatch layer (counterpart of
ant_ray_tpu/ops/attention.py).

* :func:`blockwise_attention` — flash-style attention in plain PyTorch:
  a loop over KV blocks with online softmax, O(seq · block) memory.
* ``impl="flash"`` — the hand-written CUDA flash kernels through the
  custom op ``ant_ray_tpu_torch::flash_fwd`` (ops/flash_attention.py),
  in the role of the JAX package's ``_flash`` custom VJP: the forward
  kernel saves (q, k, v, out, lse), the backward runs the dQ and dK/dV
  kernels.
* :func:`reference_attention` — plain full attention (the testing
  oracle, from ant_ray_tpu/parallel/ring.py).
* :func:`attention` — dispatcher: the flash kernels on CUDA when shapes
  tile cleanly, blockwise otherwise.  Every variant is differentiable.
* :func:`saveable_attention_policy` and
  :func:`dots_with_no_batch_dims_saveable` — selective-checkpoint
  policies, the counterparts of the JAX remat policies "matmuls" and
  "dots".
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import CheckpointPolicy

from ant_ray_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    NEG_INF,
    flash_fwd,
)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None, block_k: int = 512):
    """Flash-style attention.

    q: (batch, q_len, heads, dim); k/v: (batch, kv_len, kv_heads, dim).
    The reference keeps bf16 matmul inputs with fp32 accumulation
    (``preferred_element_type``); torch returns bf16 from a bf16 matmul,
    so the operands are upcast here (bf16 products are exact in fp32)
    and p is rounded to the input dtype before P·V as there.

    Unlike the reference, which raises when ``kv_len`` is longer than
    ``block_k`` and not a multiple of it, the last KV block may be
    shorter: a forward over ``max_len - 1`` tokens
    (llm/batch.py ``build_logprob_processor``) at any ``max_len``.
    """
    batch, q_len, num_heads, head_dim = q.shape
    kv_len, num_kv_heads = k.shape[1], k.shape[2]
    groups = num_heads // num_kv_heads
    scale = scale if scale is not None else head_dim ** -0.5
    block_k = min(block_k, kv_len)

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
            kv_pos = start + torch.arange(k_b.shape[2], device=q.device)
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


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_only(ops):
    """A selective-checkpoint policy (``torch.utils.checkpoint.
    create_selective_checkpoint_contexts``) that saves the outputs of
    ``ops`` and recomputes everything else."""
    ops = frozenset(ops)

    def policy(_ctx, op, *_args, **_kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def dots_with_no_batch_dims_saveable():
    """Counterpart of ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`` (remat "dots"): save the outputs
    of matmuls without batch dimensions.  ``x @ W`` with a 3-D ``x``
    reaches the dispatcher as ``aten.mm``; batched products
    (``aten.bmm``) and the flash forward are recomputed."""
    return _save_only(_DOTS)


def saveable_attention_policy():
    """Counterpart of ``saveable_attention_policy`` in
    ant_ray_tpu/ops/attention.py (remat "matmuls"): save every matmul
    output, batch dimensions included (``dots_saveable``), and the flash
    forward's (out, lse) (the reference's named ``attn_out`` and
    ``attn_lse``), so the backward pass never re-runs the attention
    forward."""
    return _save_only(_DOTS + _BATCHED_DOTS
                      + (torch.ops.ant_ray_tpu_torch.flash_fwd.default,))


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              impl: str = "auto"):
    """Dispatch: 'flash' | 'blockwise' | 'reference' | 'auto'.

    'auto' takes the flash kernel for CUDA tensors whose lengths are
    multiples of 128 and whose head_dim is 64, 128 or 256 (the
    reference's rule, with "on TPU" read as "on CUDA"), blockwise
    otherwise.  'flash' runs the kernels (on CPU tensors, their plain
    versions) through the custom op ``ant_ray_tpu_torch::flash_fwd``,
    in every autograd mode."""
    if impl == "auto":
        seq_ok = q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
        dim_ok = q.shape[-1] in HEAD_DIMS
        impl = ("flash" if q.device.type == "cuda" and seq_ok and dim_ok
                else "blockwise")
    if impl == "flash":
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        return flash_fwd(q, k, v, causal, scale)[0]
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, scale=scale)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
