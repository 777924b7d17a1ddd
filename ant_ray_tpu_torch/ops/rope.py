"""Rotary position embeddings (Llama-style, half-split layout);
counterpart of ant_ray_tpu/ops/rope.py and ``_rope_one`` of
ant_ray_tpu/models/llama.py."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 500000.0,
                     dtype=torch.float32, device=None):
    """Precompute cos/sin tables: (max_seq, head_dim // 2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=device), exps)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def rope_one(x, cos, sin):
    """Rotate x (..., hd) by cos/sin already gathered and broadcastable
    to (..., hd/2): rows at their own positions in decode and chunked
    prefill ((rows, heads, hd) with (rows, 1, hd/2) tables)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, cos, sin, positions=None):
    """x: (batch, seq, heads, head_dim); cos/sin: (max_seq, head_dim//2);
    positions: (batch, seq) integer (defaults to arange).

    JAX clamps an out-of-range gather; torch raises, so positions are
    clamped to the table here."""
    seq = x.shape[1]
    if positions is None:
        cos_sel = cos[:seq][None, :, None, :]     # (1, s, 1, d/2)
        sin_sel = sin[:seq][None, :, None, :]
    else:
        positions = positions.clamp(0, cos.shape[0] - 1)
        cos_sel = cos[positions][:, :, None, :]   # (b, s, 1, d/2)
        sin_sel = sin[positions][:, :, None, :]
    return rope_one(x, cos_sel, sin_sel)
