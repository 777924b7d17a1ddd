"""Ring attention: exact attention over sequence shards, with the K/V
blocks passed one station around the ring per step and a flash-style
online softmax, so each station holds O(seq_local) (counterpart of
ant_ray_tpu/parallel/ring.py).

Two entry points:
* :func:`ring_attention_kernel` — the stations' code, given the list of
  their shards along the sequence axis (what the model layer uses).
* :func:`ring_attention` — lays global tensors out over a mesh and runs
  the kernel in every group of cells along the sequence axis.

Plain torch, as the reference's is plain einsums: no flash kernel runs
here.
"""

from __future__ import annotations

import torch

from ant_ray_tpu_torch.parallel import spmd


def ring_attention_kernel(qs, ks, vs, *, causal: bool = True,
                          scale: float | None = None) -> list:
    """Exact ring attention of every station along one mesh axis.

    In place of the reference's ``axis_name`` / ``lax.axis_index``, the
    arguments are the stations' shards in ring order: ``qs[i]``
    (batch, q_len_local, num_heads, head_dim) and ``ks[i]``, ``vs[i]``
    (batch, kv_len_local, num_kv_heads, head_dim), each on station i's
    device.  ``causal`` masks by *global* position (station i holds
    positions i * len_local onwards); ``scale`` defaults to
    1/sqrt(head_dim).

    Returns the stations' outputs, (batch, q_len_local, num_heads,
    head_dim) in q's dtype each, on their devices."""
    n = len(qs)
    _batch, q_len, num_heads, head_dim = qs[0].shape
    kv_len = ks[0].shape[1]
    num_kv_heads = ks[0].shape[2]
    if num_heads % num_kv_heads != 0:
        raise ValueError(f"heads {num_heads} not divisible by kv heads "
                         f"{num_kv_heads}")
    groups = num_heads // num_kv_heads
    scale = scale if scale is not None else head_dim ** -0.5

    state = []
    for i, q in enumerate(qs):
        q32 = q.float() * scale
        q_pos = i * q_len + torch.arange(q_len, device=q.device)
        o = torch.zeros_like(q32)
        l = q32.new_zeros(q32.shape[0], num_heads, q_len)     # (b, h, q)
        m = torch.full_like(l, float("-inf"))
        state.append([q32, q_pos, o, l, m])
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for i, st in enumerate(state):
            q32, q_pos, o_acc, l_acc, m_acc = st
            kv_block = (i - step) % n
            kv_pos = kv_block * kv_len + torch.arange(kv_len,
                                                      device=q32.device)
            k_rep = k_cur[i].float().repeat_interleave(groups, dim=2)
            scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_rep)
            if causal:
                mask = kv_pos[None, :] > q_pos[:, None]
                scores = scores.masked_fill(mask[None, None], float("-inf"))
            block_max = scores.amax(dim=-1)                   # (b, h, q)
            m_new = torch.maximum(m_acc, block_max)
            # All -inf rows (nothing attendable yet) stay neutral.
            m_safe = torch.where(torch.isneginf(m_new),
                                 torch.zeros_like(m_new), m_new)
            p = torch.exp(scores - m_safe[..., None])
            p = torch.where(torch.isneginf(scores), torch.zeros_like(p), p)
            correction = torch.where(torch.isneginf(m_acc),
                                     torch.zeros_like(m_acc),
                                     torch.exp(m_acc - m_safe))
            v_rep = v_cur[i].float().repeat_interleave(groups, dim=2)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, v_rep)
            st[2] = o_acc * correction.transpose(1, 2)[..., None] + pv
            st[3] = l_acc * correction + p.sum(dim=-1)
            st[4] = m_new
        # Pass K/V one station around the ring.
        k_cur, v_cur = (spmd.rotate_members(k_cur),
                        spmd.rotate_members(v_cur))

    outs = []
    for q, (_q32, _pos, o, l, _m) in zip(qs, state):
        l = torch.where(l == 0.0, torch.ones_like(l), l)      # fully masked
        outs.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return outs


def run_over_axis(kernel, mesh, axis_name, tensors, spec):
    """Lay ``tensors`` out by ``spec`` over ``mesh`` and run ``kernel``
    (lists along ``axis_name`` → list) in every group of cells along
    ``axis_name``; the result, laid out by ``spec``, as a ShardedTensor."""
    sharding = spmd.NamedSharding(mesh, spec)
    placed = [spmd.shard(t, sharding) for t in tensors]
    out = [None] * mesh.size
    for group in spmd.groups(mesh, axis_name):
        got = kernel(*([p.shards[c] for c in group] for p in placed))
        for c, o in zip(group, got):
            out[c] = o
    return spmd.ShardedTensor(out, sharding, placed[0].shape)


def ring_attention(q, k, v, *, mesh, axis_name: str = "sp",
                   causal: bool = True, scale: float | None = None,
                   batch_axes=("dp", "fsdp"), head_axis: str | None = "tp"
                   ) -> spmd.ShardedTensor:
    """Sharded ring attention over global tensors (or numpy arrays or
    ShardedTensors): q/k/v (batch, seq, heads, head_dim), the sequence
    split over ``axis_name``, batch over ``batch_axes``, heads over
    ``head_axis``.  Returns the output as a ShardedTensor laid out so."""
    spec = spmd.P(batch_axes, axis_name, head_axis, None)

    def kernel(qs, ks, vs):
        return ring_attention_kernel(qs, ks, vs, causal=causal, scale=scale)

    return run_over_axis(kernel, mesh, axis_name, (q, k, v), spec)


def reference_attention(q, k, v, causal: bool = True,
                        scale: float | None = None):
    """Plain full attention (testing oracle for the parallel variants);
    (batch, seq, heads, head_dim) layout."""
    _batch, q_len, num_heads, head_dim = q.shape
    groups = num_heads // k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    k = k.float().repeat_interleave(groups, dim=2)
    v = v.float().repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k)
    if causal:
        q_pos = torch.arange(q_len, device=q.device)
        mask = q_pos[:, None] < torch.arange(k.shape[1],
                                             device=q.device)[None, :]
        scores = scores.masked_fill(mask[None, None], float("-inf"))
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.to(q.dtype)
