"""Ulysses-style sequence parallelism: all-to-all head scatter
(counterpart of ant_ray_tpu/parallel/ulysses.py).

The sequence-sharded activations are re-sharded so each station holds
the *full* sequence for a *subset of heads* (one all-to-all along the
sequence axis), attention runs locally per head group, and a second
all-to-all restores sequence sharding.  Ulysses moves activations twice
but runs attention unblocked; ring attention never materialises the full
sequence.
"""

from __future__ import annotations

from ant_ray_tpu_torch.parallel import spmd
from ant_ray_tpu_torch.parallel.ring import reference_attention, run_over_axis


def ulysses_attention_kernel(qs, ks, vs, *, causal: bool = True,
                             scale: float | None = None,
                             attn_fn=None) -> list:
    """Ulysses attention of every station along one mesh axis.

    In place of the reference's ``axis_name`` / ``axis_size``, the
    arguments are the stations' shards in order: ``qs[i]`` (batch,
    seq_local, heads, head_dim), ``ks[i]`` and ``vs[i]`` likewise with
    the KV heads; heads and KV heads must be divisible by the number of
    stations.  ``attn_fn(q, k, v)`` runs full local attention; it
    defaults to the exact reference implementation."""
    attn_fn = attn_fn or (
        lambda q_, k_, v_: reference_attention(q_, k_, v_, causal=causal,
                                               scale=scale))
    n = len(qs)
    num_heads = qs[0].shape[2]
    num_kv_heads = ks[0].shape[2]
    if num_heads % n != 0:
        raise ValueError(f"heads {num_heads} not divisible by sp axis {n}")
    if num_kv_heads % n != 0:
        raise ValueError(
            f"kv heads {num_kv_heads} not divisible by sp axis {n}")

    def scatter_heads(xs):
        # (b, s_local, h, d) → (b, s_global, h/n, d)
        return spmd.swap_members(xs, split_dim=2, concat_dim=1)

    outs = [attn_fn(q, k, v) for q, k, v in zip(
        scatter_heads(qs), scatter_heads(ks), scatter_heads(vs))]
    # (b, s_global, h/n, d) → (b, s_local, h, d)
    return spmd.swap_members(outs, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, *, mesh, axis_name: str = "sp",
                      causal: bool = True, scale: float | None = None,
                      batch_axes=("dp", "fsdp")) -> spmd.ShardedTensor:
    """Sharded Ulysses attention over global tensors (heads are NOT split
    over tp here: the sp axis claims the head dimension).  Returns the
    output as a ShardedTensor laid out like the inputs."""
    spec = spmd.P(batch_axes, axis_name, None, None)

    def kernel(qs, ks, vs):
        return ulysses_attention_kernel(qs, ks, vs, causal=causal,
                                        scale=scale)

    return run_over_axis(kernel, mesh, axis_name, (q, k, v), spec)
