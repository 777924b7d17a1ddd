"""Llama model family — ant_ray_tpu/models/llama.py in PyTorch: the
forward with its remat modes, the training loss, and the serving
primitives.

Parameters are a plain dict of tensors with the reference's leaf names
(``embed``, ``layers.wq``, …, ``norm_f``, ``lm_head``) and its stacked
``(n_layers, in, out)`` layout, so ``h @ W`` reads as it does there and
models/convert.py carries weights across leaf by leaf.  Layers run as a
Python loop over the stacked leading axis, each layer's weights a view
from ``unbind(0)``.  No mesh: one device.

Serving primitives (dense per-slot KV slabs) update the slab IN PLACE
where the reference returns a new one — the slab is the largest tensor
of a serving process and a copy per step would double it.  The
functions still return the cache dict, so callers read like the
reference's.

JAX silently drops out-of-bounds scatter writes and clamps out-of-range
gathers, and the reference's serving code relies on both; torch raises
(or trips a device-side assert) instead.  Each such place is handled
explicitly below and says so.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.ops.attention import (
    attention,
    dots_with_no_batch_dims_saveable,
    saveable_attention_policy,
)
from ant_ray_tpu_torch.ops.rmsnorm import rmsnorm
from ant_ray_tpu_torch.ops.rope import apply_rope, rope_frequencies, rope_one


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # Mixture-of-experts MLP (0 = dense), dense top-k dispatch.
    num_experts: int = 0
    experts_per_token: int = 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        p = self.vocab_size * self.dim                       # embed
        if self.num_experts:
            mlp = (self.dim * self.num_experts               # router
                   + 3 * self.num_experts * self.dim * self.mlp_dim)
        else:
            mlp = 3 * self.dim * self.mlp_dim                # gate, up, down
        per_layer = (
            self.dim * self.n_heads * self.head_dim          # wq
            + 2 * self.dim * self.n_kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * self.dim        # wo
            + mlp
            + 2 * self.dim                                   # norms
        )
        p += self.n_layers * per_layer + self.dim            # final norm
        if not self.tie_embeddings:
            p += self.dim * self.vocab_size                  # lm head
        return p


CONFIGS: dict[str, LlamaConfig] = {
    # the Llama-3-8B model at its published widths
    "llama3-8b": LlamaConfig(),
    "llama3-1b": LlamaConfig(
        vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        mlp_dim=8192, max_seq=8192),
    "llama-400m": LlamaConfig(
        vocab_size=32768, dim=1024, n_layers=24, n_heads=8, n_kv_heads=4,
        mlp_dim=4096, max_seq=4096),
    "tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=128, max_seq=512, dtype=torch.float32),
    # MoE variant: 4 experts, top-2 routing
    "moe-tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=128, max_seq=512, dtype=torch.float32,
        num_experts=4, experts_per_token=2),
}

_NORMS = ("ln_attn", "ln_mlp", "norm_f")

# remat mode -> the selective-checkpoint policy of its blocks ("none"
# checkpoints nothing, "full" saves only each block's input).
_REMAT_POLICIES = {"none": None, "full": None,
                   "dots": dots_with_no_batch_dims_saveable,
                   "matmuls": saveable_attention_policy}


# ---------------------------------------------------------------- params

def param_shapes(config: LlamaConfig) -> dict:
    c = config
    hd = c.head_dim
    if c.num_experts:
        mlp_shapes = {
            "router": (c.n_layers, c.dim, c.num_experts),
            "w_gate": (c.n_layers, c.num_experts, c.dim, c.mlp_dim),
            "w_up": (c.n_layers, c.num_experts, c.dim, c.mlp_dim),
            "w_down": (c.n_layers, c.num_experts, c.mlp_dim, c.dim),
        }
    else:
        mlp_shapes = {
            "w_gate": (c.n_layers, c.dim, c.mlp_dim),
            "w_up": (c.n_layers, c.dim, c.mlp_dim),
            "w_down": (c.n_layers, c.mlp_dim, c.dim),
        }
    return {
        "embed": (c.vocab_size, c.dim),
        "layers": {
            "ln_attn": (c.n_layers, c.dim),
            "wq": (c.n_layers, c.dim, c.n_heads * hd),
            "wk": (c.n_layers, c.dim, c.n_kv_heads * hd),
            "wv": (c.n_layers, c.dim, c.n_kv_heads * hd),
            "wo": (c.n_layers, c.n_heads * hd, c.dim),
            "ln_mlp": (c.n_layers, c.dim),
            **mlp_shapes,
        },
        "norm_f": (c.dim,),
        **({} if config.tie_embeddings else
           {"lm_head": (c.dim, c.vocab_size)}),
    }


def init_params(config: LlamaConfig, *,
                generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random weights made directly on ``device`` in the config dtype:
    norms are ones, everything else N(0, 0.02).  ``generator`` must
    live on ``device``; None means one seeded with 0."""
    return init_leaves(param_shapes(config), config.dtype,
                       lambda name: 1.0 if name in _NORMS else None,
                       generator=generator, device=device)


def init_leaves(shapes: dict, dtype: torch.dtype, constant, *,
                generator: torch.Generator | None = None,
                device=None) -> dict:
    """Tensors of ``shapes`` (a ``param_shapes`` dict, the stacked
    ``layers`` after the top-level leaves) on ``device`` in ``dtype``:
    filled with ``constant(name)`` where that is not None, else drawn
    from N(0, 0.02) one leading-axis slice at a time in fp32, so no
    full-size fp32 copy of a leaf ever exists (for Llama-3-8B that
    would be 32 GB).  ``generator`` must live on ``device``; None means
    one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def _init(name, shape):
        value = constant(name)
        if value is not None:
            return torch.full(shape, value, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for row in out:
            row.copy_(torch.randn(row.shape, generator=generator,
                                  device=device).mul_(0.02))
        return out

    params = {name: _init(name, shape) for name, shape in shapes.items()
              if name != "layers"}
    params["layers"] = {name: _init(name, shape)
                        for name, shape in shapes["layers"].items()}
    return params


def _layers(params: dict) -> list[dict]:
    """Each layer's weights as views of the stacked leaves.  ``unbind``
    and not ``w[i]``: under autograd every ``w[i]`` would give back a
    zero-filled gradient the size of the whole stacked leaf, n_layers
    of them per leaf per step; the backward of ``unbind`` is one stack."""
    unbound = {name: w.unbind(0) for name, w in params["layers"].items()}
    n_layers = len(next(iter(unbound.values())))
    return [{name: ws[i] for name, ws in unbound.items()}
            for i in range(n_layers)]


def _head(params: dict, c: LlamaConfig):
    return params["embed"].T if c.tie_embeddings else params["lm_head"]


def _mlp(layer: dict, h, c: LlamaConfig):
    if c.num_experts:
        return _moe_mlp(layer, h, c)
    gated = F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])
    return gated @ layer["w_down"]


# ---------------------------------------------------------------- forward

def apply_block(layer: dict, x, c: LlamaConfig, cos, sin, positions,
                attend, *, return_kv: bool = False):
    """One transformer block over one layer's weights."""
    batch, seq, _ = x.shape
    h = rmsnorm(x, layer["ln_attn"], c.norm_eps)
    xq = (h @ layer["wq"]).reshape(batch, seq, c.n_heads, c.head_dim)
    xk = (h @ layer["wk"]).reshape(batch, seq, c.n_kv_heads, c.head_dim)
    xv = (h @ layer["wv"]).reshape(batch, seq, c.n_kv_heads, c.head_dim)
    xq = apply_rope(xq, cos, sin, positions)
    xk = apply_rope(xk, cos, sin, positions)
    attn = attend(xq, xk, xv)
    attn = attn.reshape(batch, seq, c.n_heads * c.head_dim)
    x = x + (attn @ layer["wo"]).to(x.dtype)

    h = rmsnorm(x, layer["ln_mlp"], c.norm_eps)
    x = x + _mlp(layer, h, c).to(x.dtype)
    kv = (xk.to(c.dtype), xv.to(c.dtype)) if return_kv else None
    return x, kv


def _moe_mlp(layer: dict, h, c: LlamaConfig):
    """Top-k mixture-of-experts MLP with dense dispatch: every expert
    runs on every token, weighted by the router's top-k gates."""
    router_logits = h @ layer["router"]                    # (b, s, E)
    top_vals, top_idx = torch.topk(router_logits, c.experts_per_token,
                                   dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                # (b, s, k)
    # Scatter the top-k gates back to a dense (b, s, E) weight map.
    weights = torch.sum(
        F.one_hot(top_idx, c.num_experts).to(h.dtype)
        * gates[..., None].to(h.dtype), dim=-2)
    ge = torch.einsum("bsd,edm->ebsm", h, layer["w_gate"])  # (E, b, s, m)
    ue = torch.einsum("bsd,edm->ebsm", h, layer["w_up"])
    oe = torch.einsum("ebsm,emd->ebsd", F.silu(ge) * ue, layer["w_down"])
    return torch.einsum("ebsd,bse->bsd", oe, weights)


def forward(params: dict, tokens, config: LlamaConfig, *,
            attn_impl: str = "auto", positions=None,
            return_kv: bool = False, logits_at: int | None = None,
            remat: str = "full"):
    """tokens: (batch, seq) integer → logits (batch, seq, vocab) fp32.

    ``return_kv=True`` additionally returns the per-layer K/V
    (layers, b, s, kv_heads, hd) for cache insertion (serving prefill);
    ``logits_at`` (a position) computes logits for that one position
    only — (b, vocab) — skipping the full-sequence lm-head matmul.

    ``remat`` trades memory for recompute in the backward pass when
    autograd records the forward; every mode but "none" runs each block
    under non-reentrant ``torch.utils.checkpoint``, as the reference
    runs it under ``jax.checkpoint``.  "none" saves everything; "full"
    saves only each block's input, so the backward re-runs the block's
    forward, the flash kernel included; "dots" saves the outputs of the
    matmuls without batch dimensions
    (:func:`~ant_ray_tpu_torch.ops.attention.dots_with_no_batch_dims_saveable`)
    and recomputes the rest, the flash forward included; "matmuls" also
    saves batched matmuls and the flash forward's (out, lse)
    (:func:`~ant_ray_tpu_torch.ops.attention.saveable_attention_policy`),
    so only the elementwise work is recomputed.

    Unlike the reference's, the selective policies here do not sit
    between "none" and "full": they run a Python dispatch mode over
    every op of each block, in the forward and in the recompute, and
    that host work sets the step.  On llama-400m at 8 x 2048 on an H100
    "full" was both faster and smaller than "dots" and "matmuls"
    (PERF.md section 6), so "full" is the policy to fall back to."""
    c = config
    if remat not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                torch.float32, device=tokens.device)

    def attend(xq, xk, xv):
        return attention(xq, xk, xv, causal=True, impl=attn_impl)

    run_block = apply_block
    if remat != "none" and torch.is_grad_enabled():
        policy = _REMAT_POLICIES[remat]
        context_fn = (noop_context_fn if policy is None else functools.partial(
            create_selective_checkpoint_contexts, policy()))
        run_block = functools.partial(checkpoint, apply_block,
                                      use_reentrant=False,
                                      context_fn=context_fn)

    # F.embedding, not indexing: on the CPU its backward sums each row's
    # gradients in an order that does not depend on the thread count.
    x = F.embedding(tokens, params["embed"]).to(c.dtype)
    ks, vs = [], []
    for layer in _layers(params):
        x, kv = run_block(layer, x, c, cos, sin, positions, attend,
                          return_kv=return_kv)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rmsnorm(x, params["norm_f"], c.norm_eps)
    if logits_at is not None:
        x = x[:, logits_at]                                 # (b, dim)
    logits = (x @ _head(params, c).to(c.dtype)).float()
    if return_kv:
        return logits, torch.stack(ks), torch.stack(vs)
    return logits


def loss_fn(params: dict, batch: dict, config: LlamaConfig, *,
            attn_impl: str = "auto", remat: str = "full"):
    """batch: {"tokens": (b, s+1) integer, optional "mask": (b, s+1)} —
    next-token cross entropy on the fp32 logits, averaged over the
    positions the mask keeps (all of them without one)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = forward(params, inputs, config, attn_impl=attn_impl,
                     remat=remat)
    losses = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                             reduction="none").view(targets.shape)
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:].to(losses.dtype)
        return (losses * mask).sum() / mask.sum().clamp(min=1)
    return losses.mean()


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token (6·N matmul + attention quadratic term)."""
    c = config
    matmul = 6 * c.num_params()
    attn = 12 * c.n_layers * c.head_dim * c.n_heads * seq_len
    return matmul + attn


# ------------------------------------------------------------- kv cache
# Dense per-slot KV slabs, as in the reference.

def init_kv_cache(config: LlamaConfig, slots: int,
                  max_seq: int | None = None, *, device=None) -> dict:
    """Per-slot dense KV slabs: (layers, slots, max_seq, kv_heads, hd)."""
    c = config
    device = resolve_device(device)
    ms = max_seq or c.max_seq
    shape = (c.n_layers, slots, ms, c.n_kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.dtype, device=device),
        "v": torch.zeros(shape, dtype=c.dtype, device=device),
        # tokens already written per slot (== next write position)
        "length": torch.zeros((slots,), dtype=torch.int64, device=device),
    }


# One slot's slab, ``cache["k"][:, slot]``, is a strided view: n_layers
# blocks of (max_seq, kv_heads, hd), each contiguous, ``slots`` blocks
# apart.  Both functions below copy it block by block, so neither needs
# a contiguous staging copy of the slab on the device.

def extract_slot(cache: dict, slot: int):
    """Copy one slot's slab to host memory: (k, v, length), k and v
    contiguous CPU tensors of shape (layers, max_seq, kv_heads, hd) and
    length an int.  From a CUDA cache the bytes land in pinned memory
    and the call returns once they are there."""
    src_k, src_v = cache["k"][:, slot], cache["v"][:, slot]
    pin = src_k.is_cuda
    k = torch.empty(src_k.shape, dtype=src_k.dtype, pin_memory=pin)
    v = torch.empty(src_v.shape, dtype=src_v.dtype, pin_memory=pin)
    for i in range(src_k.shape[0]):
        k[i].copy_(src_k[i], non_blocking=pin)
        v[i].copy_(src_v[i], non_blocking=pin)
    if pin:
        torch.cuda.current_stream(src_k.device).synchronize()
    return k, v, int(cache["length"][slot])


def install_slot(cache: dict, k, v, length: int, slot: int):
    """Write a slab from ``extract_slot`` into ``slot``; returns the
    cache.  The copies are queued on the current stream, so they land
    before any later work on it (the next decode or prefill).  From
    pinned memory the host does not wait for them; from pageable memory
    each copy blocks the host for its transfer."""
    dst_k, dst_v = cache["k"][:, slot], cache["v"][:, slot]
    for i in range(dst_k.shape[0]):
        dst_k[i].copy_(k[i], non_blocking=True)
        dst_v[i].copy_(v[i], non_blocking=True)
    # fill_ with a Python number is a kernel: no host-to-device copy of
    # the value, which from pageable memory would wait for the stream.
    cache["length"][slot].fill_(int(length))
    return cache


def prefill_into_cache(params: dict, tokens, cache: dict, slot: int,
                       length: int, config: LlamaConfig, *,
                       attn_impl: str = "auto"):
    """Run prefill on one padded prompt (1, s) and write its K/V into
    ``slot``; returns (last-token logits (vocab,), cache).

    As in the reference, the whole padded bucket's K/V goes into the
    slab, pad positions included: decode masks them by length and later
    overwrites them."""
    seq = tokens.shape[1]
    if seq > cache["k"].shape[2]:
        raise ValueError(f"prompt bucket {seq} exceeds the slab's "
                         f"{cache['k'].shape[2]} positions")
    last_pos = max(int(length) - 1, 0)
    logits, ks, vs = forward(params, tokens, config, attn_impl=attn_impl,
                             return_kv=True, logits_at=last_pos)
    cache["k"][:, slot, :seq] = ks[:, 0]
    cache["v"][:, slot, :seq] = vs[:, 0]
    cache["length"][slot] = int(length)
    return logits[0], cache


def prefill_chunk_into_cache(params: dict, tokens, cache: dict, slot: int,
                             start: int, chunk_len: int,
                             config: LlamaConfig):
    """Ingest ONE fixed-size chunk of a prompt into ``slot``.

    tokens: (chunk,) integer — ``chunk_len`` real tokens, zero-padded to
    the engine's fixed chunk width; ``slot``, ``start`` (the chunk's
    offset in the slab) and ``chunk_len`` are host integers.  Chunk
    queries attend against the slot's slab (earlier chunks' K/V plus
    this chunk's own, causally masked).  Pad positions write nothing:
    the reference pushes their scatter out of bounds for JAX to drop;
    here only the real rows are written, and never past the slab's end.

    Returns (logits (vocab,) fp32 at the chunk's last real token, cache
    with slot length set to ``start + chunk_len``)."""
    c = config
    slot, start, chunk_len = int(slot), int(start), int(chunk_len)
    chunk = tokens.shape[0]
    max_seq = cache["k"].shape[2]
    device = tokens.device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                torch.float32, device=device)
    group = c.n_heads // c.n_kv_heads
    pos = start + torch.arange(chunk, device=device)         # absolute
    # JAX clamps the gather; torch would raise: clamp the rope positions
    # (pad rows only — their values never reach the slab or the logits).
    rope_pos = pos.clamp(max=c.max_seq - 1)
    pc = cos[rope_pos][:, None, :]                           # (chunk, 1, hd/2)
    ps = sin[rope_pos][:, None, :]
    n_write = max(0, min(chunk_len, max_seq - start))
    t_max = min(start + chunk, max_seq)
    valid = torch.arange(t_max, device=device)[None, :] <= pos[:, None]

    x = params["embed"][tokens].to(c.dtype)                  # (chunk, dim)
    for i, layer in enumerate(_layers(params)):
        ck, cv = cache["k"][i, slot], cache["v"][i, slot]    # (ms, kvh, hd)
        h = rmsnorm(x, layer["ln_attn"], c.norm_eps)
        xq = (h @ layer["wq"]).reshape(chunk, c.n_heads, c.head_dim)
        xk = (h @ layer["wk"]).reshape(chunk, c.n_kv_heads, c.head_dim)
        xv = (h @ layer["wv"]).reshape(chunk, c.n_kv_heads, c.head_dim)
        xq = rope_one(xq, pc, ps)
        xk = rope_one(xk, pc, ps)
        ck[start:start + n_write] = xk[:n_write].to(ck.dtype)
        cv[start:start + n_write] = xv[:n_write].to(cv.dtype)
        q = xq.reshape(chunk, c.n_kv_heads, group, c.head_dim).float()
        scores = torch.einsum("ckgd,tkd->ckgt", q, ck[:t_max].float())
        scores = scores / math.sqrt(c.head_dim)
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("ckgt,tkd->ckgd", probs.to(ck.dtype).float(),
                           cv[:t_max].float())
        out = out.reshape(chunk, c.n_heads * c.head_dim).to(x.dtype)
        x = x + (out @ layer["wo"]).to(x.dtype)
        h = rmsnorm(x, layer["ln_mlp"], c.norm_eps)
        x = x + _mlp(layer, h[None], c)[0].to(x.dtype)
    x = rmsnorm(x, params["norm_f"], c.norm_eps)
    x_last = x[max(chunk_len - 1, 0)]
    logits = (x_last @ _head(params, c).to(c.dtype)).float()
    cache["length"][slot] = start + chunk_len
    return logits, cache


def decode_step(params: dict, last_tokens, cache: dict,
                config: LlamaConfig, active=None):
    """One token for every slot, attending against the KV cache.

    last_tokens: (slots,) integer — the most recent token per slot.
    ``active`` ((slots,) bool, optional): slots marked False neither
    write K/V nor advance their length, so their slab bytes stay
    unchanged.  ``active=None`` steps every slot.
    Returns (logits (slots, vocab) fp32, cache with +1 lengths)."""
    c = config
    slots = last_tokens.shape[0]
    max_seq = cache["k"].shape[2]
    device = last_tokens.device
    pos = cache["length"]                       # (slots,) write position
    # The reference writes inactive slots (and slots already at max_seq)
    # at position max_seq, a scatter JAX drops.  Here every slot writes
    # at a clamped position, and a slot that must not write writes back
    # the value already there: no out-of-bounds index, no duplicate.
    write = pos < max_seq
    if active is not None:
        write = write & active
    write_pos = pos.clamp(max=max_seq - 1)
    rows = torch.arange(slots, device=device)
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                torch.float32, device=device)
    # JAX clamps cos[pos] for a slot at the end of the table; clamp here.
    rope_pos = pos.clamp(max=c.max_seq - 1)
    pc = cos[rope_pos][:, None, :]              # (slots, 1, hd/2)
    ps = sin[rope_pos][:, None, :]
    group = c.n_heads // c.n_kv_heads
    # Attention runs over the whole slab, masked per slot, as in the
    # reference.  Cutting it at the batch's longest position would move
    # fewer bytes, but each slot's softmax and P.V would then reduce over
    # a length set by the other slots, and round with it: on an H100 a
    # session's greedy tokens then changed with the requests that shared
    # its decode steps.  Over the whole slab every shape is fixed.
    valid = torch.arange(max_seq, device=device)[None, :] <= pos[:, None]
    keep = write[:, None, None]

    x = params["embed"][last_tokens].to(c.dtype)   # (slots, dim)
    for i, layer in enumerate(_layers(params)):
        ck, cv = cache["k"][i], cache["v"][i]   # (slots, ms, kvh, hd)
        h = rmsnorm(x, layer["ln_attn"], c.norm_eps)
        xq = (h @ layer["wq"]).reshape(slots, c.n_heads, c.head_dim)
        xk = (h @ layer["wk"]).reshape(slots, c.n_kv_heads, c.head_dim)
        xv = (h @ layer["wv"]).reshape(slots, c.n_kv_heads, c.head_dim)
        xq = rope_one(xq, pc, ps)
        xk = rope_one(xk, pc, ps)
        ck[rows, write_pos] = torch.where(keep, xk.to(ck.dtype),
                                          ck[rows, write_pos])
        cv[rows, write_pos] = torch.where(keep, xv.to(cv.dtype),
                                          cv[rows, write_pos])
        q = xq.reshape(slots, c.n_kv_heads, group, c.head_dim).float()
        scores = torch.einsum("skgd,stkd->skgt", q, ck.float())
        scores = scores / math.sqrt(c.head_dim)
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("skgt,stkd->skgd", probs.to(ck.dtype).float(),
                           cv.float())
        out = out.reshape(slots, c.n_heads * c.head_dim).to(x.dtype)
        x = x + (out @ layer["wo"]).to(x.dtype)
        h = rmsnorm(x, layer["ln_mlp"], c.norm_eps)
        x = x + _mlp(layer, h[None], c)[0].to(x.dtype)
    x = rmsnorm(x, params["norm_f"], c.norm_eps)
    logits = (x @ _head(params, c).to(c.dtype)).float()
    # Idle slots keep stepping and are clamped at the slab's end; with an
    # ``active`` mask, inactive slots' lengths hold still.
    new_len = torch.clamp(pos + 1, max=max_seq)
    if active is not None:
        new_len = torch.where(active, new_len, pos)
    cache["length"] = new_len
    return logits, cache


# ---------------------------------------------------------------- generate

@torch.inference_mode()
def greedy_generate(params: dict, config: LlamaConfig, prompt,
                    max_new_tokens: int = 32):
    """Minimal greedy decoding (no KV cache — a correctness utility; the
    serving engine owns the fast path)."""
    tokens = prompt[None] if prompt.ndim == 1 else prompt
    for _ in range(max_new_tokens):
        logits = forward(params, tokens, config)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens
