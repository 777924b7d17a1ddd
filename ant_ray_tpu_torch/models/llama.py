"""Llama model family — ant_ray_tpu/models/llama.py in PyTorch: the
forward with its remat modes, the training loss, and the serving
primitives.

Parameters are a plain dict of tensors with the reference's leaf names
(``embed``, ``layers.wq``, …, ``norm_f``, ``lm_head``) and its stacked
``(n_layers, in, out)`` layout, so ``h @ W`` reads as it does there and
models/convert.py carries weights across leaf by leaf.  Layers run as a
Python loop over the stacked leading axis, each layer's weights a view
from ``unbind(0)``.

On a mesh (parallel/), parameters are ShardedTensors laid out by
``param_shardings`` (the reference's logical-axis rules), and the
forward, the loss and the serving primitives run every cell's share of
each layer through the same code as on one device, joined by the
collectives of parallel/spmd.py; ``loss_fn_pp`` runs the layers as a
GPipe schedule.

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
from ant_ray_tpu_torch.parallel import spmd
from ant_ray_tpu_torch.parallel.ring import ring_attention_kernel
from ant_ray_tpu_torch.parallel.sharding import (
    DEFAULT_LLAMA_RULES,
    logical_to_spec,
)


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


def param_logical_dims(config: LlamaConfig) -> dict:
    """Logical dim names per param (see parallel/sharding.py rules)."""
    if config.num_experts:
        mlp_dims = {
            "router": (None, None, "experts"),
            "w_gate": (None, "experts", "embed_param", "mlp"),
            "w_up": (None, "experts", "embed_param", "mlp"),
            "w_down": (None, "experts", "mlp", "embed_param"),
        }
    else:
        mlp_dims = {
            "w_gate": (None, "embed_param", "mlp"),
            "w_up": (None, "embed_param", "mlp"),
            "w_down": (None, "mlp", "embed_param"),
        }
    tree = {
        "embed": ("vocab", "embed_param"),
        "layers": {
            "ln_attn": (None, "norm"),
            "wq": (None, "embed_param", "heads_flat"),
            "wk": (None, "embed_param", "heads_flat"),
            "wv": (None, "embed_param", "heads_flat"),
            "wo": (None, "heads_flat", "embed_param"),
            "ln_mlp": (None, "norm"),
            **mlp_dims,
        },
        "norm_f": ("norm",),
    }
    if not config.tie_embeddings:
        tree["lm_head"] = ("embed_param", "vocab")
    return tree


# extra rule: flattened (heads*head_dim) dims shard over tp
LLAMA_RULES_EXTRA = {"heads_flat": "tp"}


def llama_rules() -> dict:
    rules = dict(DEFAULT_LLAMA_RULES)
    rules.update(LLAMA_RULES_EXTRA)
    return rules


def param_shardings(config: LlamaConfig, mesh) -> dict:
    """NamedSharding tree of the parameters on ``mesh`` (for
    ``parallel.device_put``)."""
    rules = llama_rules()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return spmd.NamedSharding(mesh, logical_to_spec(node, rules))

    return walk(param_logical_dims(config))


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

def attention_qkv(layer: dict, h, c: LlamaConfig, cos, sin, positions,
                  n_heads: int, n_kv_heads: int):
    """The attention half's projections: rope-rotated q (batch, seq,
    n_heads, head_dim) and k, v (batch, seq, n_kv_heads, head_dim) of the
    normed input ``h``.  The head counts are the config's on one device
    and a cell's share on a mesh."""
    batch, seq, _ = h.shape
    xq = (h @ layer["wq"]).reshape(batch, seq, n_heads, c.head_dim)
    xk = (h @ layer["wk"]).reshape(batch, seq, n_kv_heads, c.head_dim)
    xv = (h @ layer["wv"]).reshape(batch, seq, n_kv_heads, c.head_dim)
    return apply_rope(xq, cos, sin, positions), \
        apply_rope(xk, cos, sin, positions), xv


def attention_half(layer: dict, x, c: LlamaConfig, cos, sin, positions,
                   attend, *, return_kv: bool = False):
    """The block's attention half up to its output product: ``attn @ wo``
    (not yet added to ``x``) and, with ``return_kv``, the layer's K/V."""
    batch, seq, _ = x.shape
    h = rmsnorm(x, layer["ln_attn"], c.norm_eps)
    xq, xk, xv = attention_qkv(layer, h, c, cos, sin, positions,
                               c.n_heads, c.n_kv_heads)
    attn = attend(xq, xk, xv)
    out = attn.reshape(batch, seq, c.n_heads * c.head_dim) @ layer["wo"]
    kv = (xk.to(c.dtype), xv.to(c.dtype)) if return_kv else None
    return out, kv


def mlp_half(layer: dict, x, c: LlamaConfig):
    """The block's MLP half: its output (not yet added to ``x``)."""
    return _mlp(layer, rmsnorm(x, layer["ln_mlp"], c.norm_eps), c)


def apply_block(layer: dict, x, c: LlamaConfig, cos, sin, positions,
                attend, *, return_kv: bool = False):
    """One transformer block over one layer's weights: the attention
    half, then the MLP half, each added to the residual stream."""
    out, kv = attention_half(layer, x, c, cos, sin, positions, attend,
                             return_kv=return_kv)
    x = x + out.to(x.dtype)
    x = x + mlp_half(layer, x, c).to(x.dtype)
    return x, kv


def _moe_mlp(layer: dict, h, c: LlamaConfig):
    """Top-k mixture-of-experts MLP with dense dispatch: every expert
    runs on every token, weighted by the router's top-k gates."""
    weights = _moe_weights(h @ layer["router"], c, h.dtype)
    return _moe_experts(layer, h, weights)


def _moe_weights(router_logits, c: LlamaConfig, dtype):
    """The router's top-k gates scattered back to a dense (b, s, E) map."""
    top_vals, top_idx = torch.topk(router_logits, c.experts_per_token,
                                   dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                # (b, s, k)
    return torch.sum(F.one_hot(top_idx, c.num_experts).to(dtype)
                     * gates[..., None].to(dtype), dim=-2)


def _moe_experts(layer: dict, h, weights):
    """The experts of ``layer`` (all, or a cell's share with the matching
    slice of ``weights``) on every token, combined by ``weights``."""
    ge = torch.einsum("bsd,edm->ebsm", h, layer["w_gate"])  # (E, b, s, m)
    ue = torch.einsum("bsd,edm->ebsm", h, layer["w_up"])
    oe = torch.einsum("ebsm,emd->ebsd", F.silu(ge) * ue, layer["w_down"])
    return torch.einsum("ebsd,bse->bsd", oe, weights)


def _remat(block, remat: str):
    """``block`` run under the remat policy's checkpoint when autograd
    records (as is, under "none" or without autograd)."""
    if remat not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return block
    policy = _REMAT_POLICIES[remat]
    context_fn = (noop_context_fn if policy is None else functools.partial(
        create_selective_checkpoint_contexts, policy()))
    return functools.partial(checkpoint, block, use_reentrant=False,
                             context_fn=context_fn)


def forward(params: dict, tokens, config: LlamaConfig, *, mesh=None,
            attn_impl: str = "auto", positions=None,
            return_kv: bool = False, logits_at: int | None = None,
            remat: str = "full"):
    """tokens: (batch, seq) integer → logits (batch, seq, vocab) fp32.

    ``return_kv=True`` additionally returns the per-layer K/V
    (layers, b, s, kv_heads, hd) for cache insertion (serving prefill);
    ``logits_at`` (a position) computes logits for that one position
    only — (b, vocab) — skipping the full-sequence lm-head matmul.

    ``mesh`` (or parameters that are ShardedTensors, whose mesh is then
    taken) runs the model over the mesh's cells, as the reference's
    sharded forward runs under XLA's partitioner: batch over (dp, fsdp),
    sequence over sp through ring attention with each cell's global rope
    positions, heads and the MLP hidden over tp with a ``psum`` after
    ``wo`` and after ``w_down``, experts over ep, the vocabulary of the
    embedding and the head over tp; fsdp-split leaves are gathered when
    their layer runs.  Each cell runs the single-device code on its
    share, the flash kernels included.  The logits (and K/V) come back
    as ShardedTensors.  Parameters not yet laid out on the mesh are laid
    out by :func:`param_shardings`.

    ``remat`` trades memory for recompute in the backward pass when
    autograd records the forward; every mode but "none" runs each block
    (on a mesh, each layer's whole sharded block) under non-reentrant
    ``torch.utils.checkpoint``, as the reference runs it under
    ``jax.checkpoint``.  "none" saves everything; "full"
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
    mesh = mesh if mesh is not None else spmd.mesh_of(params)
    if mesh is not None:
        return _sharded_forward(params, tokens, c, mesh, attn_impl=attn_impl,
                                positions=positions, return_kv=return_kv,
                                logits_at=logits_at, remat=remat)
    run_block = _remat(apply_block, remat)
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                torch.float32, device=tokens.device)

    def attend(xq, xk, xv):
        return attention(xq, xk, xv, causal=True, impl=attn_impl)

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


def loss_fn(params: dict, batch: dict, config: LlamaConfig, *, mesh=None,
            attn_impl: str = "auto", remat: str = "full"):
    """batch: {"tokens": (b, s+1) integer, optional "mask": (b, s+1)} —
    next-token cross entropy on the fp32 logits, averaged over the
    positions the mask keeps (all of them without one).

    On a mesh (``mesh``, or ShardedTensor parameters) each cell of one
    (batch, sequence) block takes the cross entropy of its logits, and
    the sums are added in cell order on the mesh's first cell's device,
    where the loss is returned."""
    tokens = spmd.as_global(batch["tokens"])
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mesh = mesh if mesh is not None else spmd.mesh_of(params)
    logits = forward(params, inputs, config, mesh=mesh, attn_impl=attn_impl,
                     remat=remat)
    mask = batch.get("mask")
    if mesh is None:
        losses = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                                 reduction="none").view(targets.shape)
        if mask is not None:
            mask = mask[:, 1:].to(losses.dtype)
            return (losses * mask).sum() / mask.sum().clamp(min=1)
        return losses.mean()

    spec = spmd.P(BATCH_AXES, "sp")
    cell_targets = spmd.split(targets, spec, mesh)
    masks = (spmd.split(spmd.as_global(mask)[:, 1:], spec, mesh)
             if mask is not None else None)
    dev0 = mesh.cell_devices[0]
    total = count = None
    for cell in range(mesh.size):
        if spmd.axis_index(mesh, cell, ("ep", "tp")) != 0:
            continue            # a copy of another cell's block
        t = cell_targets[cell]
        losses = F.cross_entropy(logits.shards[cell].flatten(0, 1),
                                 t.flatten(), reduction="none").view(t.shape)
        if masks is not None:
            m = masks[cell].to(losses.dtype)
            part, n = (losses * m).sum(), m.sum()
        else:
            part, n = losses.sum(), None
        total = part.to(dev0) if total is None else total + part.to(dev0)
        if n is not None:
            count = n.to(dev0) if count is None else count + n.to(dev0)
    if masks is not None:
        return total / count.clamp(min=1)
    return total / targets.numel()


def loss_fn_pp(params: dict, batch: dict, config: LlamaConfig, *, mesh,
               num_microbatches: int = 4, attn_impl: str = "auto"):
    """Pipeline-parallel next-token loss: the transformer blocks run as a
    GPipe schedule over the mesh's ``pp`` axis (parallel/pipeline.py),
    each stage its n_layers / pp layers; the embedding, the final norm,
    the head and the loss run on the mesh's first cell's device, where
    the loss is returned.  Requires n_layers % pp == 0 and batch %
    num_microbatches == 0.  Gradients flow back to the parameters as
    given (plain tensors or the leaves ShardedTensors were made from)."""
    from ant_ray_tpu_torch.parallel.pipeline import gpipe  # noqa: PLC0415

    c = config
    dev0 = mesh.cell_devices[0]
    tokens = spmd.as_global(batch["tokens"]).to(dev0)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    pp = mesh.shape.get("pp", 1)
    if c.n_layers % pp != 0:
        raise ValueError(f"n_layers {c.n_layers} % pp {pp} != 0")
    tables = _RopeTables(c)

    def attend(xq, xk, xv):
        return attention(xq, xk, xv, causal=True, impl=attn_impl)

    def stage_fn(stage_layers, mx):
        cos, sin = tables[mx.device]
        for layer in _layers({"layers": stage_layers}):
            mx, _ = apply_block(layer, mx, c, cos, sin, None, attend)
        return mx

    plain = spmd.full_tree(params, dev0)
    x = F.embedding(inputs, plain["embed"]).to(c.dtype)      # (b, s, d)
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(
            f"batch {b} % microbatches {num_microbatches} != 0")
    micro = x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])
    stacked = {name: p.reshape(pp, c.n_layers // pp, *p.shape[1:])
               for name, p in plain["layers"].items()}
    y = gpipe(stage_fn, stacked, micro, mesh=mesh).full(dev0)
    x = rmsnorm(y.reshape(b, *y.shape[2:]), plain["norm_f"], c.norm_eps)
    logits = (x @ _head(plain, c).to(c.dtype)).float()
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten())


# ---------------------------------------------------------------- mesh
# The model over a mesh's cells (parallel/spmd.py): values are lists
# indexed by cell, each cell runs the single-device code on its share,
# and the collectives join the cells where XLA's partitioner would.

BATCH_AXES = ("dp", "fsdp")
# The slab: one a cell, split over KV heads (the reference's
# P(None, None, None, "tp", None) at engine.py:291).
KV_SPEC = spmd.P(None, None, None, "tp", None)

# The layout each stacked leaf takes in a cell's compute, per layer (the
# stacked axis dropped): heads and the MLP hidden over tp, experts over
# ep, the rest whole.
_CELL_LAYOUT = {"ln_attn": (None,), "ln_mlp": (None,),
                "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
                "wo": ("tp", None), "w_gate": (None, "tp"),
                "w_up": (None, "tp"), "w_down": ("tp", None)}
_MOE_CELL_LAYOUT = {"router": (None, "ep"), "w_gate": ("ep", None, "tp"),
                    "w_up": ("ep", None, "tp"), "w_down": ("ep", "tp", None)}


class _RopeTables(dict):
    """The rope tables of a config, made once per device."""

    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.c = c

    def __missing__(self, device):
        c = self.c
        self[device] = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                        torch.float32, device=device)
        return self[device]


class _Cells:
    """A parameter tree over a mesh's cells: each cell's share of a layer
    in the layout its compute takes, fetched when the layer runs (an
    fsdp-split leaf is gathered over fsdp then, as ZeRO-3 does), and the
    collectives of the embedding, the MLP and the head.

    Heads split over tp in storage as the spec says.  Where tp does not
    divide the KV heads, a cell gathers ``wk`` / ``wv`` whole and takes
    the KV heads its query heads read."""

    def __init__(self, params: dict, c: LlamaConfig, mesh):
        self.c, self.mesh = c, mesh
        self.devices = mesh.cell_devices
        self.tp = spmd.axis_size(mesh, "tp")
        self.ep = spmd.axis_size(mesh, "ep")
        if c.n_heads % self.tp:
            raise ValueError(f"tp {self.tp} does not divide n_heads "
                             f"{c.n_heads}")
        self.heads = c.n_heads // self.tp
        self.tp_index = [spmd.axis_index(mesh, cell, "tp")
                         for cell in range(mesh.size)]
        self.kv_split = c.n_kv_heads % self.tp == 0
        group = c.n_heads // c.n_kv_heads
        if self.kv_split:
            self.kv_heads = c.n_kv_heads // self.tp
        elif self.heads % group == 0 or group % self.heads == 0:
            self.kv_heads = max(self.heads // group, 1)
        else:
            raise ValueError(f"tp {self.tp}: a cell's {self.heads} query "
                             f"heads straddle KV heads of {group}")
        self.kv_first = [j * self.heads // group for j in self.tp_index]
        self.tables = _RopeTables(c)
        shardings = param_shardings(c, mesh)
        self.leaves = {name: spmd.on_mesh(leaf, shardings[name])
                       for name, leaf in params.items() if name != "layers"}
        layout = dict(_CELL_LAYOUT, **(_MOE_CELL_LAYOUT if c.num_experts
                                       else {}))
        if not self.kv_split:
            layout["wk"] = layout["wv"] = (None, None)
        self.stacked = {}
        for name, leaf in params["layers"].items():
            leaf = spmd.on_mesh(leaf, shardings["layers"][name])
            unbound: dict = {}
            per_cell = [unbound.setdefault(id(s), s.unbind(0))
                        for s in leaf.shards]
            self.stacked[name] = (per_cell, spmd.relayout_plan(
                mesh, tuple(leaf.spec[1:]), layout[name], leaf.shape[1:]))

    def layer(self, i: int) -> list[dict]:
        """Each cell's weights of layer ``i``."""
        out = [{} for _ in self.devices]
        hd = self.c.head_dim
        for name, (per_cell, fetch) in self.stacked.items():
            values = fetch([u[i] for u in per_cell])
            if name in ("wk", "wv") and not self.kv_split:
                values = [v[:, f * hd:(f + self.kv_heads) * hd]
                          for v, f in zip(values, self.kv_first)]
            for cell, v in enumerate(values):
                out[cell][name] = v
        return out

    def top(self, name: str, want) -> list:
        leaf = self.leaves[name]
        return spmd.relayout_plan(self.mesh, tuple(leaf.spec), want,
                                  leaf.shape)(leaf.shards)

    def embed(self, toks: list) -> list:
        """The embedding of each cell's tokens: a masked lookup in the
        cell's slice of the vocabulary, summed over tp."""
        c = self.c
        tables = self.top("embed", ("tp", None))
        if self.tp == 1:
            return [F.embedding(t, e).to(c.dtype)
                    for t, e in zip(toks, tables)]
        rows = c.vocab_size // self.tp
        parts = []
        for t, e, j in zip(toks, tables, self.tp_index):
            local = t - j * rows
            inside = (local >= 0) & (local < rows)
            parts.append(F.embedding(local.clamp(0, rows - 1), e)
                         * inside[..., None].to(e.dtype))
        return [x.to(c.dtype) for x in spmd.psum(parts, self.mesh, "tp")]

    def logits(self, xs: list) -> list:
        """fp32 logits of each cell's normed activations: the cell's
        slice of the vocabulary, gathered over tp."""
        c = self.c
        if c.tie_embeddings:
            heads = [e.T for e in self.top("embed", ("tp", None))]
        else:
            heads = self.top("lm_head", (None, "tp"))
        local = [(x @ h.to(c.dtype)).float() for x, h in zip(xs, heads)]
        return spmd.all_gather(local, self.mesh, "tp", dim=-1)

    def mlp(self, lay: list, hs: list) -> list:
        """The MLP half's output of each cell's normed input: partial
        products summed over tp (and ep).  The MoE router's logits are
        gathered over ep before top_k."""
        c, mesh = self.c, self.mesh
        if not c.num_experts:
            return spmd.psum([_mlp(w, h, c) for w, h in zip(lay, hs)],
                             mesh, "tp")
        router = spmd.all_gather([h @ w["router"] for w, h in zip(lay, hs)],
                                 mesh, "ep", dim=-1)
        per = c.num_experts // self.ep
        parts = []
        for cell, (w, h) in enumerate(zip(lay, hs)):
            e0 = spmd.axis_index(mesh, cell, "ep") * per
            weights = _moe_weights(router[cell], c, h.dtype)
            parts.append(_moe_experts(w, h, weights[..., e0:e0 + per]))
        return spmd.psum(parts, mesh, ("ep", "tp"))

    def residual(self, xs: list, parts: list) -> list:
        return [x + p.to(x.dtype) for x, p in zip(xs, parts)]


def _sharded_forward(params, tokens, c: LlamaConfig, mesh, *, attn_impl,
                     positions, return_kv, logits_at, remat):
    if spmd.axis_size(mesh, "pp") > 1:
        raise ValueError("a mesh with pp > 1 runs loss_fn_pp")
    cells = _Cells(params, c, mesh)
    if return_kv and not cells.kv_split:
        raise ValueError(f"return_kv needs tp {cells.tp} to divide "
                         f"n_kv_heads {c.n_kv_heads}")
    spec = spmd.P(BATCH_AXES, "sp")
    tokens = spmd.as_global(tokens)
    toks = spmd.split(tokens, spec, mesh)
    b_l, s_l = toks[0].shape
    sp = spmd.axis_size(mesh, "sp")
    if positions is not None:
        pos = spmd.split(spmd.as_global(positions), spec, mesh)
    elif sp > 1:
        pos = [(spmd.axis_index(mesh, cell, "sp") * s_l
                + torch.arange(s_l, device=dev)).expand(b_l, s_l)
               for cell, dev in enumerate(cells.devices)]
    else:
        pos = [None] * mesh.size

    def attend(qkv):
        if sp == 1:
            return [attention(q, k, v, causal=True, impl=attn_impl)
                    for q, k, v in qkv]
        out = [None] * mesh.size
        for group in spmd.groups(mesh, "sp"):
            got = ring_attention_kernel(*([qkv[cell][n] for cell in group]
                                          for n in range(3)), causal=True)
            for cell, o in zip(group, got):
                out[cell] = o
        return out

    def block(i, xs):
        lay = cells.layer(i)
        qkv = []
        for cell, (x, w) in enumerate(zip(xs, lay)):
            cos, sin = cells.tables[cells.devices[cell]]
            h = rmsnorm(x, w["ln_attn"], c.norm_eps)
            qkv.append(attention_qkv(w, h, c, cos, sin, pos[cell],
                                     cells.heads, cells.kv_heads))
        parts = [a.reshape(b_l, s_l, -1) @ w["wo"]
                 for a, w in zip(attend(qkv), lay)]
        xs = cells.residual(xs, spmd.psum(parts, mesh, "tp"))
        hs = [rmsnorm(x, w["ln_mlp"], c.norm_eps) for x, w in zip(xs, lay)]
        xs = cells.residual(xs, cells.mlp(lay, hs))
        kv = ([(k.to(c.dtype), v.to(c.dtype)) for _q, k, v in qkv]
              if return_kv else None)
        return xs, kv

    run = _remat(block, remat)
    xs = cells.embed(toks)
    kvs = []
    for i in range(c.n_layers):
        xs, kv = run(i, xs)
        kvs.append(kv)
    xs = [rmsnorm(x, w, c.norm_eps)
          for x, w in zip(xs, cells.top("norm_f", (None,)))]
    batch, seq = tokens.shape
    if logits_at is not None:
        owner, local = divmod(int(logits_at), s_l)
        xs = spmd.broadcast([x[:, local] for x in xs], mesh, "sp", owner)
        out_spec, shape = spmd.P(BATCH_AXES, None), (batch, c.vocab_size)
    else:
        out_spec = spmd.P(BATCH_AXES, "sp", None)
        shape = (batch, seq, c.vocab_size)
    logits = spmd.ShardedTensor(cells.logits(xs),
                                spmd.NamedSharding(mesh, out_spec), shape)
    if not return_kv:
        return logits
    kv_sharding = spmd.NamedSharding(
        mesh, spmd.P(None, BATCH_AXES, "sp", "tp", None))
    kv_shape = (c.n_layers, batch, seq, c.n_kv_heads, c.head_dim)
    ks, vs = ([torch.stack([kv[cell][n] for kv in kvs])
               for cell in range(mesh.size)] for n in (0, 1))
    return (logits, spmd.ShardedTensor(ks, kv_sharding, kv_shape),
            spmd.ShardedTensor(vs, kv_sharding, kv_shape))


def flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token (6·N matmul + attention quadratic term)."""
    c = config
    matmul = 6 * c.num_params()
    attn = 12 * c.n_layers * c.head_dim * c.n_heads * seq_len
    return matmul + attn


# ------------------------------------------------------------- kv cache
# Dense per-slot KV slabs, as in the reference.  On a mesh (ShardedTensor
# parameters) the slabs are split over KV heads along tp, one slab a cell
# on the cell's device, each updated in place by its cell; "length" is a
# plain tensor on the mesh's first cell's device.

def init_kv_cache(config: LlamaConfig, slots: int,
                  max_seq: int | None = None, *, device=None,
                  mesh=None) -> dict:
    """Per-slot dense KV slabs: (layers, slots, max_seq, kv_heads, hd);
    with ``mesh``, ShardedTensors laid out by ``KV_SPEC``."""
    c = config
    ms = max_seq or c.max_seq
    shape = (c.n_layers, slots, ms, c.n_kv_heads, c.head_dim)
    if mesh is None:
        device = resolve_device(device)
        slab = functools.partial(torch.zeros, shape, dtype=c.dtype,
                                 device=device)
    else:
        device = mesh.cell_devices[0]
        tp = spmd.axis_size(mesh, "tp")
        if c.n_kv_heads % tp:
            raise ValueError(f"tp {tp} must divide n_kv_heads "
                             f"{c.n_kv_heads} to split the slab")
        local = shape[:3] + (c.n_kv_heads // tp, c.head_dim)

        def slab():
            return spmd.ShardedTensor(
                [torch.zeros(local, dtype=c.dtype, device=dev)
                 for dev in mesh.cell_devices],
                spmd.NamedSharding(mesh, KV_SPEC), shape)
    return {
        "k": slab(),
        "v": slab(),
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
    and the call returns once they are there.  From a sharded cache the
    cells' KV heads are gathered layer by layer on the mesh's first cell
    into one global slot."""
    if isinstance(cache["k"], spmd.ShardedTensor):
        return _extract_sharded(cache, slot)
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


def _extract_sharded(cache: dict, slot: int):
    k_st, v_st = cache["k"], cache["v"]
    mesh = k_st.mesh
    dev0 = mesh.cell_devices[0]
    members = spmd.groups(mesh, "tp")[0]     # one cell per head block
    n_layers, _slots, max_seq, kv_heads, hd = k_st.shape
    pin = dev0.type == "cuda"
    out = []
    for st in (k_st, v_st):
        host = torch.empty((n_layers, max_seq, kv_heads, hd),
                           dtype=st.dtype, pin_memory=pin)
        for i in range(n_layers):
            host[i].copy_(torch.cat([st.shards[cell][i, slot].to(dev0)
                                     for cell in members], dim=1),
                          non_blocking=pin)
        out.append(host)
    if pin:
        torch.cuda.current_stream(dev0).synchronize()
    return out[0], out[1], int(cache["length"][slot])


def install_slot(cache: dict, k, v, length: int, slot: int):
    """Write a slab from ``extract_slot`` into ``slot``; returns the
    cache.  The copies are queued on the current stream, so they land
    before any later work on it (the next decode or prefill).  From
    pinned memory the host does not wait for them; from pageable memory
    each copy blocks the host for its transfer.  Into a sharded cache
    each layer goes to the mesh's first cell, and each cell copies its
    KV heads from there."""
    if isinstance(cache["k"], spmd.ShardedTensor):
        mesh = cache["k"].mesh
        dev0 = mesh.cell_devices[0]
        for host, st in ((k, cache["k"]), (v, cache["v"])):
            local = st.shards[0].shape[3]
            for i in range(host.shape[0]):
                staged = host[i].to(dev0, non_blocking=True)
                for cell, dst in enumerate(st.shards):
                    j = spmd.axis_index(mesh, cell, "tp")
                    dst[i, slot].copy_(staged[:, j * local:(j + 1) * local],
                                       non_blocking=True)
    else:
        dst_k, dst_v = cache["k"][:, slot], cache["v"][:, slot]
        for i in range(dst_k.shape[0]):
            dst_k[i].copy_(k[i], non_blocking=True)
            dst_v[i].copy_(v[i], non_blocking=True)
    # fill_ with a Python number is a kernel: no host-to-device copy of
    # the value, which from pageable memory would wait for the stream.
    cache["length"][slot].fill_(int(length))
    return cache


def prefill_into_cache(params: dict, tokens, cache: dict, slot: int,
                       length: int, config: LlamaConfig, *, mesh=None,
                       attn_impl: str = "auto"):
    """Run prefill on one padded prompt (1, s) and write its K/V into
    ``slot``; returns (last-token logits (vocab,), cache).

    As in the reference, the whole padded bucket's K/V goes into the
    slab, pad positions included: decode masks them by length and later
    overwrites them.  On a mesh (``mesh`` or ShardedTensor parameters)
    the prompt runs through the sharded forward, each cell writes its KV
    heads into its own slab, and the logits come back on the mesh's
    first cell's device."""
    seq = tokens.shape[1]
    if seq > cache["k"].shape[2]:
        raise ValueError(f"prompt bucket {seq} exceeds the slab's "
                         f"{cache['k'].shape[2]} positions")
    last_pos = max(int(length) - 1, 0)
    mesh = mesh if mesh is not None else spmd.mesh_of(params)
    logits, ks, vs = forward(params, tokens, config, mesh=mesh,
                             attn_impl=attn_impl, return_kv=True,
                             logits_at=last_pos)
    if mesh is None:
        cache["k"][:, slot, :seq] = ks[:, 0]
        cache["v"][:, slot, :seq] = vs[:, 0]
    else:
        for new, st in ((ks, cache["k"]), (vs, cache["v"])):
            new = spmd.shard(new, spmd.NamedSharding(st.mesh, KV_SPEC))
            for dst, src in zip(st.shards, new.shards):
                dst[:, slot, :seq] = src[:, 0]
        logits = logits.full()
    cache["length"][slot] = int(length)
    return logits[0], cache


def _chunk_attention(layer: dict, x, ck, cv, st: dict, c: LlamaConfig,
                     n_heads: int, n_kv_heads: int):
    """One layer's attention half for a prompt chunk against one slot's
    slab (``ck``/``cv``: (max_seq, kv_heads, hd), written here): its
    output product, not yet added to ``x``."""
    chunk = x.shape[0]
    h = rmsnorm(x, layer["ln_attn"], c.norm_eps)
    xq = (h @ layer["wq"]).reshape(chunk, n_heads, c.head_dim)
    xk = (h @ layer["wk"]).reshape(chunk, n_kv_heads, c.head_dim)
    xv = (h @ layer["wv"]).reshape(chunk, n_kv_heads, c.head_dim)
    xq = rope_one(xq, st["pc"], st["ps"])
    xk = rope_one(xk, st["pc"], st["ps"])
    start, n_write, t_max = st["start"], st["n_write"], st["t_max"]
    ck[start:start + n_write] = xk[:n_write].to(ck.dtype)
    cv[start:start + n_write] = xv[:n_write].to(cv.dtype)
    q = xq.reshape(chunk, n_kv_heads, n_heads // n_kv_heads,
                   c.head_dim).float()
    scores = torch.einsum("ckgd,tkd->ckgt", q, ck[:t_max].float())
    scores = scores / math.sqrt(c.head_dim)
    scores = scores.masked_fill(~st["valid"][:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("ckgt,tkd->ckgd", probs.to(ck.dtype).float(),
                       cv[:t_max].float())
    out = out.reshape(chunk, n_heads * c.head_dim).to(x.dtype)
    return out @ layer["wo"]


def _chunk_state(c: LlamaConfig, cos, sin, start: int, chunk: int,
                 chunk_len: int, max_seq: int, device) -> dict:
    pos = start + torch.arange(chunk, device=device)         # absolute
    # JAX clamps the gather; torch would raise: clamp the rope positions
    # (pad rows only — their values never reach the slab or the logits).
    rope_pos = pos.clamp(max=c.max_seq - 1)
    t_max = min(start + chunk, max_seq)
    return {"pc": cos[rope_pos][:, None, :],                # (chunk, 1, hd/2)
            "ps": sin[rope_pos][:, None, :], "start": start,
            "n_write": max(0, min(chunk_len, max_seq - start)),
            "t_max": t_max,
            "valid": torch.arange(t_max, device=device)[None, :]
            <= pos[:, None]}


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
    With ShardedTensor parameters, every cell runs its heads against its
    own slab (the mesh is read from the parameters, as the reference
    partitions by placement).

    Returns (logits (vocab,) fp32 at the chunk's last real token, cache
    with slot length set to ``start + chunk_len``)."""
    c = config
    slot, start, chunk_len = int(slot), int(start), int(chunk_len)
    chunk = tokens.shape[0]
    max_seq = cache["k"].shape[2]
    mesh = spmd.mesh_of(params)
    if mesh is not None:
        logits = _sharded_serve(params, tokens[None], cache, c, mesh,
                                _chunk_attention, lambda dev, cos, sin:
                                _chunk_state(c, cos, sin, start, chunk,
                                             chunk_len, max_seq, dev),
                                lambda ks, i: ks[i, slot],
                                last=max(chunk_len - 1, 0))
        cache["length"][slot] = start + chunk_len
        return logits[0], cache
    device = tokens.device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                torch.float32, device=device)
    st = _chunk_state(c, cos, sin, start, chunk, chunk_len, max_seq, device)
    x = params["embed"][tokens].to(c.dtype)                  # (chunk, dim)
    for i, layer in enumerate(_layers(params)):
        x = x + _chunk_attention(
            layer, x, cache["k"][i, slot], cache["v"][i, slot], st, c,
            c.n_heads, c.n_kv_heads).to(x.dtype)
        x = x + mlp_half(layer, x[None], c)[0].to(x.dtype)
    x = rmsnorm(x, params["norm_f"], c.norm_eps)
    x_last = x[max(chunk_len - 1, 0)]
    logits = (x_last @ _head(params, c).to(c.dtype)).float()
    cache["length"][slot] = start + chunk_len
    return logits, cache


def _decode_attention(layer: dict, x, ck, cv, st: dict, c: LlamaConfig,
                      n_heads: int, n_kv_heads: int):
    """One layer's attention half of a decode step against the slabs
    (``ck``/``cv``: (slots, max_seq, kv_heads, hd), written here): its
    output product, not yet added to ``x``."""
    slots = x.shape[0]
    h = rmsnorm(x, layer["ln_attn"], c.norm_eps)
    xq = (h @ layer["wq"]).reshape(slots, n_heads, c.head_dim)
    xk = (h @ layer["wk"]).reshape(slots, n_kv_heads, c.head_dim)
    xv = (h @ layer["wv"]).reshape(slots, n_kv_heads, c.head_dim)
    xq = rope_one(xq, st["pc"], st["ps"])
    xk = rope_one(xk, st["pc"], st["ps"])
    rows, write_pos, keep = st["rows"], st["write_pos"], st["keep"]
    ck[rows, write_pos] = torch.where(keep, xk.to(ck.dtype),
                                      ck[rows, write_pos])
    cv[rows, write_pos] = torch.where(keep, xv.to(cv.dtype),
                                      cv[rows, write_pos])
    q = xq.reshape(slots, n_kv_heads, n_heads // n_kv_heads,
                   c.head_dim).float()
    scores = torch.einsum("skgd,stkd->skgt", q, ck.float())
    scores = scores / math.sqrt(c.head_dim)
    scores = scores.masked_fill(~st["valid"][:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("skgt,stkd->skgd", probs.to(ck.dtype).float(),
                       cv.float())
    out = out.reshape(slots, n_heads * c.head_dim).to(x.dtype)
    return out @ layer["wo"]


def _decode_state(c: LlamaConfig, cos, sin, pos, active, max_seq: int
                  ) -> dict:
    """``pos``: (slots,) write positions on the step's device."""
    # The reference writes inactive slots (and slots already at max_seq)
    # at position max_seq, a scatter JAX drops.  Here every slot writes
    # at a clamped position, and a slot that must not write writes back
    # the value already there: no out-of-bounds index, no duplicate.
    write = pos < max_seq
    if active is not None:
        write = write & active
    # JAX clamps cos[pos] for a slot at the end of the table; clamp here.
    rope_pos = pos.clamp(max=c.max_seq - 1)
    # Attention runs over the whole slab, masked per slot, as in the
    # reference.  Cutting it at the batch's longest position would move
    # fewer bytes, but each slot's softmax and P.V would then reduce over
    # a length set by the other slots, and round with it: on an H100 a
    # session's greedy tokens then changed with the requests that shared
    # its decode steps.  Over the whole slab every shape is fixed.
    return {"pc": cos[rope_pos][:, None, :],                # (slots, 1, hd/2)
            "ps": sin[rope_pos][:, None, :],
            "rows": torch.arange(pos.shape[0], device=pos.device),
            "write_pos": pos.clamp(max=max_seq - 1),
            "keep": write[:, None, None],
            "valid": torch.arange(max_seq, device=pos.device)[None, :]
            <= pos[:, None]}


def decode_step(params: dict, last_tokens, cache: dict,
                config: LlamaConfig, active=None):
    """One token for every slot, attending against the KV cache.

    last_tokens: (slots,) integer — the most recent token per slot.
    ``active`` ((slots,) bool, optional): slots marked False neither
    write K/V nor advance their length, so their slab bytes stay
    unchanged.  ``active=None`` steps every slot.  With ShardedTensor
    parameters, every cell runs its heads against its own slabs (the
    mesh is read from the parameters, as the reference partitions by
    placement) and the logits come back on the mesh's first cell's
    device.
    Returns (logits (slots, vocab) fp32, cache with +1 lengths)."""
    c = config
    max_seq = cache["k"].shape[2]
    pos = cache["length"]                       # (slots,) write position
    mesh = spmd.mesh_of(params)
    if mesh is not None:
        logits = _sharded_serve(
            params, last_tokens[:, None], cache, c, mesh, _decode_attention,
            lambda dev, cos, sin: _decode_state(
                c, cos, sin, pos.to(dev),
                None if active is None else active.to(dev), max_seq),
            lambda ks, i: ks[i])
    else:
        cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                    torch.float32, device=last_tokens.device)
        st = _decode_state(c, cos, sin, pos, active, max_seq)
        x = params["embed"][last_tokens].to(c.dtype)   # (slots, dim)
        for i, layer in enumerate(_layers(params)):
            x = x + _decode_attention(layer, x, cache["k"][i],
                                      cache["v"][i], st, c, c.n_heads,
                                      c.n_kv_heads).to(x.dtype)
            x = x + mlp_half(layer, x[None], c)[0].to(x.dtype)
        x = rmsnorm(x, params["norm_f"], c.norm_eps)
        logits = (x @ _head(params, c).to(c.dtype)).float()
    # Idle slots keep stepping and are clamped at the slab's end; with an
    # ``active`` mask, inactive slots' lengths hold still.
    new_len = torch.clamp(pos + 1, max=max_seq)
    if active is not None:
        new_len = torch.where(active, new_len, pos)
    cache["length"] = new_len
    return logits, cache


def _sharded_serve(params, tokens, cache, c: LlamaConfig, mesh, attend,
                   state, slab_of, last=None):
    """The serving step of decode and chunked prefill over a mesh: each
    cell runs ``attend`` (``_decode_attention`` / ``_chunk_attention``)
    with its heads against ``slab_of(its slab shard, layer)``, under the
    per-device ``state(device, cos, sin)``; the partial products are
    summed over tp.  ``tokens`` (b, s) on any device; returns fp32
    logits of the rows of ``tokens`` (of position ``last`` of its one
    row) on the mesh's first cell's device."""
    cells = _Cells(params, c, mesh)
    if not cells.kv_split:
        raise ValueError(f"tp {cells.tp} must divide n_kv_heads "
                         f"{c.n_kv_heads} to split the slab")
    states = {dev: state(dev, *cells.tables[dev]) for dev in mesh.device_set}
    xs = cells.embed([tokens.to(dev) for dev in cells.devices])
    xs = [x[0] if last is not None else x[:, 0] for x in xs]
    for i in range(c.n_layers):
        lay = cells.layer(i)
        parts = [attend(w, x, slab_of(ks, i), slab_of(vs, i),
                        states[dev], c, cells.heads, cells.kv_heads)
                 for w, x, ks, vs, dev in zip(lay, xs, cache["k"].shards,
                                              cache["v"].shards,
                                              cells.devices)]
        xs = cells.residual(xs, spmd.psum(parts, mesh, "tp"))
        hs = [rmsnorm(x, w["ln_mlp"], c.norm_eps)[None]
              for x, w in zip(xs, lay)]
        xs = cells.residual(xs, [m[0] for m in cells.mlp(lay, hs)])
    xs = [rmsnorm(x, w, c.norm_eps)
          for x, w in zip(xs, cells.top("norm_f", (None,)))]
    if last is not None:
        xs = [x[last][None] for x in xs]
    return cells.logits(xs)[0]


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
