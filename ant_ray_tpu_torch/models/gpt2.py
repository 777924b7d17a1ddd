"""GPT-2 model family — ant_ray_tpu/models/gpt2.py in PyTorch: config,
init, ``forward``, ``loss_fn``, HF weight loading and the FLOP count.

Architecture (GPT-2): learned positional embeddings, pre-LayerNorm
blocks, fused-qkv multi-head attention, tanh GELU MLP (4x), LM head
tied to the token embedding.  Parameters are a plain dict of tensors
with the reference's leaf names and its stacked ``(n_layers, in, out)``
layout (HF's Conv1D orientation), so ``h @ W`` reads as it does there
and models/convert.py carries weights across leaf by leaf.  Layers run
as a Python loop over the stacked leading axis, each under
non-reentrant ``torch.utils.checkpoint`` when autograd records, as the
reference runs each under ``jax.checkpoint`` inside ``lax.scan``.

The reference's sharding rules (``param_logical_dims``, ``gpt2_rules``,
``param_shardings``) are not here: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.models.llama import _layers, init_leaves
from ant_ray_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class Gpt2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def mlp_dim(self) -> int:
        return 4 * self.dim

    def num_params(self) -> int:
        per_layer = (12 * self.dim * self.dim  # qkv + proj + mlp
                     + 13 * self.dim)          # biases + LN params
        return (self.vocab_size * self.dim + self.n_positions * self.dim
                + self.n_layers * per_layer + 2 * self.dim)


CONFIGS: dict[str, Gpt2Config] = {
    "gpt2": Gpt2Config(),
    "gpt2-medium": Gpt2Config(dim=1024, n_layers=24, n_heads=16),
    "gpt2-large": Gpt2Config(dim=1280, n_layers=36, n_heads=20),
    "tiny": Gpt2Config(vocab_size=257, n_positions=128, dim=64,
                       n_layers=2, n_heads=4),
}


def param_shapes(config: Gpt2Config) -> dict:
    d, n = config.dim, config.n_layers
    return {
        "wte": (config.vocab_size, d),
        "wpe": (config.n_positions, d),
        "layers": {
            # stacked on the leading axis, one slice per layer
            "ln1_g": (n, d), "ln1_b": (n, d),
            "qkv_w": (n, d, 3 * d), "qkv_b": (n, 3 * d),
            "proj_w": (n, d, d), "proj_b": (n, d),
            "ln2_g": (n, d), "ln2_b": (n, d),
            "fc_w": (n, d, config.mlp_dim), "fc_b": (n, config.mlp_dim),
            "out_w": (n, config.mlp_dim, d), "out_b": (n, d),
        },
        "lnf_g": (d,), "lnf_b": (d,),
    }


def init_params(config: Gpt2Config, *,
                generator: torch.Generator | None = None,
                device=None) -> dict:
    """GPT-2 init, made directly on ``device`` in the config dtype:
    N(0, 0.02) weights, zero biases, unit LayerNorm gains (drawn as
    ``llama.init_leaves`` draws).  ``generator`` must live on
    ``device``; None means one seeded with 0."""

    def constant(name):
        if name.endswith("_b"):
            return 0.0
        return 1.0 if name.endswith("_g") else None

    return init_leaves(param_shapes(config), config.dtype, constant,
                       generator=generator, device=device)


def _layernorm(x, g, b, eps):
    """The reference's LayerNorm with its rounding points: ``jnp.mean``
    and ``jnp.var`` of a bf16 ``x`` accumulate in fp32 (the variance
    around the fp32 mean) and round each result to bf16 once; the rest
    is elementwise in x's dtype.  In fp32 nothing rounds in between."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
    var = xf.var(dim=-1, keepdim=True, correction=0).to(x.dtype)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def _block(layer: dict, x, config: Gpt2Config, attn_impl: str):
    batch, seq, dim = x.shape
    heads, hd = config.n_heads, config.head_dim
    h = _layernorm(x, layer["ln1_g"], layer["ln1_b"], config.norm_eps)
    qkv = h @ layer["qkv_w"] + layer["qkv_b"]
    q, k, v = (t.reshape(batch, seq, heads, hd)
               for t in qkv.split(dim, dim=-1))
    att = attention(q, k, v, causal=True, impl=attn_impl)
    x = x + att.reshape(batch, seq, dim) @ layer["proj_w"] + layer["proj_b"]
    h = _layernorm(x, layer["ln2_g"], layer["ln2_b"], config.norm_eps)
    # GPT-2 uses the tanh GELU approximation (HF "gelu_new").
    h = F.gelu(h @ layer["fc_w"] + layer["fc_b"], approximate="tanh")
    return x + h @ layer["out_w"] + layer["out_b"]


def forward(params: dict, tokens, config: Gpt2Config, *,
            attn_impl: str = "auto"):
    """Logits (batch, seq, vocab) in the config dtype for a (batch, seq)
    integer token batch.  ``attn_impl`` as for
    :func:`~ant_ray_tpu_torch.ops.attention.attention` ("auto": the flash
    kernels on the card when the lengths tile, blockwise otherwise).

    Every block is checkpointed when autograd records the forward (the
    backward re-runs it, the flash forward included), as the reference
    checkpoints every block: GPT-2 has no remat option there either."""
    seq = tokens.shape[1]
    # F.embedding, not indexing: on the CPU its backward sums each row's
    # gradients in an order that does not depend on the thread count.
    x = F.embedding(tokens, params["wte"]) + params["wpe"][:seq]
    run_block = _block
    if torch.is_grad_enabled():
        run_block = functools.partial(checkpoint, _block, use_reentrant=False)
    for layer in _layers(params):
        x = run_block(layer, x, config, attn_impl)
    x = _layernorm(x, params["lnf_g"], params["lnf_b"], config.norm_eps)
    return x @ params["wte"].T          # tied LM head


def loss_fn(params: dict, batch: dict, config: Gpt2Config, *,
            attn_impl: str = "auto"):
    """Next-token loss, log-softmax in fp32; the same batch contract as
    ``llama.loss_fn``: an optional ``mask`` (batch, seq + 1) excludes
    padding positions."""
    tokens = batch["tokens"]
    logits = forward(params, tokens[:, :-1], config, attn_impl=attn_impl)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:].to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()


def from_hf_state_dict(state: dict, config: Gpt2Config, *,
                       device=None) -> dict:
    """Convert a HuggingFace ``GPT2LMHeadModel.state_dict()`` (torch
    tensors or numpy arrays) to this module's parameter dict on
    ``device``, in the config dtype.  HF's Conv1D stores weights as
    (in_features, out_features), the orientation this model multiplies
    with, so weights pass through unchanged; only the per-layer tensors
    are stacked on the leading layer axis."""
    device = resolve_device(device)

    def _tensor(t):
        t = t.detach() if isinstance(t, torch.Tensor) else \
            torch.from_numpy(np.asarray(t))
        return t.to(device=device, dtype=config.dtype, copy=True)

    def stack(fmt):
        return torch.stack([_tensor(state[fmt.format(i)])
                            for i in range(config.n_layers)])

    hf = "transformer.h.{}."
    return {
        "wte": _tensor(state["transformer.wte.weight"]),
        "wpe": _tensor(state["transformer.wpe.weight"]),
        "layers": {
            "ln1_g": stack(hf + "ln_1.weight"),
            "ln1_b": stack(hf + "ln_1.bias"),
            "qkv_w": stack(hf + "attn.c_attn.weight"),
            "qkv_b": stack(hf + "attn.c_attn.bias"),
            "proj_w": stack(hf + "attn.c_proj.weight"),
            "proj_b": stack(hf + "attn.c_proj.bias"),
            "fc_w": stack(hf + "mlp.c_fc.weight"),
            "fc_b": stack(hf + "mlp.c_fc.bias"),
            "out_w": stack(hf + "mlp.c_proj.weight"),
            "out_b": stack(hf + "mlp.c_proj.bias"),
            "ln2_g": stack(hf + "ln_2.weight"),
            "ln2_b": stack(hf + "ln_2.bias"),
        },
        "lnf_g": _tensor(state["transformer.ln_f.weight"]),
        "lnf_b": _tensor(state["transformer.ln_f.bias"]),
    }


def flops_per_token(config: Gpt2Config, seq_len: int) -> float:
    """6*N matmul FLOPs + attention term (same accounting as
    ``llama.flops_per_token``)."""
    n = config.num_params()
    attn = 12 * config.n_layers * config.dim * seq_len
    return 6.0 * n + attn
