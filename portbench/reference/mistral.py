"""A Mistral-layout decoder in plain fp32 PyTorch: the reference of the
serving cells.

It follows the published description (Hugging Face's
``MistralForCausalLM``, no sliding window): token embedding, per layer
RMSNorm, grouped-query attention with rotary embeddings in the
rotate-half layout, RMSNorm, SwiGLU MLP; a final RMSNorm and the head.
No cache, no batching, no kernel: each sequence runs whole, layer by
layer, each layer's weights cast to fp32 as it runs, so a 7B fits
beside the slab the program left behind.  Matmuls run with TF32 off.

The control computes the same in fp8: every matmul's weight rounded to
``float8_e4m3fn`` with one scale a tensor and its input with one scale a
row, as a tempting "fp8 serving" change would.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn under an amax scale (over the
    whole tensor, or over ``dim``), back in fp32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def full_fp32():
    """Matmuls and convolutions in true fp32 (TF32 off) for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits(weights: dict, cfg: dict, tokens: torch.Tensor, first: int,
           control: bool = False) -> torch.Tensor:
    """fp32 logits (len(tokens) - first, vocab) at positions first.. of
    one sequence (1-D token ids on the weights' device)."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    kv_heads, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    n = tokens.shape[0]
    dev = tokens.device

    def mm(a, w):
        if control:
            return fp8(a, dim=-1) @ fp8(w)
        return a @ w

    inv = 1.0 / cfg["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float64, device=dev) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=dev)[:, None] * inv
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    x = weights["embed"][tokens].float()
    layers = weights["layers"]
    with full_fp32():
        for i in range(cfg["num_hidden_layers"]):
            w = {name: leaf[i].float() for name, leaf in layers.items()}
            h = _rmsnorm(x, w["ln_attn"], eps)
            q = _rope(mm(h, w["wq"]).view(n, heads, hd), cos, sin)
            k = _rope(mm(h, w["wk"]).view(n, kv_heads, hd), cos, sin)
            v = mm(h, w["wv"]).view(n, kv_heads, hd)
            k = k.repeat_interleave(heads // kv_heads, dim=1)
            v = v.repeat_interleave(heads // kv_heads, dim=1)
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
            p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            del s
            att = torch.einsum("hqk,khd->qhd", p, v).reshape(n, heads * hd)
            del p
            x = x + mm(att, w["wo"])
            h = _rmsnorm(x, w["ln_mlp"], eps)
            x = x + mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]),
                       w["w_down"])
            del w
        x = _rmsnorm(x[first:], weights["norm_f"].float(), eps)
        head = weights.get("lm_head")
        head = weights["embed"].T if head is None else head
        return mm(x, head.float())


def served_gaps(weights: dict, cfg: dict, prompt, served,
                control: bool = False) -> torch.Tensor:
    """For each served token, how far its reference logit lies below the
    reference's best at that position.  With ``control``, the same for
    the token the fp8 control puts first instead (the served tokens
    still drive the positions)."""
    dev = weights["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    ref = logits(weights, cfg, seq, len(prompt) - 1)
    if control:
        pick = logits(weights, cfg, seq, len(prompt) - 1,
                      control=True).argmax(-1)
    else:
        pick = torch.as_tensor(list(served), device=dev)
    best = ref.max(-1).values
    return best - ref.gather(1, pick[:, None])[:, 0]
