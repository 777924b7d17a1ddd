"""GPT-2 in plain fp32 PyTorch, with its training step: the reference of
the training cells.

It follows the published GPT-2 (Hugging Face's ``GPT2LMHeadModel``
without dropout, which the port does not have): learned positions,
pre-LayerNorm blocks, fused qkv, causal softmax attention, tanh GELU
MLP, head tied to the token embedding; next-token cross entropy
averaged over every target.  AdamW is written out here (decoupled
weight decay on every leaf, bias-corrected moments in fp32).  No
kernel, no remat: the batch runs row by row, gradients summed, so a
1.5B model fits; matmuls run with TF32 off.

The control computes the same in fp8: every matmul's operands rounded
to ``float8_e4m3fn`` in the forward (one scale a weight tensor, one a
row of activations), gradients passing straight through.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.mistral import fp8, full_fp32


def _ste_fp8(x, dim=None):
    return x + (fp8(x.detach(), dim) - x).detach()


def _layernorm(x, g, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def loss_sum(p: dict, tokens: torch.Tensor, cfg: dict,
             control: bool = False) -> torch.Tensor:
    """Summed next-token negative log-likelihood of ``tokens`` (rows,
    seq + 1)."""
    heads, eps = cfg["n_head"], cfg["layer_norm_epsilon"]

    def mm(a, w):
        return _ste_fp8(a, -1) @ _ste_fp8(w) if control else a @ w

    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    rows, n = inputs.shape
    d = p["wte"].shape[1]
    hd = d // heads
    x = p["wte"][inputs] + p["wpe"][:n]
    causal = torch.ones(n, n, dtype=torch.bool, device=tokens.device).tril()
    for i in range(cfg["n_layer"]):
        h = _layernorm(x, p["ln1_g"][i], p["ln1_b"][i], eps)
        qkv = mm(h, p["qkv_w"][i]) + p["qkv_b"][i]
        q, k, v = (t.reshape(rows, n, heads, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        s = q @ k.transpose(-1, -2) / math.sqrt(hd)
        att = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
        att = att.transpose(1, 2).reshape(rows, n, d)
        x = x + mm(att, p["proj_w"][i]) + p["proj_b"][i]
        h = _layernorm(x, p["ln2_g"][i], p["ln2_b"][i], eps)
        h = F.gelu(mm(h, p["fc_w"][i]) + p["fc_b"][i], approximate="tanh")
        x = x + mm(h, p["out_w"][i]) + p["out_b"][i]
    x = _layernorm(x, p["lnf_g"], p["lnf_b"], eps)
    logp = torch.log_softmax(mm(x, p["wte"].T), dim=-1)
    return -logp.gather(-1, targets[..., None]).sum()


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(flat(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = leaf
    return out


def train(w0: dict, cfg: dict, batches, lr: float, weight_decay: float,
          betas=(0.9, 0.999), eps: float = 1e-8, control: bool = False,
          rows_per_pass: int = 1) -> dict:
    """``len(batches)`` AdamW steps from ``w0`` (any dtype; computed in
    fp32).  Returns each step's mean loss, each leaf's gradient norm at
    step 1 and each leaf's change after the last step."""
    start = {n: t.detach().float() for n, t in flat(w0).items()}
    p = {n: t.clone().requires_grad_() for n, t in start.items()}
    nested = {n: t for n, t in p.items() if "." not in n}
    nested_layers = {n.split(".", 1)[1]: t for n, t in p.items()
                     if n.startswith("layers.")}
    tree = dict(nested, **nested_layers)
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grad_norms = [], None
    with full_fp32():
        for step, tokens in enumerate(batches, start=1):
            count = tokens.shape[0] * (tokens.shape[1] - 1)
            total = 0.0
            for r in range(0, tokens.shape[0], rows_per_pass):
                loss = loss_sum(tree, tokens[r:r + rows_per_pass], cfg,
                                control) / count
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                if grad_norms is None:
                    grad_norms = {n: float(t.grad.norm())
                                  for n, t in p.items()}
                b1, b2 = betas
                for n, t in p.items():
                    g = t.grad
                    t.mul_(1 - lr * weight_decay)
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n] / (1 - b2 ** step)).sqrt_().add_(eps)
                    t.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** step))
                    t.grad = None
    with torch.no_grad():
        change = {n: float((t - start[n]).norm()) for n, t in p.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
