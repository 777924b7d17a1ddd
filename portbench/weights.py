"""The weights of a run, made by the benchmark on the card from
``--seed`` and handed to both the program and the reference.

The layout is the one the program takes (``params=``): a dict of
tensors stacked over layers, ``(layers, in, out)``, so ``h @ W`` reads
the same on both sides.  Each leaf is one draw from one generator on
the device, in the dtype it is served in: N(0, 0.02) for weights, ones
for norm gains, zeros for biases.
"""

from __future__ import annotations

import torch

DECODER_NORMS = ("ln_attn", "ln_mlp", "norm_f")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def decoder_shapes(cfg: dict) -> dict:
    """A Llama-layout decoder's leaves from its Hugging Face sizes."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    heads, kv_heads = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, m, vocab = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    shapes = {
        "embed": (vocab, d),
        "layers": {
            "ln_attn": (layers, d),
            "wq": (layers, d, heads * hd),
            "wk": (layers, d, kv_heads * hd),
            "wv": (layers, d, kv_heads * hd),
            "wo": (layers, heads * hd, d),
            "ln_mlp": (layers, d),
            "w_gate": (layers, d, m),
            "w_up": (layers, d, m),
            "w_down": (layers, m, d),
        },
        "norm_f": (d,),
    }
    if not cfg.get("tie_word_embeddings", False):
        shapes["lm_head"] = (d, vocab)
    return shapes


def gpt2_shapes(cfg: dict) -> dict:
    d, layers = cfg["n_embd"], cfg["n_layer"]
    return {
        "wte": (cfg["vocab_size"], d),
        "wpe": (cfg["n_positions"], d),
        "layers": {
            "ln1_g": (layers, d), "ln1_b": (layers, d),
            "qkv_w": (layers, d, 3 * d), "qkv_b": (layers, 3 * d),
            "proj_w": (layers, d, d), "proj_b": (layers, d),
            "ln2_g": (layers, d), "ln2_b": (layers, d),
            "fc_w": (layers, d, 4 * d), "fc_b": (layers, 4 * d),
            "out_w": (layers, 4 * d, d), "out_b": (layers, d),
        },
        "lnf_g": (d,), "lnf_b": (d,),
    }


def decoder_constant(name: str):
    return 1.0 if name in DECODER_NORMS else None


def gpt2_constant(name: str):
    if name.endswith("_b"):
        return 0.0
    return 1.0 if name.endswith("_g") else None


def make(shapes: dict, constant, seed: int, device,
         dtype: torch.dtype) -> dict:
    """Leaves of ``shapes`` in its order, nested dicts included."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)

    def walk(node):
        out = {}
        for name, shape in node.items():
            if isinstance(shape, dict):
                out[name] = walk(shape)
                continue
            value = constant(name)
            if value is not None:
                out[name] = torch.full(shape, value, dtype=dtype,
                                       device=device)
            else:
                out[name] = torch.empty(shape, dtype=dtype,
                                        device=device).normal_(
                    0.0, 0.02, generator=gen)
        return out

    return walk(shapes)


def same_layout(ours: dict, theirs: dict) -> bool:
    """True when two shape trees have the same leaves and shapes."""
    if ours.keys() != theirs.keys():
        return False
    return all(same_layout(v, theirs[k]) if isinstance(v, dict)
               else tuple(v) == tuple(theirs[k]) for k, v in ours.items())
