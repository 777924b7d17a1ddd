"""Frozen operation and byte counts, and the published peaks they are
divided by.

The counts are worked out from the configuration file's published
sizes (Hugging Face key names), never from the program's own FLOP
helpers: those count the embedding lookup as matmul work.  Here the
embedding lookup counts no FLOPs, attention counts its causal pairs
only, and recomputation (remat) counts nothing.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the full
700 W power limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16 = 2
FP32 = 4


def causal_pairs(n: int) -> int:
    """Query-key pairs of a causal attention over ``n`` positions,
    the diagonal included."""
    return n * (n + 1) // 2


class Decoder:
    """A Llama-layout decoder (Mistral's keys): rmsnorm, GQA with rope,
    SwiGLU MLP, untied or tied head."""

    def __init__(self, cfg: dict):
        self.d = cfg["hidden_size"]
        self.m = cfg["intermediate_size"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.vocab = cfg["vocab_size"]
        self.layers = cfg["num_hidden_layers"]
        self.tied = bool(cfg.get("tie_word_embeddings", False))

    @property
    def layer_matmul_params(self) -> int:
        d, hd = self.d, self.hd
        return (d * self.heads * hd + 2 * d * self.kv_heads * hd
                + self.heads * hd * d + 3 * d * self.m)

    @property
    def params(self) -> int:
        per_layer = self.layer_matmul_params + 2 * self.d
        head = 0 if self.tied else self.d * self.vocab
        return self.vocab * self.d + self.layers * per_layer + self.d + head

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one token over every layer, in bf16."""
        return self.layers * 2 * self.kv_heads * self.hd * BF16

    def _attn_flops(self, pairs: int) -> float:
        # QK^T and PV: 2 FLOPs a multiply-add, head_dim wide, every head
        return 4.0 * self.layers * self.heads * self.hd * pairs

    def prefill_flops(self, n: int) -> float:
        """A prefill of ``n`` real tokens: every layer's matmuls over the
        tokens, causal attention over them, the head at the last one."""
        return (2.0 * self.layers * self.layer_matmul_params * n
                + self._attn_flops(causal_pairs(n))
                + 2.0 * self.d * self.vocab)

    def decode_flops(self, contexts) -> float:
        """One decode step: one token for each active slot, whose slab
        already holds ``c`` tokens (it attends over c + 1)."""
        per_token = 2.0 * (self.layers * self.layer_matmul_params
                           + self.d * self.vocab)
        return sum(per_token + self._attn_flops(c + 1) for c in contexts)

    @property
    def weight_bytes_read_by_decode(self) -> int:
        """Every weight read once, except the embedding table, of which
        a decode step reads only its tokens' rows."""
        norms = self.layers * 2 * self.d + self.d
        head = self.d * self.vocab        # the tied table is read whole too
        return (self.layers * self.layer_matmul_params + norms + head) * BF16

    def decode_bytes(self, contexts) -> float:
        """One decode step's floor of bytes: every weight once, each
        active slot's embedding row, the valid K/V of each active slot
        read once, the new K/V written, the fp32 logits written."""
        active = len(contexts)
        if not active:
            return 0.0
        return float(self.weight_bytes_read_by_decode
                     + active * self.d * BF16
                     + sum(contexts) * self.kv_bytes_per_token
                     + active * self.kv_bytes_per_token
                     + active * self.vocab * FP32)


class Gpt2:
    """GPT-2: learned positions, pre-LayerNorm, fused qkv, 4x GELU MLP,
    head tied to the token embedding."""

    def __init__(self, cfg: dict):
        self.d = cfg["n_embd"]
        self.heads = cfg["n_head"]
        self.layers = cfg["n_layer"]
        self.positions = cfg["n_positions"]
        self.vocab = cfg["vocab_size"]
        self.hd = self.d // self.heads

    @property
    def params(self) -> int:
        d = self.d
        per_layer = 12 * d * d + 13 * d
        return (self.vocab * d + self.positions * d
                + self.layers * per_layer + 2 * d)

    @property
    def matmul_params(self) -> int:
        """Weights a token meets in matmuls: the blocks' and the tied
        head's (the embedding lookups are no matmul)."""
        return self.layers * 12 * self.d * self.d + self.d * self.vocab

    def train_step_flops(self, batch: int, seq: int) -> float:
        """Forward and backward (3x the forward) of ``batch`` rows of
        ``seq`` tokens; the recomputed forward of remat is not counted."""
        matmul = 6.0 * self.matmul_params * batch * seq
        attn = 3 * 4.0 * self.layers * self.d * causal_pairs(seq) * batch
        return matmul + attn
