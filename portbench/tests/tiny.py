"""Tiny stand-ins of the cells for CPU tests: the same files, the widths
shrunk, run through ``portbench.run.execute`` on the CPU."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


def bench():
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def mistral(dtype="float32", **over):
    cfg = load("configs", "mistral-7b-v0.3")
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
               vocab_size=256, max_position_embeddings=512,
               torch_dtype=dtype,
               engine={"slots": 4, "max_seq": 512,
                       "prefill_chunk_tokens": None})
    cfg.update(over)
    return cfg


def mistral_wide(dtype="float32"):
    """One layer at the published hidden width, heads and head size, so
    that logits spread as the cell's do and its limits apply."""
    return mistral(dtype, hidden_size=4096, num_attention_heads=32,
                   num_key_value_heads=8, head_dim=128,
                   intermediate_size=1024, num_hidden_layers=1,
                   vocab_size=512)


def chat():
    tr = load("traffic", "mistral7b.chat")
    tr.update(rate_per_s=8,
              prompt_tokens={"dist": "lognormal", "median": 40, "sigma": 0.9,
                             "min": 8, "max": 200},
              output_tokens={"dist": "lognormal", "median": 8, "sigma": 0.7,
                             "min": 2, "max": 24})
    return tr


def chat_long_answers():
    """Short prompts, answers longer than them: a decode step's lost
    state then changes most of the context the next tokens see."""
    tr = chat()
    tr.update(prompt_tokens={"dist": "uniform", "min": 4, "max": 8},
              output_tokens={"dist": "uniform", "min": 12, "max": 20})
    return tr


def docs():
    tr = load("traffic", "mistral7b.docs")
    tr.update(prompt_tokens={"dist": "uniform", "min": 100, "max": 300})
    return tr


def gpt2(dtype="float32"):
    cfg = load("configs", "gpt2-xl")
    cfg.update(n_embd=64, n_head=4, n_layer=2, n_positions=64, n_ctx=64,
               vocab_size=257, torch_dtype=dtype)
    return cfg


def train_traffic():
    tr = load("traffic", "gpt2xl.train")
    tr.update(batch=4, seq=32)
    return tr


def cell(name, config, traffic):
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}
