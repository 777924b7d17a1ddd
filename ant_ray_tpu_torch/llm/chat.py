"""Chat templating for chat completions (a copy of
ant_ray_tpu/llm/chat.py, which the port does not import).

``render_chat`` prefers the tokenizer's own ``apply_chat_template``
(HF tokenizers ship the model's template); tokenizers without one (the
dependency-free ByteTokenizer) get a minimal generic template with an
assistant generation prompt.
"""

from __future__ import annotations


def render_chat(tokenizer, messages: list, *,
                add_generation_prompt: bool = True):
    """messages: [{"role": ..., "content": ...}, ...] → token ids."""
    if not messages:
        raise ValueError("empty messages")
    for m in messages:
        if "role" not in m or "content" not in m:
            raise ValueError(f"malformed chat message: {m!r}")
    apply = getattr(tokenizer, "apply_chat_template", None)
    if callable(apply):
        try:
            return list(apply(
                messages, add_generation_prompt=add_generation_prompt,
                tokenize=True))
        except Exception:  # noqa: BLE001 — template-less HF tokenizer
            pass
    text = "".join(
        f"<|{m['role']}|>\n{m['content']}\n" for m in messages)
    if add_generation_prompt:
        text += "<|assistant|>\n"
    return tokenizer.encode(text)
