"""Tokenizers for the LLM layer (a copy of ant_ray_tpu/llm/tokenizer.py,
which the port does not import).

``get_tokenizer(name)`` loads a HuggingFace tokenizer when the
``transformers`` package and the named model are available (the
reference delegates tokenization to the engine's HF tokenizer); the
dependency-free :class:`ByteTokenizer` covers tests and air-gapped use.
"""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 bytes as token ids; bos/eos reserved at the top of the
    byte range so it fits any vocab >= 256."""

    bos_id = 254
    eos_id = 255

    @property
    def vocab_size(self) -> int:
        return 256

    def encode(self, text: str) -> list[int]:
        return [b if b < 254 else 253 for b in text.encode("utf-8")]

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 254)
        return data.decode("utf-8", errors="replace")


def get_tokenizer(name_or_path: str | None):
    """HF tokenizer when available, ByteTokenizer otherwise/for None."""
    if not name_or_path:
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer  # noqa: PLC0415

        return AutoTokenizer.from_pretrained(name_or_path)
    except Exception:  # noqa: BLE001 — offline / unknown model
        return ByteTokenizer()
