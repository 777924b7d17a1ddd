"""Llama checkpoint loading — real weights into the port's parameter tree
(counterpart of ant_ray_tpu/models/checkpoint.py, which the port does not
import).  Reads the HuggingFace Llama layout from a local directory:

* ``*.safetensors``, through this module's own reader (the format is an
  8-byte little-endian header length, a JSON header, then raw
  little-endian buffers), so neither ``safetensors`` nor numpy's lack of
  bf16 stands in the way; else
* ``pytorch_model*.bin`` via ``torch.load`` (memory-mapped, stored dtype
  kept); else
* a ``params.npz`` flat dump of the port's own tree (save_params /
  load_params), in the reference's file layout.

HF stores linear weights as (out_features, in_features); the model
applies ``h @ W`` with (in, out), so every projection transposes on
load.  HF's q/k weights are already permuted for the rotate-half rope
convention, which is ops/rope.py's layout — no re-permutation.

Leaves are built one at a time straight into a tensor of the config's
dtype on ``device`` (CUDA unless asked): each layer's tensor is read from
the file mapping, moved to the device and transposed and cast there.  The
host holds the file mapping and at most one layer's tensor beside it,
never a stacked leaf; no leaf is a view of the mapping.  Casts round to
nearest even, the bits ``ml_dtypes``' ``astype`` gives in the reference.
"""

from __future__ import annotations

import json
import mmap
import os
import re

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.models.llama import CONFIGS, LlamaConfig, param_shapes

_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(.+)")

# HF tensor name (per layer) → (our leaf name, transpose?)
_PER_LAYER = {
    "input_layernorm.weight": ("ln_attn", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("ln_mlp", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}

_TOP_LEVEL = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("norm_f", False),
    "lm_head.weight": ("lm_head", True),
}

# safetensors dtype tags the reader takes.
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32}


def config_from_hf(path: str) -> LlamaConfig:
    """Build a LlamaConfig from a HF ``config.json``."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("torch_dtype") in ("float32", "float64"):
        dtype = torch.float32
    else:  # bf16/f16 checkpoints compute in bf16
        dtype = torch.bfloat16
    return LlamaConfig(
        dtype=dtype,
        vocab_size=cfg["vocab_size"],
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads",
                           cfg["num_attention_heads"]),
        mlp_dim=cfg["intermediate_size"],
        max_seq=cfg.get("max_position_embeddings", 8192),
        rope_theta=float(cfg.get("rope_theta", 500000.0)),
        norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
    )


def read_safetensors(path: str):
    """Yield (name, CPU tensor of the stored dtype) from one safetensors
    file, in header order.  Tensors are views of a private (copy on
    write) mapping of the file, which they keep alive."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        mapping = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                   if os.fstat(f.fileno()).st_size > 8 + n else None)
    base = 8 + n
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {info['dtype']}; the "
                f"reader takes {sorted(_ST_DTYPES)}")
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} spans {end - start} "
                             f"bytes, not those of {info['dtype']} {shape}")
        if end == start:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(mapping, dtype=torch.uint8,
                               count=end - start, offset=base + start)
        if (base + start) % itemsize:
            raw = raw.clone()             # a typed view needs alignment
        yield name, raw.view(dtype).reshape(shape)


def _iter_hf_tensors(path: str):
    """Yield (name, CPU tensor of the stored dtype) from whatever weight
    files exist."""
    st_files = sorted(f for f in os.listdir(path)
                      if f.endswith(".safetensors"))
    if st_files:
        for fname in st_files:
            yield from read_safetensors(os.path.join(path, fname))
        return
    bin_files = sorted(f for f in os.listdir(path)
                       if f.startswith("pytorch_model")
                       and f.endswith(".bin"))
    if bin_files:
        for fname in bin_files:
            state = torch.load(os.path.join(path, fname), map_location="cpu",
                               weights_only=True, mmap=True)
            yield from state.items()
        return
    raise FileNotFoundError(
        f"no *.safetensors or pytorch_model*.bin under {path}")


def load_llama_params(path: str, config: LlamaConfig | None = None,
                      dtype: torch.dtype | None = None,
                      device=None) -> tuple[dict, LlamaConfig]:
    """Load a HF-format Llama checkpoint directory into the port's tree.

    Returns (params, config); ``params`` leaves are tensors of ``dtype``
    (default: the config's dtype) on ``device`` (default: the current
    CUDA device)."""
    device = resolve_device(device)
    npz = os.path.join(path, "params.npz")
    if os.path.exists(npz):
        if config is None:
            raise ValueError("params.npz needs an explicit config")
        return load_params(npz, config, device=device), config

    if config is None:
        config = config_from_hf(path)
    shapes = param_shapes(config)
    out_dtype = dtype if dtype is not None else config.dtype
    layers: dict[str, list] = {
        name: [None] * config.n_layers
        for name in shapes["layers"]
    }
    top: dict[str, torch.Tensor] = {}

    for name, tensor in _iter_hf_tensors(path):
        m = _LAYER_RE.match(name)
        if m:
            index, leaf_name = int(m.group(1)), m.group(2)
            entry = _PER_LAYER.get(leaf_name)
            if entry is None:
                continue  # rotary caches etc.
            ours, transpose = entry
            layers[ours][index] = (tensor, transpose)
        else:
            entry = _TOP_LEVEL.get(name)
            if entry is None:
                continue
            ours, transpose = entry
            top[ours] = (tensor, transpose)

    def build(parts, shape, where):
        return _build(parts, shape, out_dtype, device, where)

    params: dict = {"layers": {}}
    for ours, per_layer in layers.items():
        missing = [i for i, t in enumerate(per_layer) if t is None]
        if missing:
            raise ValueError(
                f"checkpoint is missing layer tensors for "
                f"{ours!r}: layers {missing}")
        params["layers"][ours] = build(per_layer, shapes["layers"][ours],
                                       f"/layers/{ours}")
    for ours in ("embed", "norm_f"):
        if ours not in top:
            raise ValueError(f"checkpoint is missing {ours!r}")
        params[ours] = build(top[ours], shapes[ours], f"/{ours}")
    if config.tie_embeddings:
        pass  # lm head is embed.T at use sites
    elif "lm_head" in top:
        params["lm_head"] = build(top["lm_head"], shapes["lm_head"],
                                  "/lm_head")
    else:
        # Tied checkpoints sometimes omit lm_head with the flag unset.
        params["lm_head"] = params["embed"].t().contiguous()

    _check_shapes(params, shapes)
    return params, config


def _build(parts, shape, dtype, device, where) -> torch.Tensor:
    """A new tensor of ``shape`` and ``dtype`` on ``device`` from ``parts``:
    one ``(tensor, transpose)`` pair, or a list of them stacked along a new
    first axis.  Each stored tensor is moved to the device as it is (one
    read of its bytes), then transposed and cast there by ``copy_``."""
    stacked = isinstance(parts, list)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out if stacked else out[None]
    parts = parts if stacked else [parts]
    for row, (t, transpose) in zip(rows, parts):
        got = tuple(t.t().shape if transpose else t.shape)
        if got != tuple(row.shape):
            got = (len(parts), *got) if stacked else got
            raise ValueError(f"shape mismatch at {where}: checkpoint {got} "
                             f"vs model {tuple(shape)}")
        t = t.to(device)
        row.copy_(t.t() if transpose else t)
    return out


def hf_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The port's tree as a HF Llama state dict, the inverse of the name
    table above: per-layer names, (out, in) projections, contiguous CPU
    tensors of the leaves' dtype that share no memory with ``params``.
    A tree without ``lm_head`` (tied embeddings) gives none."""
    def leaf(t, transpose):
        return (t.t() if transpose else t).to("cpu", copy=True).contiguous()

    state = {}
    for hf, (ours, transpose) in _PER_LAYER.items():
        for i, t in enumerate(params["layers"][ours]):
            state[f"model.layers.{i}.{hf}"] = leaf(t, transpose)
    for hf, (ours, transpose) in _TOP_LEVEL.items():
        if ours in params:
            state[hf] = leaf(params[ours], transpose)
    return state


def hf_config(config: LlamaConfig) -> dict:
    """``config`` as the HF ``config.json`` keys that config_from_hf
    reads back."""
    return {"vocab_size": config.vocab_size, "hidden_size": config.dim,
            "num_hidden_layers": config.n_layers,
            "num_attention_heads": config.n_heads,
            "num_key_value_heads": config.n_kv_heads,
            "intermediate_size": config.mlp_dim,
            "max_position_embeddings": config.max_seq,
            "rope_theta": config.rope_theta, "rms_norm_eps": config.norm_eps,
            "tie_word_embeddings": config.tie_embeddings,
            "torch_dtype": ("float32" if config.dtype == torch.float32
                            else "bfloat16")}


def _check_shapes(params: dict, shapes: dict) -> None:
    def walk(p, s, path):
        if isinstance(s, dict):
            for key, sub in s.items():
                if key not in p:
                    raise ValueError(f"missing param {path}/{key}")
                walk(p[key], sub, f"{path}/{key}")
        else:
            if tuple(p.shape) != tuple(s):
                raise ValueError(
                    f"shape mismatch at {path}: checkpoint "
                    f"{tuple(p.shape)} vs model {tuple(s)}")

    walk(params, shapes, "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy: bf16 as 2-byte raw (``|V2``), the layout numpy
    gives an ``ml_dtypes.bfloat16`` leaf in the reference's files."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_params(params: dict, path: str,
                config: LlamaConfig | None = None) -> None:
    """Flat npz dump of the port's tree, in the reference's layout: names
    joined with dots, bf16 leaves as 2-byte raw.

    Pass ``config`` to stamp head-split metadata that load_params
    validates: projection shapes alone cannot distinguish head splits
    (16×64 and 8×128 heads both give a (dim, dim) wq), so a checkpoint
    loaded under the wrong split would otherwise silently scramble the
    head structure.
    """
    flat = {}
    if config is not None:
        flat["__head_split__"] = np.asarray(
            [config.n_heads, config.n_kv_heads, config.head_dim])

    def walk(tree, prefix):
        for key, value in tree.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, name + ".")
            else:
                flat[name] = _to_numpy(value)

    walk(params, "")
    np.savez(path, **flat)


def _from_numpy(arr: np.ndarray, config: LlamaConfig) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if config.dtype != torch.bfloat16:
            raise ValueError(f"a 2-byte raw (bf16) leaf cannot load under a "
                             f"{config.dtype} config")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_params(path: str, config: LlamaConfig, device=None) -> dict:
    """Read a save_params file (the port's or the reference's) onto
    ``device``.  Leaves keep their stored dtype; 2-byte raw leaves are bf16
    bits and need a bf16 config."""
    device = resolve_device(device)
    data = np.load(path)
    params: dict = {}
    for name in data.files:
        if name == "__head_split__":
            saved = tuple(int(x) for x in data[name])
            want = (config.n_heads, config.n_kv_heads, config.head_dim)
            if saved != want:
                raise ValueError(
                    f"checkpoint head split (n_heads, n_kv_heads, "
                    f"head_dim)={saved} does not match the target "
                    f"config {want} — same tensor shapes, different "
                    "head structure; loading would scramble attention")
            continue
        parts = name.split(".")
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _from_numpy(data[name], config).to(device)
    _check_shapes(params, param_shapes(config))
    return params


def resolve_model(model: str | LlamaConfig, device=None, *,
                  load: bool = True
                  ) -> tuple[dict | None, LlamaConfig, bool]:
    """The engine-facing entry, and the one place a model string is
    read.  Returns (params, config, is_directory): a named config
    ("tiny", "llama3-8b") gives (None, config, False) — random init; a
    local checkpoint directory gives (params loaded onto ``device``,
    config-from-json, True), or no params with ``load=False`` (the caller
    brings its own; only config.json is read).  A ``LlamaConfig`` itself,
    which ``LLMEngine`` also takes (say, a named one with fewer layers),
    gives (None, it, False); the JAX package's takes strings only."""
    if isinstance(model, LlamaConfig):
        return None, model, False
    if model in CONFIGS:
        return None, CONFIGS[model], False
    if not os.path.isdir(model):
        raise ValueError(
            f"model {model!r} is neither a named config {sorted(CONFIGS)} "
            "nor a local checkpoint directory")
    if not load:
        return None, config_from_hf(model), True
    params, config = load_llama_params(model, device=device)
    return params, config, True
