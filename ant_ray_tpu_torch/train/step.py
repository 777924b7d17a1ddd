"""One training step of a Llama or GPT-2 model: loss, autograd through
the flash kernels (forward and backward), AdamW.  The counterpart of the
JAX package's own train step in bench.py
(``jax.value_and_grad(llama.loss_fn)`` then
``optax.adamw(3e-4, weight_decay=0.01)``), with the loss of the config's
family.

Parameters stay the plain dict of stacked tensors that models/llama.py
and models/gpt2.py use; :func:`make_optimizer` turns every leaf into a
leaf that requires grad and hands them to ``torch.optim.AdamW``.  The
step updates them in place (the JAX step donates its buffers and
returns new ones).
"""

from __future__ import annotations

import torch

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.models import gpt2, llama


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every tensor of a parameter dict (nested dicts included), in
    insertion order."""
    leaves = []
    for value in params.values():
        leaves += param_leaves(value) if isinstance(value, dict) else [value]
    return leaves


def make_optimizer(params: dict, lr: float = 3e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW with optax's ``adamw`` defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay on every leaf).  Its moments are made like each leaf,
    so they stay in the parameter dtype, as optax keeps them.  Marks
    every leaf ``requires_grad``."""
    leaves = [p.requires_grad_() for p in param_leaves(params)]
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def train_step(params: dict, optimizer: torch.optim.Optimizer, tokens,
               config: llama.LlamaConfig | gpt2.Gpt2Config, *,
               remat: str = "full", device=None) -> torch.Tensor:
    """One step on ``tokens`` (batch, seq + 1): next-token loss, its
    gradients, one optimizer update of ``params`` in place.  Returns the
    loss (a detached scalar tensor on the device).

    The loss is that of the config's family: ``llama.loss_fn`` with
    ``remat`` for a :class:`~ant_ray_tpu_torch.models.llama.LlamaConfig`,
    ``gpt2.loss_fn`` for a :class:`~ant_ray_tpu_torch.models.gpt2.
    Gpt2Config`, which checkpoints every block and takes no other
    ``remat`` than "full".

    Runs on the current CUDA device unless ``device`` names another; the
    parameters must already live there.  Without a GPU and without
    ``device="cpu"`` it raises."""
    device = resolve_device(device)
    on = param_leaves(params)[0].device
    if on != device:
        raise ValueError(f"parameters live on {on}, the step runs on "
                         f"{device}")
    if isinstance(config, gpt2.Gpt2Config) and remat != "full":
        raise ValueError(f"GPT-2 checkpoints every block, as the reference "
                         f"does; remat={remat!r} does not apply to it")
    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    optimizer.zero_grad(set_to_none=True)
    if isinstance(config, gpt2.Gpt2Config):
        loss = gpt2.loss_fn(params, batch, config)
    else:
        loss = llama.loss_fn(params, batch, config, remat=remat)
    loss.backward()
    optimizer.step()
    return loss.detach()
