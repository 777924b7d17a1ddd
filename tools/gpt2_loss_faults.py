#!/usr/bin/env python3
"""How far GPT-2's first loss moves under a sound run and under planted
attention faults, the readings behind chip_smoke's ``GPT2_LOSS_TOL``.
One NVIDIA GPU:

    python3 tools/gpt2_loss_faults.py

Builds ``gpt2`` (124 M) at its published widths and depth from seed 0
and chip_smoke's batch of 8 x 1025 tokens, exactly as chip_smoke's gpt2
phase does, and takes chip_smoke's reference: ``loss_fn`` in fp32 with
reference attention on the same weights.  Then, in fp32 and in bf16,
the loss under no_grad (the value of the first training step's loss):

* ``sound``: attention through the flash kernels, as the gate sees it;
* ``scale_x2`` / ``scale_x0.5``: the kernels with the softmax scale
  doubled or halved;
* ``no_causal_mask``: the kernels without the causal mask;
* ``kv_heads_rolled``: K and V of the neighbouring head (a layout
  fault);
* ``no_attention``: attention's output zeroed;
* ``bf16_log_softmax`` (bf16 only): the sound logits through a
  log-softmax in bf16 instead of fp32.

Beside each loss, the quantity of chip_smoke's greedy-token gate: the
largest difference of the last position's logits from the plain path's
(reference attention in the same dtype), here on the initial weights.

Faults are planted by replacing ``gpt2.attention`` in this process; no
file changes.  Prints one JSON line: per dtype, the reference loss and
each variant's absolute loss and logit differences.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(config_name: str = "gpt2", device: str = "cuda") -> dict:
    """The JSON line's contents for ``gpt2.CONFIGS[config_name]`` on
    ``device`` (the plain versions of the kernels on the CPU)."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from ant_ray_tpu_torch.models import gpt2  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    sound_attention = gpt2.attention

    def flash(q, k, v, *, causal=True, scale=1.0, roll=False):
        if roll:
            k, v = k.roll(1, dims=2), v.roll(1, dims=2)
        return fa.flash_fwd(q, k, v, causal, scale * q.shape[-1] ** -0.5)[0]

    faults = {
        "sound": lambda q, k, v, **_: sound_attention(q, k, v, causal=True),
        "scale_x2": lambda q, k, v, **_: flash(q, k, v, scale=2.0),
        "scale_x0.5": lambda q, k, v, **_: flash(q, k, v, scale=0.5),
        "no_causal_mask": lambda q, k, v, **_: flash(q, k, v, causal=False),
        "kv_heads_rolled": lambda q, k, v, **_: flash(q, k, v, roll=True),
        "no_attention": lambda q, k, v, **_: torch.zeros_like(q),
    }
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        # chip_smoke's gpt2 phase: weights made in the dtype, the
        # reference on their fp32 copy.
        cfg = dataclasses.replace(gpt2.CONFIGS[config_name], dtype=dtype)
        params = gpt2.init_params(
            cfg, generator=torch.Generator(device=device).manual_seed(0),
            device=device)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, cfg.n_positions + 1))).to(device)
        batch = {"tokens": tokens}
        errors, logit_errors = {}, {}
        with torch.no_grad():
            plain_logits = gpt2.forward(params, tokens[:, :-1], cfg,
                                        attn_impl="reference")[:, -1].float()
            params32 = {k: (v.float() if k != "layers" else
                            {n: w.float() for n, w in v.items()})
                        for k, v in params.items()}
            reference = gpt2.loss_fn(
                params32, batch, dataclasses.replace(cfg, dtype=torch.float32),
                attn_impl="reference").item()
            del params32
            for name, attend in faults.items():
                gpt2.attention = attend
                try:
                    loss = gpt2.loss_fn(params, batch, cfg,
                                        attn_impl="flash").item()
                    logits = gpt2.forward(params, tokens[:, :-1], cfg,
                                          attn_impl="flash")[:, -1].float()
                finally:
                    gpt2.attention = sound_attention
                errors[name] = abs(loss - reference)
                logit_errors[name] = (logits - plain_logits).abs().max().item()
            if dtype == torch.bfloat16:
                logits = gpt2.forward(params, tokens[:, :-1], cfg,
                                      attn_impl="flash")
                logp = torch.log_softmax(logits, dim=-1)
                nll = -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
                errors["bf16_log_softmax"] = abs(nll.float().mean().item()
                                                 - reference)
                del logits, logp
        result[str(dtype).removeprefix("torch.")] = {
            "reference_loss": reference, "abs_error": errors,
            "last_logits_max_abs_error": logit_errors}
        del params
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gpt2_loss_faults: no CUDA device", file=sys.stderr)
        return 1
    result = {"device": torch.cuda.get_device_name(0), **readings()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
