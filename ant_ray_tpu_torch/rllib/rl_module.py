"""RLModule: the neural-network unit of an algorithm, separated from
the training loop (capability mirror of the reference's RLModule API,
ref: rllib/core/rl_module/rl_module.py — forward_inference /
forward_exploration / forward_train as distinct entry points so the
same module serves acting, sampling, and loss computation).

As in the JAX package, a module is a tree of params plus PURE forward
functions: the params live outside the module, as a tree of tensors
with the JAX package's leaf names, so every learner step closes over
module functions, never over mutable objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.rllib.ppo import categorical, generator
from ant_ray_tpu_torch.rllib.ppo import dense_init as _dense
from ant_ray_tpu_torch.rllib.ppo import mlp_forward as _mlp


@dataclass(frozen=True)
class RLModuleSpec:
    """Builder for an RLModule (ref: rl_module.RLModuleSpec): the
    catalog entry an algorithm instantiates per learner/runner."""

    module_class: type
    obs_dim: int
    n_actions: int
    model_config: dict = field(default_factory=dict)

    def build(self) -> "RLModule":
        return self.module_class(self.obs_dim, self.n_actions,
                                 **self.model_config)


class RLModule:
    """ABC: params live OUTSIDE the module (functional style); the
    module provides init + pure forwards."""

    def __init__(self, obs_dim: int, n_actions: int, **model_config):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.model_config = model_config

    def init_params(self, key, device=None) -> Any:
        """``key``: a ``torch.Generator`` on ``device`` or an integer
        seed."""
        raise NotImplementedError

    def forward_inference(self, params, obs):
        """Greedy action logits/values for serving (no exploration)."""
        raise NotImplementedError

    def forward_exploration(self, params, obs, key):
        """(actions, aux) for sampling — stochastic; ``key`` is a
        ``torch.Generator`` on the params' device."""
        raise NotImplementedError

    def forward_train(self, params, batch) -> dict:
        """Tensors the loss needs (logits, values, q-values...)."""
        raise NotImplementedError


class DiscretePolicyModule(RLModule):
    """Default catalog module: tanh-MLP policy head over discrete
    actions (the reference's fcnet default), with an optional value
    head (``value_head=True``)."""

    def init_params(self, key, device=None):
        device = resolve_device(device)
        gen = generator(key, device)
        hidden = self.model_config.get("hidden", 64)
        params = {"pi": [_dense(gen, self.obs_dim, hidden, device),
                         _dense(gen, hidden, hidden, device),
                         _dense(gen, hidden, self.n_actions, device)]}
        if self.model_config.get("value_head"):
            params["vf"] = [_dense(gen, self.obs_dim, hidden, device),
                            _dense(gen, hidden, hidden, device),
                            _dense(gen, hidden, 1, device)]
        return params

    def forward_inference(self, params, obs):
        return _mlp(params["pi"], obs)

    @torch.no_grad()
    def forward_exploration(self, params, obs, key):
        logits = self.forward_inference(params, obs)
        actions = categorical(key, logits)
        logp = F.log_softmax(logits, dim=-1).gather(
            -1, actions[:, None])[:, 0]
        return actions, {"logp": logp, "logits": logits}

    def forward_train(self, params, batch):
        out = {"logits": self.forward_inference(params, batch["obs"])}
        if "vf" in params:
            out["values"] = _mlp(params["vf"], batch["obs"])[..., 0]
        return out


class TwinQModule(RLModule):
    """Twin Q-networks over discrete actions (SAC's critic pair,
    ref: rllib/algorithms/sac/ — clipped double-Q)."""

    def init_params(self, key, device=None):
        device = resolve_device(device)
        gen = generator(key, device)
        hidden = self.model_config.get("hidden", 64)

        def tower():
            return [_dense(gen, self.obs_dim, hidden, device),
                    _dense(gen, hidden, hidden, device),
                    _dense(gen, hidden, self.n_actions, device)]

        q1 = tower()
        return {"q1": q1, "q2": tower()}

    def forward_inference(self, params, obs):
        return torch.minimum(_mlp(params["q1"], obs),
                             _mlp(params["q2"], obs))

    def forward_train(self, params, batch):
        obs = batch["obs"]
        return {"q1": _mlp(params["q1"], obs),
                "q2": _mlp(params["q2"], obs)}
