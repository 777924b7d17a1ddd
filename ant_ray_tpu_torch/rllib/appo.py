"""APPO: asynchronous PPO — IMPALA's stale-fragment collection with
PPO's clipped surrogate computed on V-trace-corrected advantages
(ref: rllib/algorithms/appo/ — "PPO loss + V-trace + async sampling";
the JAX package's ``rllib/appo.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ant_ray_tpu_torch.rllib.algorithm import IMPALA, IMPALAConfig
from ant_ray_tpu_torch.rllib.impala import target_terms, vtrace
from ant_ray_tpu_torch.rllib.ppo import (
    Adam,
    entropy_of,
    normalize,
    value_and_grad,
)


def appo_loss(params, batch, *, gamma: float, clip: float,
              vf_coeff: float, ent_coeff: float, clip_rho: float,
              clip_c: float):
    """Clipped surrogate against the BEHAVIOR policy's logp, advantages
    from V-trace (ref: appo_torch_policy loss)."""
    logp_all, target_logp, values_tn, bootstrap = target_terms(params, batch)
    vs, pg_adv = vtrace(
        batch["behavior_logp"], target_logp, batch["rewards"],
        values_tn, bootstrap, batch["dones"],
        gamma=gamma, clip_rho=clip_rho, clip_c=clip_c)
    adv = normalize(pg_adv)

    ratio = torch.exp(target_logp - batch["behavior_logp"])
    surrogate = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    pi_loss = -torch.mean(surrogate)
    vf_loss = 0.5 * torch.mean((values_tn - vs) ** 2)
    entropy = entropy_of(logp_all)
    total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy,
                   "mean_ratio": torch.mean(ratio)}


def make_update_step(optimizer: Adam, *, gamma: float, clip: float,
                     vf_coeff: float, ent_coeff: float,
                     clip_rho: float, clip_c: float):
    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(
            appo_loss, params, batch, gamma=gamma, clip=clip,
            vf_coeff=vf_coeff, ent_coeff=ent_coeff,
            clip_rho=clip_rho, clip_c=clip_c)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=loss)

    return step


@dataclass(frozen=True)
class APPOConfig(IMPALAConfig):
    """APPO config (ref: rllib/algorithms/appo/appo.py APPOConfig).

    Must be a dataclass itself: without the decorator the inherited
    __init__ would set instance attributes from the PARENT's field
    defaults, silently shadowing the overrides below."""

    clip_param: float = 0.3
    num_sgd_iter: int = 4

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    """IMPALA collection + clipped-surrogate learner."""

    def __init__(self, config: APPOConfig):
        super().__init__(config)
        # Replace the plain V-trace update with the clipped surrogate.
        self._update = make_update_step(
            self._optimizer, gamma=config.gamma,
            clip=config.clip_param,
            vf_coeff=config.vf_loss_coeff,
            ent_coeff=config.entropy_coeff,
            clip_rho=config.clip_rho_threshold,
            clip_c=config.clip_c_threshold)
