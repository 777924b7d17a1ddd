"""IMPALA core: V-trace off-policy correction + actor-critic update
(ref: rllib/algorithms/impala/ and the V-trace math from
vtrace_torch.py; the JAX package's ``rllib/impala.py``, whose reverse
``lax.scan`` becomes a loop over T here).

The architecture difference vs the reference is deliberate: the
reference streams rollouts into a background learner thread; here the
collection is synchronous actor calls but the *math* is identical —
behavior-policy fragments arrive stale, and V-trace reweights them for
the current target policy, so learner throughput never waits on
strict on-policyness (the property that matters for parity).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ant_ray_tpu_torch.rllib.ppo import (  # noqa: F401
    Adam,
    entropy_of,
    init_policy,
    policy_logits,
    value,
    value_and_grad,
)


@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           dones, *, gamma: float, clip_rho: float = 1.0,
           clip_c: float = 1.0):
    """V-trace targets + policy-gradient advantages over (T, N) tensors
    (ref: IMPALA paper eq. 1; vtrace_torch.py multi_from_logits).

    Returns (vs, pg_advantages), both (T, N), with no gradient: the JAX
    package stops it at both outputs, so none flows through here."""
    rho = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rho, max=clip_rho)
    clipped_c = torch.clamp(rho, max=clip_c)
    discounts = gamma * (1.0 - dones)

    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rho * (rewards + discounts * next_values - values)

    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * len(deltas)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + discounts[t] * clipped_c[t] * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    next_vs = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = clipped_rho * (rewards + discounts * next_vs - values)
    return vs, pg_adv


def target_terms(params, batch):
    """(logp_all, target_logp, values, bootstrap values) of a (T, N)
    fragment batch under the current params."""
    logits = policy_logits(params, batch["obs"])        # (T, N, A)
    logp_all = F.log_softmax(logits, dim=-1)
    target_logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
    values_tn = value(params, batch["obs"])             # (T, N)
    bootstrap = value(params, batch["bootstrap_obs"])   # (N,)
    return logp_all, target_logp, values_tn, bootstrap


def impala_loss(params, batch, *, gamma: float, vf_coeff: float,
                ent_coeff: float, clip_rho: float, clip_c: float):
    """batch: (T, N) fragments — obs (T,N,D), actions, behavior_logp,
    rewards, dones, bootstrap_obs (N, D)."""
    logp_all, target_logp, values_tn, bootstrap = target_terms(params, batch)
    vs, pg_adv = vtrace(
        batch["behavior_logp"], target_logp, batch["rewards"],
        values_tn, bootstrap, batch["dones"],
        gamma=gamma, clip_rho=clip_rho, clip_c=clip_c)

    pi_loss = -torch.mean(target_logp * pg_adv)
    vf_loss = 0.5 * torch.mean((values_tn - vs) ** 2)
    entropy = entropy_of(logp_all)
    total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


def make_update_step(optimizer: Adam, *, gamma: float, vf_coeff: float,
                     ent_coeff: float, clip_rho: float, clip_c: float):
    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(
            impala_loss, params, batch, gamma=gamma, vf_coeff=vf_coeff,
            ent_coeff=ent_coeff, clip_rho=clip_rho, clip_c=clip_c)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=loss)

    return step
