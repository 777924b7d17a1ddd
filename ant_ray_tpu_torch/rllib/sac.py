"""Discrete SAC: maximum-entropy off-policy actor-critic with twin
critics, target networks, and learned temperature (ref:
rllib/algorithms/sac/; the JAX package's ``rllib/sac.py``: the policy,
critic and alpha losses are one function and one autograd step; the
discrete variant follows Christodoulou 2019, the formulation RLlib's
discrete-SAC path implements).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.rllib import ppo
from ant_ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    PPOConfig,
    _DQNRunner,
    _episode_result,
)
from ant_ray_tpu_torch.rllib.rl_module import (
    DiscretePolicyModule,
    TwinQModule,
)

#: The leaves Adam trains.  ``q_target`` moves only by the polyak step:
#: optax, which the JAX package runs over the whole tree, gives it a
#: zero gradient and so an update of exactly zero.
TRAINED = ("log_alpha", "pi", "q")


def init_sac_params(key, obs_dim: int, n_actions: int, hidden: int = 64,
                    device=None):
    """policy + twin critics + target critics + log-temperature."""
    device = resolve_device(device)
    gen = ppo.generator(key, device)
    policy = DiscretePolicyModule(obs_dim, n_actions, hidden=hidden)
    critics = TwinQModule(obs_dim, n_actions, hidden=hidden)
    pi = policy.init_params(gen, device)["pi"]
    q_params = critics.init_params(gen, device)
    return {
        "pi": pi,
        "q": q_params,
        "q_target": ppo.tree_map(torch.clone, q_params),
        "log_alpha": torch.zeros((), device=device),
    }, policy, critics


def trained(params) -> dict:
    """The part of a SAC tree that Adam updates."""
    return {k: params[k] for k in TRAINED}


def sac_losses(params, batch, policy, critics, *, gamma: float,
               target_entropy: float):
    """Critic + actor + temperature losses for discrete SAC
    (expectations over the action distribution — no reparameterized
    sampling needed in the discrete case)."""
    obs, next_obs = batch["obs"], batch["next_obs"]
    actions = batch["actions"]
    alpha = torch.exp(params["log_alpha"])

    # ---- critic target: soft state value of the next state
    next_logits = policy.forward_inference({"pi": params["pi"]}, next_obs)
    next_logp = F.log_softmax(next_logits, dim=-1)
    next_probs = torch.exp(next_logp)
    next_q = critics.forward_train(params["q_target"],
                                   {"obs": next_obs})
    next_q_min = torch.minimum(next_q["q1"], next_q["q2"])
    next_v = torch.sum(next_probs * (next_q_min - alpha * next_logp),
                       dim=-1)
    target = (batch["rewards"] + gamma * (1.0 - batch["dones"])
              * next_v).detach()

    q_out = critics.forward_train(params["q"], {"obs": obs})
    q1_a = q_out["q1"].gather(-1, actions[:, None])[:, 0]
    q2_a = q_out["q2"].gather(-1, actions[:, None])[:, 0]
    critic_loss = 0.5 * (torch.mean((q1_a - target) ** 2)
                         + torch.mean((q2_a - target) ** 2))

    # ---- actor: minimize E_pi[alpha*logp - Q_min] (critics frozen;
    # alpha detached — its OWN gradient comes only from alpha_loss,
    # matching the reference's alpha.detach() in the actor term)
    logits = policy.forward_inference({"pi": params["pi"]}, obs)
    logp = F.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    q_min = torch.minimum(q_out["q1"], q_out["q2"]).detach()
    alpha_detached = alpha.detach()
    actor_loss = torch.mean(torch.sum(
        probs * (alpha_detached * logp - q_min), dim=-1))

    # ---- temperature: match the target entropy
    entropy = -torch.sum(probs * logp, dim=-1)
    alpha_loss = torch.mean(params["log_alpha"]
                            * (entropy - target_entropy).detach())

    total = critic_loss + actor_loss + alpha_loss
    return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                   "alpha_loss": alpha_loss, "alpha": alpha,
                   "entropy": torch.mean(entropy)}


def make_update_step(optimizer: ppo.Adam, policy, critics, *, gamma: float,
                     target_entropy: float, tau: float):
    """``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``opt_state`` is Adam's over :func:`trained`."""

    def loss_of(train, q_target, batch):
        return sac_losses(dict(train, q_target=q_target), batch, policy,
                          critics, gamma=gamma,
                          target_entropy=target_entropy)

    def step(params, opt_state, batch):
        loss, metrics, grads = ppo.value_and_grad(
            loss_of, trained(params), params["q_target"], batch)
        optimizer.update(grads, opt_state, trained(params))
        # Polyak-average the critic into the target net.
        with torch.no_grad():
            target = ppo.tree_leaves(params["q_target"])
            torch._foreach_mul_(target, 1.0 - tau)
            torch._foreach_add_(target, torch._foreach_mul(
                ppo.tree_leaves(params["q"]), tau))
        return params, opt_state, dict(metrics, total_loss=loss)

    return step


def act(policy, params, obs, gen: torch.Generator) -> np.ndarray:
    actions, _aux = policy.forward_exploration({"pi": params["pi"]},
                                               obs, gen)
    return actions.cpu().numpy()


# ------------------------------------------------------------- algorithm


@dataclass(frozen=True)
class SACConfig(PPOConfig):
    """Discrete-SAC config (ref: rllib/algorithms/sac/sac.py SACConfig;
    PPO-only fields are inherited but unused)."""

    lr: float = 3e-4
    buffer_size: int = 50_000
    train_batch_size: int = 128
    num_updates_per_iteration: int = 32
    learning_starts: int = 500
    tau: float = 0.01
    # target_entropy = coeff * log(n_actions) (RLlib's "auto" scaling)
    target_entropy_coeff: float = 0.7

    def build(self) -> "SAC":
        return SAC(self)


class _SACRunner(_DQNRunner):
    """Actor: _DQNRunner's transition-collection loop with actions
    sampled FROM the stochastic policy (max-entropy exploration — no
    epsilon schedule)."""

    def __init__(self, config: "SACConfig", index: int, env_ctor=None):
        super().__init__(config, index, env_ctor)
        self._policy = DiscretePolicyModule(
            self.env.obs_dim, self.env.n_actions, hidden=config.hidden)

    def _act(self, obs, epsilon: float) -> np.ndarray:
        del epsilon  # the policy's own entropy explores
        return act(self._policy, self.params,
                   torch.as_tensor(obs, device=self.device), self._gen)


class SAC(Algorithm):
    """Off-policy max-entropy learner over replayed transitions."""

    _runner_cls = _SACRunner

    def __init__(self, config: SACConfig):
        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib.dqn import ReplayBuffer  # noqa: PLC0415

        self._ppo = ppo
        self.config = config
        self.device = resolve_device(config.device)
        probe = env_mod.make_env(config.env, num_envs=1)
        self._obs_dim, self._n_actions = probe.obs_dim, probe.n_actions
        self.params, self._policy, self._critics = init_sac_params(
            config.seed, self._obs_dim, self._n_actions, config.hidden,
            self.device)
        self._optimizer = ppo.Adam(config.lr)
        self._opt_state = self._optimizer.init(trained(self.params))
        target_entropy = (config.target_entropy_coeff
                          * float(np.log(self._n_actions)))
        self._update = make_update_step(
            self._optimizer, self._policy, self._critics,
            gamma=config.gamma, target_entropy=target_entropy,
            tau=config.tau)
        self._buffer = ReplayBuffer(config.buffer_size, self._obs_dim,
                                    seed=config.seed)
        self._learners = None
        self._iteration = 0
        self._env_steps = 0
        self._runners = self._make_runners()

    def train(self) -> dict:
        cfg = self.config
        self._sync_runners()
        samples = self._runner_call("sample")
        for s in samples:
            self._buffer.add_batch(s["obs"], s["actions"], s["rewards"],
                                   s["next_obs"], s["dones"])
            self._env_steps += len(s["actions"])
        metrics = {}
        if len(self._buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iteration):
                batch = ppo.to_device(
                    self._buffer.sample(cfg.train_batch_size), self.device)
                self.params, self._opt_state, metrics = self._update(
                    self.params, self._opt_state, batch)
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            **_episode_result(samples),
            "num_env_steps_sampled": self._env_steps,
            "learner": {k: float(v) for k, v in metrics.items()},
        }
