"""DQN core: Q-network, epsilon-greedy acting, double-Q Huber update,
replay buffer — PyTorch numerics on the card, numpy host-side replay
(ref: rllib/algorithms/dqn/; the JAX package's ``rllib/dqn.py``: the
loss and the update are two functions, and the replay buffer stays on
the host, where sampling is pointer math).
"""

from __future__ import annotations

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.rllib.ppo import (
    Adam,
    dense_init,
    generator,
    mlp_forward,
    value_and_grad,
)


def init_qnet(key, obs_dim: int, n_actions: int, hidden: int = 64,
              device=None):
    """Two-hidden-layer Q tower (RLlib's default fcnet shape): a list of
    three ``{"w", "b"}`` layers, He-initialized."""
    device = resolve_device(device)
    gen = generator(key, device)
    return [dense_init(gen, obs_dim, hidden, device),
            dense_init(gen, hidden, hidden, device),
            dense_init(gen, hidden, n_actions, device)]


def q_values(params, obs):
    return mlp_forward(params, obs)


@torch.no_grad()
def act(params, obs, gen: torch.Generator, epsilon: float):
    """Batched epsilon-greedy: a uniform random action where a uniform
    draw falls below ``epsilon``, the greedy one elsewhere."""
    q = q_values(params, obs)
    greedy = torch.argmax(q, dim=-1)
    random_actions = torch.randint(0, q.shape[-1], greedy.shape,
                                   generator=gen, device=q.device)
    explore = torch.rand(greedy.shape, generator=gen,
                         device=q.device) < epsilon
    return torch.where(explore, random_actions, greedy)


def huber_loss(x, delta: float = 1.0):
    """``optax.huber_loss`` (its formula, so its gradient too)."""
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    linear = abs_x - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def dqn_loss(params, target_params, batch, *, gamma: float, double: bool):
    q = q_values(params, batch["obs"])
    q_taken = q.gather(-1, batch["actions"][:, None])[:, 0]
    q_next_target = q_values(target_params, batch["next_obs"])
    if double:
        # Double DQN: online net picks, target net evaluates
        # (ref: rllib dqn double_q=True default).
        next_actions = torch.argmax(q_values(params, batch["next_obs"]),
                                    dim=-1)
        next_q = q_next_target.gather(-1, next_actions[:, None])[:, 0]
    else:
        next_q = torch.max(q_next_target, dim=-1).values
    target = batch["rewards"] + gamma * (1.0 - batch["dones"]) \
        * next_q.detach()
    td = q_taken - target
    loss = torch.mean(huber_loss(td))
    return loss, {"td_error_mean": torch.mean(torch.abs(td)),
                  "q_mean": torch.mean(q_taken)}


def make_update_step(optimizer: Adam, *, gamma: float, double: bool = True):
    def step(params, opt_state, target_params, batch):
        loss, metrics, grads = value_and_grad(
            dqn_loss, params, target_params, batch, gamma=gamma,
            double=double)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, total_loss=loss)

    return step


class ReplayBuffer:
    """Uniform ring-buffer replay on host memory
    (ref: rllib/utils/replay_buffers/ — numpy slab, O(1) insert); the
    JAX package's class as it is, so the same seed samples the same
    rows."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0):
        self.capacity = int(capacity)
        self._obs = np.zeros((capacity, obs_dim), np.float32)
        self._next_obs = np.zeros((capacity, obs_dim), np.float32)
        self._actions = np.zeros((capacity,), np.int64)
        self._rewards = np.zeros((capacity,), np.float32)
        self._dones = np.zeros((capacity,), np.float32)
        self._pos = 0
        self._size = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        n = len(actions)
        idx = (self._pos + np.arange(n)) % self.capacity
        self._obs[idx] = obs
        self._actions[idx] = actions
        self._rewards[idx] = rewards
        self._next_obs[idx] = next_obs
        self._dones[idx] = dones
        self._pos = int((self._pos + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, batch_size: int) -> dict:
        idx = self._rng.randint(0, self._size, batch_size)
        return {"obs": self._obs[idx], "actions": self._actions[idx],
                "rewards": self._rewards[idx],
                "next_obs": self._next_obs[idx],
                "dones": self._dones[idx]}
