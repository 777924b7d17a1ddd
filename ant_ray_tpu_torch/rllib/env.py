"""Vectorized numpy environments (no gym dependency): a copy of the JAX
package's ``rllib/env.py``, so the port imports nothing of it.

The reference's env layer wraps gymnasium (rllib/env/); here the
built-in envs implement the same reset/step contract *vectorized* so an
EnvRunner steps N copies in one numpy call (fixed-size batched arrays,
no ragged python loops), which is what the learner on the card takes in.
"""

from __future__ import annotations

import numpy as np


class CartPoleEnv:
    """Classic CartPole-v1 dynamics, vectorized over ``num_envs``."""

    obs_dim = 4
    n_actions = 2
    max_steps = 500

    def __init__(self, num_envs: int = 1, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.RandomState(seed)
        self.state = np.zeros((num_envs, 4), np.float32)
        self.steps = np.zeros(num_envs, np.int32)
        self.reset()

    def reset(self, mask=None):
        """Reset all envs (mask=None) or the masked subset."""
        if mask is None:
            mask = np.ones(self.num_envs, bool)
        n = int(mask.sum())
        self.state[mask] = self._rng.uniform(
            -0.05, 0.05, (n, 4)).astype(np.float32)
        self.steps[mask] = 0
        return self.state.copy()

    def step(self, actions):
        """actions: (num_envs,) int → (obs, reward, done)."""
        gravity, masscart, masspole = 9.8, 1.0, 0.1
        total_mass = masscart + masspole
        length = 0.5
        polemass_length = masspole * length
        force_mag, tau = 10.0, 0.02

        x, x_dot, theta, theta_dot = self.state.T
        force = np.where(actions == 1, force_mag, -force_mag)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        theta_acc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costheta / total_mass
        self.state = np.stack([
            x + tau * x_dot,
            x_dot + tau * x_acc,
            theta + tau * theta_dot,
            theta_dot + tau * theta_acc,
        ], axis=1).astype(np.float32)
        self.steps += 1
        terminated = ((np.abs(self.state[:, 0]) > 2.4)
                      | (np.abs(self.state[:, 2]) > 0.2095))
        truncated = (self.steps >= self.max_steps) & ~terminated
        done = terminated | truncated
        reward = np.ones(self.num_envs, np.float32)
        # Final (pre-reset) observations let the caller bootstrap values
        # at time-limit truncations (terminated vs truncated matters for
        # GAE — ref: RLlib's episode truncation handling).
        final_obs = self.state.copy()
        obs = final_obs
        if done.any():
            self.reset(done)
            obs = self.state.copy()
        return obs, reward, done, truncated, final_obs


_ENVS = {"CartPole-v1": CartPoleEnv, "CartPole": CartPoleEnv}


def register_env(name: str, ctor):
    """User env registration (ref: ray.tune.registry.register_env)."""
    _ENVS[name] = ctor


def resolve_env(name_or_ctor):
    """Name → constructor (driver side, so custom registrations travel
    to EnvRunner actors as the pickled ctor, not a name lookup that the
    worker process' registry can't satisfy)."""
    if callable(name_or_ctor):
        return name_or_ctor
    if name_or_ctor not in _ENVS:
        raise ValueError(
            f"unknown env {name_or_ctor!r}; register_env() it first")
    return _ENVS[name_or_ctor]


def make_env(name_or_ctor, num_envs: int = 1, seed: int = 0):
    return resolve_env(name_or_ctor)(num_envs=num_envs, seed=seed)
