"""Algorithm façade: config builder → EnvRunner actors + learner
(ref: rllib/algorithms/algorithm.py config/build/train pattern,
EnvRunnerGroup rllib/env/env_runner_group.py, LearnerGroup
rllib/core/learner/learner_group.py:101; the JAX package's
``rllib/algorithm.py``).

``Algorithm.train()`` is one iteration: gather rollouts from the
runners (actors in a cluster, inline otherwise), compute GAE, run
minibatch PPO epochs in the learner step, hand the new weights back to
the runners.  The learner and the inline runners run on ``config.device``
(the card unless it is ``"cpu"``); weights cross to runner actors as
host copies.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ant_ray_tpu_torch._device import resolve_device


@dataclass(frozen=True)
class PPOConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 256
    hidden: int = 64
    seed: int = 0
    # >1: updates run on a LearnerGroup of learner actors with gradient
    # allreduce (ref: learner_group.py:101 DDP learners).
    num_learners: int = 1
    # Where the learner and the runners compute: None is the current
    # CUDA device (raising without one), "cpu" the CPU.
    device: str | None = None
    extra: dict = field(default_factory=dict)

    # builder-style mutators (RLlib API shape)
    def environment(self, env: str) -> "PPOConfig":
        return replace(self, env=env)

    def env_runners(self, *, num_env_runners: int | None = None,
                    num_envs_per_env_runner: int | None = None,
                    rollout_fragment_length: int | None = None
                    ) -> "PPOConfig":
        out = self
        if num_env_runners is not None:
            out = replace(out, num_env_runners=num_env_runners)
        if num_envs_per_env_runner is not None:
            out = replace(out, num_envs_per_runner=num_envs_per_env_runner)
        if rollout_fragment_length is not None:
            out = replace(out,
                          rollout_fragment_length=rollout_fragment_length)
        return out

    def training(self, **kwargs) -> "PPOConfig":
        unknown = [k for k in kwargs
                   if k not in type(self).__dataclass_fields__]
        if unknown:
            raise ValueError(
                f"unknown training option(s) {unknown}; valid: "
                f"{sorted(type(self).__dataclass_fields__)}")
        return replace(self, **kwargs)

    def learners(self, *, num_learners: int) -> "PPOConfig":
        """Scale the update across N learner actors (ref:
        AlgorithmConfig.learners)."""
        return replace(self, num_learners=num_learners)

    def build(self) -> "Algorithm":
        return Algorithm(self)


def _episode_result(samples) -> dict:
    returns = [r for s in samples for r in s["episode_returns"]]
    return {"episode_return_mean": (float(np.mean(returns))
                                    if returns else float("nan")),
            "num_episodes": len(returns)}


class _EnvRunner:
    """Actor: owns env copies + a policy snapshot; samples fragments
    (ref: rllib/env/single_agent_env_runner.py)."""

    def __init__(self, config: PPOConfig, index: int, env_ctor=None):
        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

        self._ppo = ppo
        self.config = config
        self.device = resolve_device(config.device)
        # env_ctor travels from the driver so custom register_env()
        # entries work inside actor processes too.
        ctor = env_ctor or env_mod.resolve_env(config.env)
        self.env = ctor(num_envs=config.num_envs_per_runner,
                        seed=config.seed * 1000 + index)
        self.obs = self.env.reset()
        self.params = None
        self._gen = ppo.generator(config.seed * 77 + index, self.device)
        self._episode_returns = np.zeros(
            config.num_envs_per_runner, np.float32)
        self._completed: list[float] = []

    def set_weights(self, params):
        self.params = self._ppo.to_device(params, self.device)

    def _on_device(self, array):
        return torch.as_tensor(array, device=self.device)

    def sample(self) -> dict:
        """One fragment: (T, N) arrays + completed-episode returns."""
        ppo, cfg = self._ppo, self.config
        T = cfg.rollout_fragment_length
        N = cfg.num_envs_per_runner
        obs_buf = np.zeros((T, N, self.env.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int64)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        for t in range(T):
            actions, logp, vals = ppo.act(
                self.params, self._on_device(self.obs), self._gen)
            actions = actions.cpu().numpy()
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logp.cpu().numpy()
            val_buf[t] = vals.cpu().numpy()
            self.obs, raw_reward, done, truncated, final_obs = \
                self.env.step(actions)
            reward = raw_reward
            if truncated.any():
                # Time-limit truncation is not termination: bootstrap
                # the cut-off return with V(final state) so the value
                # targets stay consistent (ref: RLlib truncation
                # handling in GAE).
                with torch.no_grad():
                    boot = ppo.value(self.params,
                                     self._on_device(final_obs))
                reward = raw_reward + cfg.gamma * boot.cpu().numpy() \
                    * truncated
            rew_buf[t] = reward
            done_buf[t] = done
            self._episode_returns += raw_reward
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
        with torch.no_grad():
            last_values = ppo.value(self.params,
                                    self._on_device(self.obs)).cpu().numpy()
        completed, self._completed = self._completed, []
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "values": val_buf, "rewards": rew_buf, "dones": done_buf,
                "last_values": last_values,
                # post-fragment obs: V-trace bootstraps from V(s_T)
                "last_obs": self.obs.copy(),
                "episode_returns": completed}


def _ppo_loss_builder(module, params, batch, *, clip, vf_coeff, ent_coeff):
    from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

    return ppo.ppo_loss(params, batch, clip=clip, vf_coeff=vf_coeff,
                        ent_coeff=ent_coeff)


class Algorithm:
    """Driver-side controller (one learner; EnvRunners as actors when a
    cluster is up, inline otherwise — mirroring RLlib local mode)."""

    def __init__(self, config: PPOConfig):
        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

        self._ppo = ppo
        self.config = config
        self.device = resolve_device(config.device)
        probe = env_mod.make_env(config.env, num_envs=1)
        self._obs_dim, self._n_actions = probe.obs_dim, probe.n_actions
        self.params = ppo.init_policy(config.seed, self._obs_dim,
                                      self._n_actions, config.hidden,
                                      self.device)
        self._optimizer = ppo.Adam(config.lr)
        self._opt_state = self._optimizer.init(self.params)
        self._update = ppo.make_update_step(
            self._optimizer, clip=config.clip_param,
            vf_coeff=config.vf_loss_coeff,
            ent_coeff=config.entropy_coeff)
        self._iteration = 0
        self._rng = np.random.RandomState(config.seed)

        # Multi-learner mode: the update runs on a LearnerGroup of
        # actors with gradient allreduce; this driver only shuffles
        # minibatches and syncs weights to the env runners.
        self._learners = None
        if getattr(config, "num_learners", 1) > 1:
            from ant_ray_tpu_torch.rllib.learner_group import LearnerGroup  # noqa: PLC0415
            from ant_ray_tpu_torch.rllib.rl_module import (  # noqa: PLC0415
                DiscretePolicyModule,
                RLModuleSpec,
            )

            spec = RLModuleSpec(
                DiscretePolicyModule, self._obs_dim, self._n_actions,
                {"hidden": config.hidden, "value_head": True})
            self._learners = LearnerGroup(
                spec, functools.partial(
                    _ppo_loss_builder, clip=config.clip_param,
                    vf_coeff=config.vf_loss_coeff,
                    ent_coeff=config.entropy_coeff),
                num_learners=config.num_learners,
                lr=config.lr, seed=config.seed, device=config.device)
            self.params = ppo.copy_to_device(
                self._learners.get_weights(), self.device)

        self._runners = self._make_runners()

    _runner_cls = _EnvRunner

    def _make_runners(self):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415

        cfg = self.config
        ctor = env_mod.resolve_env(cfg.env)
        base = type(self)._runner_cls
        if art.is_initialized():
            runner_cls = art.remote(base)
            return [runner_cls.remote(cfg, i, ctor)
                    for i in range(cfg.num_env_runners)]
        return [base(cfg, i, ctor)
                for i in range(cfg.num_env_runners)]

    def _runner_call(self, method: str, *args):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        if art.is_initialized():
            return art.get([getattr(r, method).remote(*args)
                            for r in self._runners], timeout=600)
        return [getattr(r, method)(*args) for r in self._runners]

    def _sync_runners(self) -> None:
        """The learner's weights to every runner: the live tensors to an
        inline runner, a host copy to an actor."""
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        weights = (self.get_weights() if art.is_initialized()
                   else self.params)
        self._runner_call("set_weights", weights)

    def train(self) -> dict:
        """One iteration; returns an RLlib-shaped result dict."""
        ppo, cfg = self._ppo, self.config
        self._sync_runners()
        samples = self._runner_call("sample")

        # concat runner fragments along the env axis: (T, N_total)
        def cat(key_):
            return np.concatenate([s[key_] for s in samples], axis=1)

        rewards, values, dones = cat("rewards"), cat("values"), cat("dones")
        last_values = np.concatenate(
            [s["last_values"] for s in samples], axis=0)
        adv, returns = ppo.compute_gae(
            rewards, values, dones, last_values,
            gamma=cfg.gamma, lam=cfg.lambda_)
        flat = {
            "obs": cat("obs").reshape(-1, self._obs_dim),
            "actions": cat("actions").reshape(-1),
            "logp_old": cat("logp").reshape(-1),
            "advantages": adv.reshape(-1),
            "returns": returns.reshape(-1),
        }
        # One host-to-device copy per iteration; minibatches are
        # gathered on the device.
        on_device = (None if self._learners is not None
                     else ppo.to_device(flat, self.device))
        n = flat["obs"].shape[0]
        metrics = {}
        for _epoch in range(cfg.num_epochs):
            perm = self._rng.permutation(n)
            for lo in range(0, n, cfg.minibatch_size):
                idx = perm[lo:lo + cfg.minibatch_size]
                if len(idx) < cfg.minibatch_size and n > cfg.minibatch_size:
                    continue  # ragged tail, as the JAX package skips it
                if self._learners is not None:
                    metrics = self._learners.update_from_batch(
                        {k: v[idx] for k, v in flat.items()})
                    continue
                rows = torch.as_tensor(idx, device=self.device)
                batch = {k: v.index_select(0, rows)
                         for k, v in on_device.items()}
                self.params, self._opt_state, metrics = self._update(
                    self.params, self._opt_state, batch)
        if self._learners is not None:
            self.params = ppo.copy_to_device(
                self._learners.get_weights(), self.device)

        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            **_episode_result(samples),
            "num_env_steps_sampled": n,
            "learner": {k: float(v) for k, v in metrics.items()},
        }

    def get_weights(self):
        """Host copy (numpy): the update runs in place on the live
        tensors, so handing those out would let the next step change
        what the caller holds."""
        return self._ppo.to_numpy(self.params)

    def set_weights(self, params):
        self.params = self._ppo.copy_to_device(params, self.device)
        if getattr(self, "_learners", None) is not None:
            # The group holds the authoritative training copy — without
            # this, the next train() would overwrite the new weights
            # with the group's old ones.  (Optimizer moments reset on
            # restore in multi-learner mode.)
            self._learners.set_weights(self._ppo.to_numpy(self.params))

    def save(self, path: str):
        """Host copies of the params and Adam's state, so a checkpoint
        taken on the card restores on either device."""
        import pickle  # noqa: PLC0415

        with open(path, "wb") as f:
            pickle.dump({"params": self.get_weights(),
                         "opt_state": self._ppo.opt_state_to_numpy(
                             self._opt_state),
                         "iteration": self._iteration,
                         "config": self.config}, f)

    @classmethod
    def restore(cls, path: str) -> "Algorithm":
        import pickle  # noqa: PLC0415

        with open(path, "rb") as f:
            state = pickle.load(f)
        algo = cls(state["config"])
        algo.set_weights(state["params"])  # reaches the LearnerGroup too
        algo._opt_state = algo._ppo.opt_state_to_device(
            state["opt_state"], algo.device)
        algo._iteration = state["iteration"]
        return algo

    def stop(self):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        if getattr(self, "_learners", None) is not None:
            self._learners.shutdown()
        if art.is_initialized():
            for r in self._runners:
                try:
                    art.kill(r)
                except Exception:  # noqa: BLE001
                    pass
        self._runners = []


# --------------------------------------------------------------------- DQN

@dataclass(frozen=True)
class DQNConfig(PPOConfig):
    """Off-policy Q-learning config (ref: rllib/algorithms/dqn/dqn.py
    DQNConfig — same builder surface as PPOConfig; PPO-only fields are
    inherited but unused)."""

    lr: float = 1e-3
    buffer_size: int = 50_000
    train_batch_size: int = 64
    num_updates_per_iteration: int = 32
    learning_starts: int = 1_000
    target_update_freq: int = 500          # in update steps
    double_q: bool = True
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_timesteps: int = 10_000        # env steps to anneal over

    def build(self) -> "DQN":
        return DQN(self)


class _DQNRunner:
    """Actor: epsilon-greedy transition collection
    (ref: rllib env runner in off-policy mode)."""

    def __init__(self, config: DQNConfig, index: int, env_ctor=None):
        from ant_ray_tpu_torch.rllib import dqn  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

        self._dqn = dqn
        self._ppo = ppo
        self.config = config
        self.device = resolve_device(config.device)
        ctor = env_ctor or env_mod.resolve_env(config.env)
        self.env = ctor(num_envs=config.num_envs_per_runner,
                        seed=config.seed * 1000 + index)
        self.obs = self.env.reset()
        self.params = None
        self._gen = ppo.generator(config.seed * 77 + index, self.device)
        self._episode_returns = np.zeros(
            config.num_envs_per_runner, np.float32)
        self._completed: list[float] = []

    def set_weights(self, params):
        self.params = self._ppo.to_device(params, self.device)

    def _act(self, obs, epsilon: float) -> np.ndarray:
        """Action-selection hook — subclasses (SAC) override this and
        reuse the whole collection loop below."""
        obs = torch.as_tensor(obs, device=self.device)
        return self._dqn.act(self.params, obs, self._gen,
                             epsilon).cpu().numpy()

    def sample(self, epsilon: float = 0.0) -> dict:
        """One fragment of flat transitions (T·N, ...)."""
        cfg = self.config
        T = cfg.rollout_fragment_length
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        for _ in range(T):
            actions = self._act(self.obs, epsilon)
            obs_l.append(self.obs)
            self.obs, reward, done, truncated, final_obs = \
                self.env.step(actions)
            act_l.append(actions)
            rew_l.append(reward)
            # Q targets bootstrap through time-limit truncations: the
            # transition's next state is the PRE-reset obs and its done
            # flag is termination only (ref: RLlib truncation handling).
            next_l.append(final_obs)
            done_l.append((done & ~truncated).astype(np.float32))
            self._episode_returns += reward
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
        completed, self._completed = self._completed, []
        return {
            "obs": np.concatenate(obs_l, axis=0),
            "actions": np.concatenate(act_l, axis=0),
            "rewards": np.concatenate(rew_l, axis=0),
            "next_obs": np.concatenate(next_l, axis=0),
            "dones": np.concatenate(done_l, axis=0),
            "episode_returns": completed,
        }


class DQN(Algorithm):
    """Double-DQN with uniform replay and hard target sync
    (ref: rllib/algorithms/dqn/)."""

    _runner_cls = _DQNRunner

    def __init__(self, config: DQNConfig):
        from ant_ray_tpu_torch.rllib import dqn  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import ppo  # noqa: PLC0415

        self._ppo = ppo
        self._dqn = dqn
        self.config = config
        self.device = resolve_device(config.device)
        probe = env_mod.make_env(config.env, num_envs=1)
        self._obs_dim, self._n_actions = probe.obs_dim, probe.n_actions
        self.params = dqn.init_qnet(config.seed, self._obs_dim,
                                    self._n_actions, config.hidden,
                                    self.device)
        # A copy, not the same tensors: the update step changes params
        # in place, so the target must own distinct storage.
        self._target_params = ppo.tree_map(torch.clone, self.params)
        self._optimizer = ppo.Adam(config.lr)
        self._opt_state = self._optimizer.init(self.params)
        self._update = dqn.make_update_step(
            self._optimizer, gamma=config.gamma, double=config.double_q)
        self._buffer = dqn.ReplayBuffer(config.buffer_size, self._obs_dim,
                                        seed=config.seed)
        self._learners = None
        self._iteration = 0
        self._env_steps = 0
        self._update_steps = 0
        self._runners = self._make_runners()

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_timesteps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def train(self) -> dict:
        dqn, cfg = self._dqn, self.config
        self._sync_runners()
        samples = self._runner_call("sample", self.epsilon)
        for s in samples:
            self._buffer.add_batch(s["obs"], s["actions"], s["rewards"],
                                   s["next_obs"], s["dones"])
            self._env_steps += len(s["actions"])

        metrics = {}
        if len(self._buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iteration):
                host = self._buffer.sample(cfg.train_batch_size)
                batch = self._ppo.to_device(host, self.device)
                self.params, self._opt_state, metrics = self._update(
                    self.params, self._opt_state, self._target_params,
                    batch)
                self._update_steps += 1
                if self._update_steps % cfg.target_update_freq == 0:
                    self._target_params = self._ppo.tree_map(
                        torch.clone, self.params)

        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            **_episode_result(samples),
            "num_env_steps_sampled": self._env_steps,
            "epsilon": self.epsilon,
            "replay_buffer_size": len(self._buffer),
            "learner": {k: float(v) for k, v in metrics.items()},
        }

    def set_weights(self, params):
        self.params = self._ppo.copy_to_device(params, self.device)
        self._target_params = self._ppo.tree_map(torch.clone, self.params)

    def save(self, path: str):
        """DQN checkpoints carry the full learner state — target net and
        the step counters that drive epsilon/target-sync schedules — so a
        restore RESUMES training rather than re-bootstrapping from an
        untrained target at epsilon 1.0 (replay contents are not
        persisted, matching the reference's default)."""
        import pickle  # noqa: PLC0415

        ppo = self._ppo
        with open(path, "wb") as f:
            pickle.dump({"params": ppo.to_numpy(self.params),
                         "opt_state": ppo.opt_state_to_numpy(
                             self._opt_state),
                         "target_params": ppo.to_numpy(self._target_params),
                         "iteration": self._iteration,
                         "env_steps": self._env_steps,
                         "update_steps": self._update_steps,
                         "config": self.config}, f)

    @classmethod
    def restore(cls, path: str) -> "DQN":
        import pickle  # noqa: PLC0415

        with open(path, "rb") as f:
            state = pickle.load(f)
        algo = cls(state["config"])
        ppo = algo._ppo
        algo.params = ppo.copy_to_device(state["params"], algo.device)
        algo._opt_state = ppo.opt_state_to_device(state["opt_state"],
                                                  algo.device)
        algo._target_params = ppo.copy_to_device(state["target_params"],
                                                 algo.device)
        algo._iteration = state["iteration"]
        algo._env_steps = state["env_steps"]
        algo._update_steps = state["update_steps"]
        return algo


# ------------------------------------------------------------------ IMPALA

@dataclass(frozen=True)
class IMPALAConfig(PPOConfig):
    """V-trace actor-critic config (ref: rllib/algorithms/impala/).
    Collection is synchronous here, but fragments are *reused* across
    ``num_sgd_iter`` passes — V-trace corrects the resulting
    off-policyness exactly as it corrects queue staleness upstream."""

    lr: float = 5e-4
    num_sgd_iter: int = 2
    clip_rho_threshold: float = 1.0
    clip_c_threshold: float = 1.0

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA(Algorithm):
    """V-trace learner over behavior-policy fragments."""

    def __init__(self, config: IMPALAConfig):
        from ant_ray_tpu_torch.rllib import env as env_mod  # noqa: PLC0415
        from ant_ray_tpu_torch.rllib import impala, ppo  # noqa: PLC0415

        self._ppo = ppo
        self._impala = impala
        self.config = config
        self.device = resolve_device(config.device)
        probe = env_mod.make_env(config.env, num_envs=1)
        self._obs_dim, self._n_actions = probe.obs_dim, probe.n_actions
        self.params = ppo.init_policy(config.seed, self._obs_dim,
                                      self._n_actions, config.hidden,
                                      self.device)
        self._optimizer = ppo.Adam(config.lr)
        self._opt_state = self._optimizer.init(self.params)
        self._update = impala.make_update_step(
            self._optimizer, gamma=config.gamma,
            vf_coeff=config.vf_loss_coeff,
            ent_coeff=config.entropy_coeff,
            clip_rho=config.clip_rho_threshold,
            clip_c=config.clip_c_threshold)
        self._learners = None
        self._iteration = 0
        self._env_steps = 0
        self._runners = self._make_runners()

    def train(self) -> dict:
        cfg = self.config
        self._sync_runners()
        samples = self._runner_call("sample")

        def cat(key_, axis=1):
            return np.concatenate([s[key_] for s in samples], axis=axis)

        batch = self._ppo.to_device({
            "obs": cat("obs"),
            "actions": cat("actions"),
            "behavior_logp": cat("logp"),
            "rewards": cat("rewards"),
            "dones": cat("dones"),
            "bootstrap_obs": cat("last_obs", axis=0),
        }, self.device)
        T, N = batch["actions"].shape
        metrics = {}
        for _ in range(cfg.num_sgd_iter):
            self.params, self._opt_state, metrics = self._update(
                self.params, self._opt_state, batch)

        self._env_steps += T * N
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            **_episode_result(samples),
            "num_env_steps_sampled": self._env_steps,
            "learner": {k: float(v) for k, v in metrics.items()},
        }
