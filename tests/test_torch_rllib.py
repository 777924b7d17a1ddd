"""The port's ``rllib`` (``ant_ray_tpu_torch/rllib/``) against the JAX
package's on the CPU.

Inputs come from numpy seeds and weights cross with
``convert.params_from_jax_numpy``; the JAX side runs its own functions
(``rllib`` reaches no Pallas kernel).  Bitwise: CartPole trajectories
for the same actions, ``compute_gae``, the replay buffer.  To 1e-5
relative and 1e-6 absolute: ``vtrace``, and the loss, its metrics and
every gradient leaf of the six losses against ``jax.value_and_grad``.
To rtol 1e-4 / atol 1e-5 (the reference's own DDP tolerance,
tests/test_rllib_depth.py:91): each update step against optax after 5
steps, and one iteration of PPO, IMPALA, APPO, DQN and SAC whose runners
hand both packages the same fragments.  Then the twins of
tests/test_rllib.py's tier-1 tests, on ``device="cpu"``, and the rule
that every entry point raises without a GPU unless given the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ant_ray_tpu.rllib import algorithm as j_algorithm
from ant_ray_tpu.rllib import appo as j_appo
from ant_ray_tpu.rllib import bc as j_bc
from ant_ray_tpu.rllib import dqn as j_dqn
from ant_ray_tpu.rllib import env as j_env
from ant_ray_tpu.rllib import impala as j_impala
from ant_ray_tpu.rllib import ppo as j_ppo
from ant_ray_tpu.rllib import rl_module as j_rl_module
from ant_ray_tpu.rllib import sac as j_sac
from ant_ray_tpu_torch import rllib as t_rllib
from ant_ray_tpu_torch.rllib import algorithm as t_algorithm
from ant_ray_tpu_torch.rllib import appo as t_appo
from ant_ray_tpu_torch.rllib import bc as t_bc
from ant_ray_tpu_torch.rllib import convert
from ant_ray_tpu_torch.rllib import dqn as t_dqn
from ant_ray_tpu_torch.rllib import env as t_env
from ant_ray_tpu_torch.rllib import impala as t_impala
from ant_ray_tpu_torch.rllib import ppo as t_ppo
from ant_ray_tpu_torch.rllib import rl_module as t_rl_module
from ant_ray_tpu_torch.rllib import sac as t_sac

CPU = "cpu"
GRAD_TOL = {"rtol": 1e-5, "atol": 1e-6}
STEP_TOL = {"rtol": 1e-4, "atol": 1e-5}
OBS, ACTIONS, HIDDEN = 4, 2, 32


# ------------------------------------------------------------- helpers

def _named(tree, prefix=""):
    """{path: numpy array} of a tree of numpy arrays, JAX arrays or
    tensors (dicts and lists, as both packages keep them)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_named(tree[key], f"{prefix}{key}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, node in enumerate(tree):
            out.update(_named(node, f"{prefix}{i}."))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("."): tree.detach().cpu().numpy()}
    return {prefix.rstrip("."): np.asarray(tree)}


def _assert_close(got, want, tol):
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """JAX params → the port's tree on the CPU."""
    return convert.params_from_jax_numpy(_numpy(tree), device=CPU)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flat_batch(rng, params, n=96):
    """A PPO minibatch whose behaviour log-probs sit near the policy's."""
    obs = rng.standard_normal((n, OBS)).astype(np.float32)
    actions = rng.integers(0, ACTIONS, n).astype(np.int64)
    logits = np.asarray(j_ppo.policy_logits(params, jnp.asarray(obs)))
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return {"obs": obs, "actions": actions,
            "logp_old": (logp[np.arange(n), actions]
                         + 0.1 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


def _fragment_batch(rng, T=12, N=5):
    """An IMPALA/APPO (T, N) fragment batch."""
    return {"obs": rng.standard_normal((T, N, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACTIONS, (T, N)).astype(np.int64),
            "behavior_logp": np.log(rng.uniform(0.2, 0.8, (T, N))
                                    ).astype(np.float32),
            "rewards": rng.standard_normal((T, N)).astype(np.float32),
            "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
            "bootstrap_obs": rng.standard_normal((N, OBS)
                                                 ).astype(np.float32)}


def _transition_batch(rng, n=64):
    return {"obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACTIONS, n).astype(np.int64),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32)}


def _sac_setup(seed):
    params, policy, critics = j_sac.init_sac_params(
        jax.random.PRNGKey(seed), OBS, ACTIONS, HIDDEN)
    # A temperature off its zero init, and targets apart from the
    # critics, so every term of the losses carries weight.
    params["log_alpha"] = jnp.asarray(-0.3, jnp.float32)
    params["q_target"] = jax.tree.map(
        lambda x: x * 0.9 + 0.01, params["q_target"])
    t_policy = t_rl_module.DiscretePolicyModule(OBS, ACTIONS, hidden=HIDDEN)
    t_critics = t_rl_module.TwinQModule(OBS, ACTIONS, hidden=HIDDEN)
    return params, policy, critics, t_policy, t_critics


SAC_GAMMA, SAC_TARGET_ENTROPY, SAC_TAU = 0.99, 0.7 * float(np.log(2)), 0.05


# ------------------------------------------------------- bitwise copies

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("max_steps", [500, 20])
def test_cartpole_trajectories_are_bitwise_the_reference(seed, max_steps):
    """The same actions give the same observations, rewards, dones,
    truncations and final observations, resets included."""
    j_cls = type("J", (j_env.CartPoleEnv,), {"max_steps": max_steps})
    t_cls = type("T", (t_env.CartPoleEnv,), {"max_steps": max_steps})
    j, t = j_cls(num_envs=6, seed=seed), t_cls(num_envs=6, seed=seed)
    np.testing.assert_array_equal(j.reset(), t.reset())
    rng = np.random.default_rng(seed)
    truncations = 0
    for _ in range(300):
        actions = rng.integers(0, 2, 6)
        j_out, t_out = j.step(actions), t.step(actions)
        for a, b in zip(j_out, t_out):
            np.testing.assert_array_equal(a, b)
        truncations += int(t_out[3].sum())
    assert (truncations > 0) == (max_steps == 20)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_gae_is_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    T, N = 33, 7
    args = (rng.standard_normal((T, N)).astype(np.float32),
            rng.standard_normal((T, N)).astype(np.float32),
            (rng.random((T, N)) < 0.1).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))
    for a, b in zip(j_ppo.compute_gae(*args, gamma=0.99, lam=0.95),
                    t_ppo.compute_gae(*args, gamma=0.99, lam=0.95)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("capacity", [10, 64])
def test_replay_buffer_is_bitwise_the_reference(capacity):
    """Contents through a wrap, and the seeded samples drawn from them."""
    rng = np.random.default_rng(capacity)
    j, t = (j_dqn.ReplayBuffer(capacity, OBS, seed=3),
            t_dqn.ReplayBuffer(capacity, OBS, seed=3))
    for n in (7, 9, 13):
        b = _transition_batch(rng, n)
        args = (b["obs"], b["actions"], b["rewards"], b["next_obs"],
                b["dones"])
        j.add_batch(*args)
        t.add_batch(*args)
        assert len(j) == len(t)
        for name in ("_obs", "_next_obs", "_actions", "_rewards", "_dones"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
        for _ in range(3):
            _assert_close(t.sample(16), j.sample(16), {"rtol": 0, "atol": 0})


# --------------------------------------------------------------- V-trace

@pytest.mark.parametrize("seed,clip_rho,clip_c", [(0, 1.0, 1.0),
                                                  (1, 2.0, 0.5),
                                                  (2, 0.8, 1.2)])
def test_vtrace_matches_the_reference(seed, clip_rho, clip_c):
    rng = np.random.default_rng(seed)
    T, N = 17, 6
    args = [rng.standard_normal((T, N)).astype(np.float32) * 0.4,
            rng.standard_normal((T, N)).astype(np.float32) * 0.4,
            rng.standard_normal((T, N)).astype(np.float32),
            rng.standard_normal((T, N)).astype(np.float32),
            rng.standard_normal(N).astype(np.float32),
            (rng.random((T, N)) < 0.2).astype(np.float32)]
    kw = {"gamma": 0.95, "clip_rho": clip_rho, "clip_c": clip_c}
    want = j_impala.vtrace(*map(jnp.asarray, args), **kw)
    got = t_impala.vtrace(*map(torch.as_tensor, args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


# ------------------------------------------------- losses and gradients

def _loss_case(name, seed):
    """(jax_fn, jax_params, port_fn, port_params) where fn(params) is
    (loss, metrics) on one seeded batch."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    if name == "ppo":
        params = j_ppo.init_policy(key, OBS, ACTIONS, HIDDEN)
        batch = _flat_batch(rng, params)
        kw = {"clip": 0.2, "vf_coeff": 0.5, "ent_coeff": 0.01}
        return (lambda p: j_ppo.ppo_loss(p, _jnp(batch), **kw), params,
                lambda p: t_ppo.ppo_loss(p, _torch(batch), **kw))
    if name in ("impala", "appo"):
        params = j_ppo.init_policy(key, OBS, ACTIONS, HIDDEN)
        batch = _fragment_batch(rng)
        kw = {"gamma": 0.97, "vf_coeff": 0.5, "ent_coeff": 0.01,
              "clip_rho": 1.0, "clip_c": 1.0}
        if name == "impala":
            return (lambda p: j_impala.impala_loss(p, _jnp(batch), **kw),
                    params,
                    lambda p: t_impala.impala_loss(p, _torch(batch), **kw))
        kw["clip"] = 0.3
        return (lambda p: j_appo.appo_loss(p, _jnp(batch), **kw), params,
                lambda p: t_appo.appo_loss(p, _torch(batch), **kw))
    if name.startswith("dqn"):
        params = j_dqn.init_qnet(key, OBS, ACTIONS, HIDDEN)
        target = j_dqn.init_qnet(jax.random.PRNGKey(seed + 100), OBS,
                                 ACTIONS, HIDDEN)
        batch = _transition_batch(rng)
        # Scaled rewards put TD errors on both sides of Huber's kink.
        batch["rewards"] = batch["rewards"] * 2.0
        kw = {"gamma": 0.99, "double": name == "dqn_double"}
        t_target = _port(target)
        return (lambda p: j_dqn.dqn_loss(p, target, _jnp(batch), **kw),
                params,
                lambda p: t_dqn.dqn_loss(p, t_target, _torch(batch), **kw))
    if name == "sac":
        params, policy, critics, t_policy, t_critics = _sac_setup(seed)
        batch = _transition_batch(rng)
        kw = {"gamma": SAC_GAMMA, "target_entropy": SAC_TARGET_ENTROPY}
        return (lambda p: j_sac.sac_losses(p, _jnp(batch), policy, critics,
                                           **kw), params,
                lambda p: t_sac.sac_losses(p, _torch(batch), t_policy,
                                           t_critics, **kw))
    assert name == "bc"
    spec = {"hidden": HIDDEN}
    j_module = j_rl_module.DiscretePolicyModule(OBS, ACTIONS, **spec)
    t_module = t_rl_module.DiscretePolicyModule(OBS, ACTIONS, **spec)
    params = j_module.init_params(key)
    batch = {"obs": rng.standard_normal((80, OBS)).astype(np.float32),
             "actions": rng.integers(0, ACTIONS, 80).astype(np.int64)}
    return (lambda p: j_bc.bc_loss(j_module, p, _jnp(batch)), params,
            lambda p: t_bc.bc_loss(t_module, p, _torch(batch)))


LOSSES = ["ppo", "impala", "appo", "dqn_double", "dqn_single", "sac", "bc"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_every_gradient_leaf_match_jax(name):
    j_fn, j_params, t_fn = _loss_case(name, seed=LOSSES.index(name))
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        j_fn, has_aux=True)(j_params)
    t_loss, t_metrics, t_grads = t_ppo.value_and_grad(
        lambda p: t_fn(p), _port(j_params))
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss),
                               **GRAD_TOL)
    _assert_close(t_metrics, j_metrics, GRAD_TOL)
    _assert_close(t_grads, j_grads, GRAD_TOL)
    if name == "sac":
        assert not any(np.asarray(x).any()
                       for x in jax.tree.leaves(j_grads["q_target"]))


# ------------------------------------------------ update steps vs optax

STEPS = 5


def _run_steps(name, seed=11):
    """(port params, JAX params) after STEPS updates from the same
    weights on the same seeded batches."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    lr = 3e-3
    j_opt, t_opt = optax.adam(lr), t_ppo.Adam(lr)
    if name == "ppo":
        kw = {"clip": 0.2, "vf_coeff": 0.5, "ent_coeff": 0.01}
        j_step = j_ppo.make_update_step(j_opt, **kw)
        t_step = t_ppo.make_update_step(t_opt, **kw)
        j_params = j_ppo.init_policy(key, OBS, ACTIONS, HIDDEN)
        batches = [_flat_batch(rng, j_params) for _ in range(STEPS)]
    elif name in ("impala", "appo"):
        kw = {"gamma": 0.97, "vf_coeff": 0.5, "ent_coeff": 0.01,
              "clip_rho": 1.0, "clip_c": 1.0}
        if name == "appo":
            kw["clip"] = 0.3
        j_mod, t_mod = ((j_impala, t_impala) if name == "impala"
                        else (j_appo, t_appo))
        j_step = j_mod.make_update_step(j_opt, **kw)
        t_step = t_mod.make_update_step(t_opt, **kw)
        j_params = j_ppo.init_policy(key, OBS, ACTIONS, HIDDEN)
        batches = [_fragment_batch(rng) for _ in range(STEPS)]
    elif name == "dqn":
        j_params = j_dqn.init_qnet(key, OBS, ACTIONS, HIDDEN)
        target = j_dqn.init_qnet(jax.random.PRNGKey(seed + 1), OBS,
                                 ACTIONS, HIDDEN)
        t_target = _port(target)
        j_inner = j_dqn.make_update_step(j_opt, gamma=0.99)
        t_inner = t_dqn.make_update_step(t_opt, gamma=0.99)

        def j_step(p, s, b):
            return j_inner(p, s, target, b)

        def t_step(p, s, b):
            return t_inner(p, s, t_target, b)
        batches = [_transition_batch(rng) for _ in range(STEPS)]
    elif name == "sac":
        j_params, policy, critics, t_policy, t_critics = _sac_setup(seed)
        kw = {"gamma": SAC_GAMMA, "target_entropy": SAC_TARGET_ENTROPY,
              "tau": SAC_TAU}
        j_step = j_sac.make_update_step(j_opt, policy, critics, **kw)
        t_step = t_sac.make_update_step(t_opt, t_policy, t_critics, **kw)
        batches = [_transition_batch(rng) for _ in range(STEPS)]
    j_state = j_opt.init(j_params)
    t_params = _port(j_params)
    t_state = t_opt.init(t_sac.trained(t_params) if name == "sac"
                         else t_params)
    for batch in batches:
        j_params, j_state, _ = j_step(j_params, j_state, _jnp(batch))
        t_params, t_state, _ = t_step(t_params, t_state, _torch(batch))
    return t_params, j_params


@pytest.mark.parametrize("name", ["ppo", "impala", "appo", "dqn", "sac"])
def test_update_step_matches_optax_after_five_steps(name):
    t_params, j_params = _run_steps(name)
    _assert_close(t_params, j_params, STEP_TOL)


def test_learner_matches_the_reference_after_five_steps():
    """The port's Learner (BC's loss) against the JAX package's, from
    the same weights: five autograd steps against five jitted ones."""
    rng = np.random.default_rng(5)
    spec_kw = {"hidden": HIDDEN}
    j_spec = j_rl_module.RLModuleSpec(j_rl_module.DiscretePolicyModule,
                                      OBS, ACTIONS, spec_kw)
    t_spec = t_rl_module.RLModuleSpec(t_rl_module.DiscretePolicyModule,
                                      OBS, ACTIONS, spec_kw)
    from ant_ray_tpu.rllib.learner_group import Learner as JLearner

    j = JLearner(j_spec, j_bc.bc_loss, lr=1e-2, seed=4)
    t = t_rllib.Learner(t_spec, t_bc.bc_loss, lr=1e-2, seed=4, device=CPU)
    t.set_weights(j.get_weights())
    for _ in range(STEPS):
        batch = {"obs": rng.standard_normal((64, OBS)).astype(np.float32),
                 "actions": rng.integers(0, ACTIONS, 64).astype(np.int64)}
        j_metrics, t_metrics = j.update(batch), t.update(batch)
        assert sorted(j_metrics) == sorted(t_metrics)
    _assert_close(t.get_weights(), j.get_weights(), STEP_TOL)


# ------------------------------------------------------ the whole slice

def _same_fragments(j_algo, t_algo):
    """Weights from the JAX algorithm's to the port's; the samples one
    round of the JAX runners gives; both algorithms' runners then hand
    those samples back."""
    t_algo.set_weights(j_algo.get_weights())
    j_algo._runner_call("set_weights", j_algo.params)
    epsilon = getattr(j_algo, "epsilon", None)
    samples = (j_algo._runner_call("sample") if epsilon is None
               else j_algo._runner_call("sample", epsilon))

    def fixed(method, *_args):
        return samples if method == "sample" else None

    j_algo._runner_call = fixed
    t_algo._runner_call = fixed
    return samples


SLICE = {
    "ppo": (j_algorithm.PPOConfig, t_algorithm.PPOConfig,
            {"num_epochs": 2, "minibatch_size": 64}),
    "impala": (j_algorithm.IMPALAConfig, t_algorithm.IMPALAConfig, {}),
    "appo": (j_appo.APPOConfig, t_appo.APPOConfig, {}),
    "dqn": (j_algorithm.DQNConfig, t_algorithm.DQNConfig,
            {"learning_starts": 64, "num_updates_per_iteration": 10,
             "target_update_freq": 4, "train_batch_size": 32}),
    "sac": (j_sac.SACConfig, t_sac.SACConfig,
            {"learning_starts": 64, "num_updates_per_iteration": 6,
             "train_batch_size": 32}),
}


@pytest.mark.parametrize("name", list(SLICE))
def test_one_iteration_matches_the_reference_on_the_same_fragments(name):
    j_cls, t_cls, extra = SLICE[name]
    kw = {"seed": 0, "lr": 3e-3, "hidden": HIDDEN, **extra}
    runners = {"num_env_runners": 2, "num_envs_per_env_runner": 4,
               "rollout_fragment_length": 24}
    j_algo = j_cls().env_runners(**runners).training(**kw).build()
    t_algo = t_cls(device=CPU).env_runners(**runners).training(**kw).build()
    _same_fragments(j_algo, t_algo)
    j_result, t_result = j_algo.train(), t_algo.train()
    _assert_close(t_algo.get_weights(), j_algo.get_weights(), STEP_TOL)
    if name == "dqn":
        assert t_algo._update_steps == j_algo._update_steps == 10
        _assert_close(t_algo._target_params, j_algo._target_params,
                      STEP_TOL)
    for key in ("training_iteration", "num_episodes",
                "num_env_steps_sampled"):
        assert t_result[key] == j_result[key], key
    assert sorted(t_result["learner"]) == sorted(j_result["learner"])
    np.testing.assert_allclose(t_result["learner"]["total_loss"],
                               j_result["learner"]["total_loss"], **STEP_TOL)


# ---------------------------------------------- convert and the device

def test_params_from_jax_numpy_keeps_trees_and_checks_shapes():
    params = _numpy(j_sac.init_sac_params(jax.random.PRNGKey(0), OBS,
                                          ACTIONS, HIDDEN)[0])
    got = convert.params_from_jax_numpy(params, device=CPU)
    _assert_close(got, params, {"rtol": 0, "atol": 0})
    assert all(t.dtype == torch.float32 for t in t_ppo.tree_leaves(got))
    qnet = _numpy(j_dqn.init_qnet(jax.random.PRNGKey(1), OBS, ACTIONS))
    assert isinstance(convert.params_from_jax_numpy(qnet, device=CPU), list)
    bad = _numpy(j_ppo.init_policy(jax.random.PRNGKey(2), OBS, ACTIONS))
    bad["pi"][1]["w"] = bad["pi"][1]["w"].T[:5]
    with pytest.raises(ValueError, match=r"pi\[1\]"):
        convert.params_from_jax_numpy(bad, device=CPU)
    bad = _numpy(j_ppo.init_policy(jax.random.PRNGKey(2), OBS, ACTIONS))
    bad["vf"][2]["b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match=r"vf\[2\]"):
        convert.params_from_jax_numpy(bad, device=CPU)


ENTRY_POINTS = {
    "PPO": lambda: t_rllib.PPOConfig().build(),
    "DQN": lambda: t_rllib.DQNConfig().build(),
    "IMPALA": lambda: t_rllib.IMPALAConfig().build(),
    "APPO": lambda: t_rllib.APPOConfig().build(),
    "SAC": lambda: t_rllib.SACConfig().build(),
    "BC": lambda: t_rllib.BC(obs_dim=OBS, n_actions=ACTIONS),
    "LearnerGroup": lambda: t_rllib.LearnerGroup(
        t_rllib.RLModuleSpec(t_rllib.DiscretePolicyModule, OBS, ACTIONS),
        t_bc.bc_loss),
    "init_policy": lambda: t_ppo.init_policy(0, OBS, ACTIONS),
    "module": lambda: t_rllib.TwinQModule(OBS, ACTIONS).init_params(0),
    "convert": lambda: convert.params_from_jax_numpy(
        _numpy(j_dqn.init_qnet(jax.random.PRNGKey(0), OBS, ACTIONS))),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_raise_without_a_gpu(name, monkeypatch):
    """No silent CPU fallback: with no GPU and no ``device="cpu"``, every
    entry point raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


# ------------------------------------------ tests/test_rllib.py twins

def test_vector_env_contract():
    env = t_env.CartPoleEnv(num_envs=5, seed=1)
    obs = env.reset()
    assert obs.shape == (5, 4)
    for _ in range(10):
        obs, reward, done, truncated, final_obs = env.step(
            np.ones(5, np.int64))
        assert obs.shape == (5, 4)
        assert reward.shape == (5,)
        assert done.dtype == bool
        assert final_obs.shape == (5, 4)
        assert not truncated.any()  # too early for time limits


def test_gae_matches_manual():
    rewards = np.array([[1.0], [1.0], [1.0]], np.float32)
    values = np.array([[0.5], [0.5], [0.5]], np.float32)
    dones = np.zeros((3, 1), np.float32)
    last = np.array([0.5], np.float32)
    adv, ret = t_ppo.compute_gae(rewards, values, dones, last,
                                 gamma=0.9, lam=1.0)
    # With lam=1 this is discounted-return minus value.
    expected_ret3 = 1.0 + 0.9 * 0.5
    expected_ret2 = 1.0 + 0.9 * expected_ret3 - 0.9 * 0.5 + 0.9 * 0.5
    assert ret.shape == (3, 1)
    assert np.isclose(ret[2, 0], expected_ret3, atol=1e-5)
    assert np.isclose(ret[1, 0], expected_ret2, atol=1e-5)


def test_checkpoint_roundtrip(tmp_path):
    algo = t_rllib.PPOConfig(device=CPU).env_runners(
        num_env_runners=1, num_envs_per_env_runner=2,
        rollout_fragment_length=8).training(seed=5).build()
    algo.train()
    path = str(tmp_path / "ckpt.pkl")
    algo.save(path)
    restored = type(algo).restore(path)
    a = t_ppo.tree_leaves(algo.get_weights())
    b = t_ppo.tree_leaves(restored.get_weights())
    assert all(np.allclose(x, y) for x, y in zip(a, b))
    assert restored._iteration == 1
    assert restored._opt_state["count"] == algo._opt_state["count"] > 0


def test_dqn_checkpoint_carries_target_and_counters(tmp_path):
    algo = t_rllib.DQNConfig(device=CPU).env_runners(
        num_env_runners=1, num_envs_per_env_runner=4,
        rollout_fragment_length=16).training(
            learning_starts=32, num_updates_per_iteration=3,
            target_update_freq=100, seed=1).build()
    algo.train()
    algo.train()
    path = str(tmp_path / "dqn.pkl")
    algo.save(path)
    restored = type(algo).restore(path)
    _assert_close(restored.get_weights(), algo.get_weights(),
                  {"rtol": 0, "atol": 0})
    _assert_close(restored._target_params, algo._target_params,
                  {"rtol": 0, "atol": 0})
    assert (restored._env_steps, restored._update_steps,
            restored.epsilon) == (algo._env_steps, algo._update_steps,
                                  algo.epsilon)


def test_training_rejects_unknown_kwargs():
    with pytest.raises(ValueError, match="unknown training option"):
        t_rllib.PPOConfig().training(entropy_coef=0.0)


def test_get_weights_survives_training():
    algo = t_rllib.PPOConfig(device=CPU).env_runners(
        num_env_runners=1, num_envs_per_env_runner=2,
        rollout_fragment_length=8).training(seed=2).build()
    w = algo.get_weights()
    before = [x.copy() for x in t_ppo.tree_leaves(w)]
    algo.train()  # the in-place update must not reach the handed-out copy
    assert all(np.isfinite(x).all() for x in t_ppo.tree_leaves(w))
    assert all(np.array_equal(x, y)
               for x, y in zip(t_ppo.tree_leaves(w), before))


def test_vtrace_matches_numpy_oracle():
    """V-trace's loop over T vs a direct numpy recursion of IMPALA eq. 1."""
    rng = np.random.RandomState(0)
    T, N = 6, 3
    gamma, rho_bar, c_bar = 0.9, 1.0, 1.0
    b_logp = rng.randn(T, N).astype(np.float32) * 0.3
    t_logp = rng.randn(T, N).astype(np.float32) * 0.3
    rewards = rng.randn(T, N).astype(np.float32)
    values = rng.randn(T, N).astype(np.float32)
    boot = rng.randn(N).astype(np.float32)
    dones = (rng.rand(T, N) < 0.2).astype(np.float32)

    vs, pg_adv = t_impala.vtrace(
        *map(torch.as_tensor, (b_logp, t_logp, rewards, values, boot,
                               dones)),
        gamma=gamma, clip_rho=rho_bar, clip_c=c_bar)

    rho = np.minimum(rho_bar, np.exp(t_logp - b_logp))
    c = np.minimum(c_bar, np.exp(t_logp - b_logp))
    disc = gamma * (1.0 - dones)
    next_v = np.concatenate([values[1:], boot[None]], axis=0)
    delta = rho * (rewards + disc * next_v - values)
    acc = np.zeros(N, np.float32)
    vs_np = np.zeros((T, N), np.float32)
    for t in range(T - 1, -1, -1):
        acc = delta[t] + disc[t] * c[t] * acc
        vs_np[t] = acc + values[t]
    np.testing.assert_allclose(vs.numpy(), vs_np, rtol=1e-4, atol=1e-4)
    next_vs = np.concatenate([vs_np[1:], boot[None]], axis=0)
    pg_np = rho * (rewards + disc * next_vs - values)
    np.testing.assert_allclose(pg_adv.numpy(), pg_np, rtol=1e-4, atol=1e-4)


def test_dqn_double_q_target_math():
    """Double-Q target: online net argmax, target net evaluation."""
    params = t_dqn.init_qnet(0, 4, 2, device=CPU)
    target = t_dqn.init_qnet(1, 4, 2, device=CPU)
    rng = np.random.RandomState(0)
    batch = _torch({
        "obs": rng.rand(16, 4).astype(np.float32),
        "actions": rng.randint(0, 2, 16).astype(np.int64),
        "rewards": rng.rand(16).astype(np.float32),
        "next_obs": rng.rand(16, 4).astype(np.float32),
        "dones": (rng.rand(16) < 0.3).astype(np.float32),
    })
    loss, metrics = t_dqn.dqn_loss(params, target, batch, gamma=0.99,
                                   double=True)
    with torch.no_grad():
        q = t_dqn.q_values(params, batch["obs"]).numpy()
        sel = np.argmax(t_dqn.q_values(params, batch["next_obs"]).numpy(),
                        axis=-1)
        q_t = t_dqn.q_values(target, batch["next_obs"]).numpy()
    q_taken = q[np.arange(16), batch["actions"].numpy()]
    tgt = batch["rewards"].numpy() + 0.99 \
        * (1 - batch["dones"].numpy()) * q_t[np.arange(16), sel]
    td = q_taken - tgt
    huber = np.where(np.abs(td) <= 1.0, 0.5 * td ** 2,
                     np.abs(td) - 0.5)
    assert np.isclose(float(loss), huber.mean(), atol=1e-5)
    assert np.isclose(float(metrics["td_error_mean"]),
                      np.abs(td).mean(), atol=1e-5)


def test_replay_buffer_ring_semantics():
    buf = t_dqn.ReplayBuffer(10, obs_dim=2, seed=0)
    obs = np.arange(14, dtype=np.float32).repeat(2).reshape(14, 2)
    buf.add_batch(obs[:7], np.arange(7), np.zeros(7, np.float32),
                  obs[:7], np.zeros(7, np.float32))
    assert len(buf) == 7
    buf.add_batch(obs[7:], np.arange(7, 14), np.zeros(7, np.float32),
                  obs[7:], np.zeros(7, np.float32))
    assert len(buf) == 10  # capacity-bounded; oldest overwritten
    sample = buf.sample(32)
    assert sample["obs"].shape == (32, 2)
    # Entries 0..3 were overwritten by the wrap; only 4..13 remain.
    assert sample["actions"].min() >= 4


def _learning(algo, iterations):
    first, best, result = None, -np.inf, None
    for _ in range(iterations):
        result = algo.train()
        if not np.isnan(result["episode_return_mean"]):
            if first is None:
                first = result["episode_return_mean"]
            best = max(best, result["episode_return_mean"])
    return first, best, result


class _ReferenceDraws:
    """The JAX package's epsilon-greedy draws in the port's DQN runner:
    its key, split per step as the reference's runner splits it, acting
    on the port runner's weights.  Every other part of the loop (the
    env runner, replay, the update, the target sync, the epsilon
    schedule) is the port's."""

    def __init__(self, monkeypatch):
        runner = t_algorithm._DQNRunner
        init = runner.__init__

        def __init__(self, config, index, env_ctor=None):
            init(self, config, index, env_ctor)
            self._key = jax.random.PRNGKey(config.seed * 77 + index)

        def _act(self, obs, epsilon):
            self._key, sub = jax.random.split(self._key)
            params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                  self.params)
            return np.asarray(j_dqn.act(params, obs, sub, epsilon))

        monkeypatch.setattr(runner, "__init__", __init__)
        monkeypatch.setattr(runner, "_act", _act)


def test_dqn_learns_cartpole_inline(monkeypatch):
    """The reference's learning test on the port, from the reference's
    weights and on its exploration draws: the port's loop reproduces
    the reference's run iteration by iteration (returns equal, replay
    equal, weights within 1e-5) and passes the reference's gate.  With
    the port's own torch stream the same seed-0 run is another sample
    of a noisy gate; ``test_dqn_act_is_epsilon_greedy`` holds that
    stream's distribution."""
    _ReferenceDraws(monkeypatch)
    runners = {"num_env_runners": 1, "num_envs_per_env_runner": 8,
               "rollout_fragment_length": 64}
    kw = {"lr": 1e-3, "learning_starts": 500, "buffer_size": 20_000,
          "num_updates_per_iteration": 48, "train_batch_size": 64,
          "target_update_freq": 200, "epsilon_timesteps": 6_000,
          "seed": 0}
    ref = j_algorithm.DQNConfig().environment("CartPole-v1").env_runners(
        **runners).training(**kw).build()
    algo = t_rllib.DQNConfig(device=CPU).environment(
        "CartPole-v1").env_runners(**runners).training(**kw).build()
    algo.set_weights(ref.get_weights())
    first, best, result = None, -np.inf, None
    for _ in range(14):
        want, result = ref.train(), algo.train()
        assert result["episode_return_mean"] == pytest.approx(
            want["episode_return_mean"], nan_ok=True)
        np.testing.assert_array_equal(algo._buffer._actions,
                                      ref._buffer._actions)
        if not np.isnan(result["episode_return_mean"]):
            if first is None:
                first = result["episode_return_mean"]
            best = max(best, result["episode_return_mean"])
    _assert_close(algo.get_weights(), ref.get_weights(), STEP_TOL)
    assert first is not None
    assert best > first + 20, (first, best)
    assert result["replay_buffer_size"] > 500
    assert result["epsilon"] < 1.0


@pytest.mark.parametrize("epsilon", [0.0, 0.3, 1.0])
def test_dqn_act_is_epsilon_greedy(epsilon):
    """The port's own draws: a uniform action with probability epsilon,
    the greedy one otherwise (so greedy with probability 1 - eps/2 at
    two actions)."""
    params = t_dqn.init_qnet(0, OBS, ACTIONS, device=CPU)
    obs = torch.randn(20_000, OBS, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    actions = t_dqn.act(params, obs, gen, epsilon)
    greedy = torch.argmax(t_dqn.q_values(params, obs), dim=-1)
    share = (actions == greedy).float().mean().item()
    assert share == pytest.approx(1.0 - epsilon / 2, abs=0.01)
    assert set(actions.tolist()) <= {0, 1}


def test_categorical_draws_follow_the_softmax():
    """Gumbel-max from a generator, ``jax.random.categorical``'s method:
    frequencies match the softmax at 200k draws a row."""
    logits = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, -1.0],
                           [-3.0, 1.0, 0.5]])
    gen = torch.Generator().manual_seed(0)
    draws = t_ppo.categorical(gen, logits.expand(200_000, 3, 3))
    freq = torch.stack([(draws == a).float().mean(0) for a in range(3)], 1)
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits, -1).numpy(), atol=4e-3)


def test_impala_learns_cartpole_inline():
    algo = t_rllib.IMPALAConfig(device=CPU).environment(
        "CartPole-v1").env_runners(
        num_env_runners=2, num_envs_per_env_runner=8,
        rollout_fragment_length=128,
    ).training(lr=1e-3, num_sgd_iter=2, entropy_coeff=0.01,
               seed=0).build()
    first, best, _ = _learning(algo, 14)
    assert first is not None
    assert best > first + 30, (first, best)


# ------------------------------ tests/test_rllib.py's slow tests' twins

@pytest.fixture
def shutdown_only():
    yield None
    import ant_ray_tpu_torch as tart

    tart.shutdown()


@pytest.mark.slow
def test_ppo_learns_cartpole_inline():
    algo = t_rllib.PPOConfig(device=CPU).environment(
        "CartPole-v1").env_runners(
        num_env_runners=2, num_envs_per_env_runner=8,
        rollout_fragment_length=128,
    ).training(lr=1e-3, num_epochs=6, minibatch_size=256,
               seed=0).build()
    first, best, result = _learning(algo, 12)
    assert first is not None, "no episodes completed"
    assert best > first + 20, (first, best)  # clear learning signal
    assert np.isfinite(result["learner"]["total_loss"])


@pytest.mark.slow
def test_env_runners_as_actors(shutdown_only):
    import ant_ray_tpu_torch as tart

    tart.init(num_cpus=3)
    algo = t_rllib.PPOConfig(device=CPU).env_runners(
        num_env_runners=2, num_envs_per_env_runner=4,
        rollout_fragment_length=16).training(seed=3).build()
    result = algo.train()
    assert result["num_env_steps_sampled"] == 16 * 8
    algo.stop()


@pytest.mark.slow
def test_custom_env_registration_reaches_actors(shutdown_only):
    import ant_ray_tpu_torch as tart

    tart.init(num_cpus=3)

    class TinyCartPole(t_env.CartPoleEnv):
        max_steps = 20

    t_rllib.register_env("TinyCartPole", TinyCartPole)
    algo = t_rllib.PPOConfig(device=CPU).environment(
        "TinyCartPole").env_runners(
        num_env_runners=2, num_envs_per_env_runner=2,
        rollout_fragment_length=8).training(seed=9).build()
    result = algo.train()  # would ValueError in the actor if name-based
    assert result["num_env_steps_sampled"] == 8 * 4
    algo.stop()


@pytest.mark.slow
def test_dqn_runners_as_actors(shutdown_only):
    import ant_ray_tpu_torch as tart

    tart.init(num_cpus=2)
    algo = t_rllib.DQNConfig(device=CPU).env_runners(
        num_env_runners=2, num_envs_per_env_runner=4,
        rollout_fragment_length=32,
    ).training(learning_starts=200, num_updates_per_iteration=8).build()
    result = algo.train()
    assert result["num_env_steps_sampled"] == 2 * 4 * 32
    algo.stop()
