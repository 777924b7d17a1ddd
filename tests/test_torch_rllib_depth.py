"""The port's RLModule, LearnerGroup, BC and offline data against the
JAX package's: the twins of tests/test_rllib_depth.py's tier-1 tests on
``device="cpu"``, and the DDP invariant across the packages — the port's
two learners in a cluster, averaging gradients over gloo, against the
JAX package's single learner on the same batch and weights, after three
updates, to rtol 1e-4 and atol 1e-5 (the reference's own tolerance,
tests/test_rllib_depth.py:91).  The reference's ``slow`` tests have
``slow`` twins here."""

import numpy as np
import pytest
import torch

import ant_ray_tpu_torch as tart
from ant_ray_tpu.rllib import bc as j_bc
from ant_ray_tpu.rllib import learner_group as j_learner_group
from ant_ray_tpu.rllib import rl_module as j_rl_module
from ant_ray_tpu_torch.rllib import (
    APPOConfig,
    BC,
    DiscretePolicyModule,
    LearnerGroup,
    OfflineData,
    PPOConfig,
    RLModuleSpec,
    SACConfig,
    TwinQModule,
)
from ant_ray_tpu_torch.rllib import ppo as t_ppo
from ant_ray_tpu_torch.rllib.bc import bc_loss

CPU = "cpu"


def _toy_dataset(n=512, seed=0):
    """Linearly separable: action = argmax over two fixed projections."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, 4)).astype(np.float32)
    w = np.asarray([[1.0, -1.0], [2.0, 0.5], [-1.0, 1.0], [0.0, 2.0]],
                   np.float32)
    actions = np.argmax(obs @ w, axis=-1).astype(np.int64)
    return obs, actions


@pytest.fixture
def shutdown_only():
    yield None
    tart.shutdown()


# ------------------------------------------------------------- RLModule


def test_rl_module_forward_contract():
    spec = RLModuleSpec(DiscretePolicyModule, 4, 2,
                        {"hidden": 16, "value_head": True})
    module = spec.build()
    params = module.init_params(0, device=CPU)
    obs = torch.zeros((3, 4))
    logits = module.forward_inference(params, obs)
    assert logits.shape == (3, 2)
    actions, aux = module.forward_exploration(
        params, obs, torch.Generator().manual_seed(1))
    assert actions.shape == (3,) and aux["logp"].shape == (3,)
    out = module.forward_train(params, {"obs": obs})
    assert out["values"].shape == (3,)

    twin = TwinQModule(4, 2, hidden=16)
    q_params = twin.init_params(torch.Generator().manual_seed(2), CPU)
    q = twin.forward_train(q_params, {"obs": obs})
    assert q["q1"].shape == (3, 2)
    assert torch.equal(twin.forward_inference(q_params, obs),
                       torch.minimum(q["q1"], q["q2"]))


def test_rl_module_trees_are_the_references():
    """Leaf names and layouts as the JAX package keeps them, so
    ``params_from_jax_numpy`` carries either tree across."""
    import jax

    for cls, config in ((DiscretePolicyModule, {"hidden": 16,
                                                "value_head": True}),
                        (TwinQModule, {"hidden": 16})):
        got = cls(4, 3, **config).init_params(0, device=CPU)
        want = getattr(j_rl_module, cls.__name__)(4, 3, **config
                                                  ).init_params(
            jax.random.PRNGKey(0))
        assert jax.tree.structure(want) == jax.tree.structure(
            t_ppo.tree_map(lambda t: 0, got))
        assert [tuple(x.shape) for x in jax.tree.leaves(want)] == [
            tuple(x.shape) for x in t_ppo.tree_leaves(got)]


# --------------------------------------------------------- LearnerGroup


def test_learner_group_local_bc_learns():
    obs, actions = _toy_dataset()
    bc = BC(obs_dim=4, n_actions=2, hidden=32, lr=1e-2, device=CPU)
    result = bc.train_on_dataset(obs, actions, epochs=20,
                                 minibatch_size=128)
    assert result["accuracy"] > 0.9, result
    bc.stop()


def test_sharded_group_matches_the_reference_single_learner(shutdown_only):
    """The DDP invariant across the packages: the port's 2 learners on
    half-batches, gradients averaged over gloo, against the JAX
    package's 1 learner on the full batch, from the same weights."""
    tart.init(num_cpus=2)
    obs, actions = _toy_dataset(n=256)
    batch = {"obs": obs, "actions": actions}
    config = {"hidden": 16}
    single = j_learner_group.LearnerGroup(
        j_rl_module.RLModuleSpec(j_rl_module.DiscretePolicyModule, 4, 2,
                                 config),
        j_bc.bc_loss, num_learners=1, lr=1e-2, seed=7)
    group = LearnerGroup(RLModuleSpec(DiscretePolicyModule, 4, 2, config),
                         bc_loss, num_learners=2, lr=1e-2, seed=7,
                         device=CPU)
    try:
        group.set_weights(single.get_weights())
        for _ in range(3):
            want = single.update_from_batch(batch)
            got = group.update_from_batch(batch)
            assert sorted(got) == sorted(want)
        import jax

        w_single = jax.tree.leaves(single.get_weights())
        w_group = t_ppo.tree_leaves(group.get_weights())
        assert len(w_single) == len(w_group)
        for a, b in zip(w_group, w_single):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    finally:
        group.shutdown()


def test_sharded_group_rejects_a_batch_smaller_than_the_group(
        shutdown_only):
    tart.init(num_cpus=2)
    group = LearnerGroup(RLModuleSpec(DiscretePolicyModule, 4, 2,
                                      {"hidden": 8}),
                         bc_loss, num_learners=2, device=CPU)
    try:
        with pytest.raises(ValueError, match="cannot shard"):
            group.update_from_batch({"obs": np.zeros((1, 4), np.float32),
                                     "actions": np.zeros(1, np.int64)})
    finally:
        group.shutdown()


def test_learner_group_needs_a_cluster_above_one_learner():
    with pytest.raises(RuntimeError, match="needs a running cluster"):
        LearnerGroup(RLModuleSpec(DiscretePolicyModule, 4, 2), bc_loss,
                     num_learners=2, device=CPU)


@pytest.mark.slow
def test_learner_group_sharded_matches_single(shutdown_only):
    """The DDP invariant within the port: 2 learners on half-batches
    with gradient allreduce produce the SAME params as 1 learner on the
    full batch."""
    tart.init(num_cpus=2)
    obs, actions = _toy_dataset(n=256)
    batch = {"obs": obs, "actions": actions}

    spec = RLModuleSpec(DiscretePolicyModule, 4, 2, {"hidden": 16})
    single = LearnerGroup(spec, bc_loss, num_learners=1, lr=1e-2,
                          seed=7, device=CPU)
    group = LearnerGroup(spec, bc_loss, num_learners=2, lr=1e-2,
                         seed=7, device=CPU)
    try:
        group.set_weights(single.get_weights())
        for _ in range(3):
            single.update_from_batch(batch)
            group.update_from_batch(batch)
        for a, b in zip(t_ppo.tree_leaves(single.get_weights()),
                        t_ppo.tree_leaves(group.get_weights())):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    finally:
        group.shutdown()


# ----------------------------------------------------------- algorithms


@pytest.mark.slow
def test_sac_improves_on_cartpole():
    config = (SACConfig(device=CPU)
              .environment("CartPole-v1")
              .env_runners(num_env_runners=1,
                           num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(learning_starts=256, train_batch_size=128,
                        num_updates_per_iteration=16, seed=3))
    algo = config.build()
    first = None
    best = -np.inf
    for _ in range(8):
        result = algo.train()
        if not np.isnan(result["episode_return_mean"]):
            if first is None:
                first = result["episode_return_mean"]
            best = max(best, result["episode_return_mean"])
    algo.stop()
    assert first is not None
    assert best > first + 10, (first, best)
    # The learned temperature moved off its init (adaptive alpha).
    assert result["learner"]["alpha"] != pytest.approx(1.0)


@pytest.mark.slow
def test_appo_learns_cartpole():
    config = (APPOConfig(device=CPU)
              .environment("CartPole-v1")
              .env_runners(num_env_runners=1,
                           num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(seed=1, num_sgd_iter=4))
    algo = config.build()
    returns = []
    for _ in range(10):
        result = algo.train()
        if not np.isnan(result["episode_return_mean"]):
            returns.append(result["episode_return_mean"])
    algo.stop()
    assert returns and max(returns) > returns[0] + 15, returns
    assert 0.2 < result["learner"]["mean_ratio"] < 5.0


@pytest.mark.slow
def test_ppo_with_learner_group_e2e(shutdown_only):
    """PPO driving a 2-learner group end-to-end in a real cluster: the
    loss stays finite and weights stay usable by the env runners."""
    tart.init(num_cpus=2)
    config = (PPOConfig(device=CPU)
              .environment("CartPole-v1")
              .env_runners(num_env_runners=1,
                           num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(num_epochs=2, minibatch_size=64, seed=5)
              .learners(num_learners=2))
    algo = config.build()
    losses = []
    for _ in range(3):
        result = algo.train()
        losses.append(result["learner"]["total_loss"])
    algo.stop()
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_bc_trains_from_parquet_offline_dataset(shutdown_only, tmp_path):
    """Offline pipeline (ref: rllib/offline/offline_data.py:29): BC
    consumes a parquet dataset of transitions through the port's
    streaming Data executor and learns the labeling rule."""
    from ant_ray_tpu_torch import data

    tart.init(num_cpus=2)
    rng = np.random.RandomState(3)
    obs = rng.randn(384, 4).astype(np.float32)
    actions = (obs[:, 0] > 0).astype(np.int64)   # learnable rule
    rows = [{"obs": o.tolist(), "actions": int(a)}
            for o, a in zip(obs, actions)]
    data.from_items(rows, parallelism=4).write_parquet(str(tmp_path))

    ds = data.read_parquet([str(tmp_path / p)
                            for p in sorted(tmp_path.iterdir())])
    bc = BC(obs_dim=4, n_actions=2, hidden=32, lr=8e-2, seed=0, device=CPU)
    offline = OfflineData(ds, shuffle=True, shuffle_seed=11)
    metrics = {}
    for _ in range(8):
        metrics = bc.train_on_offline_data(offline, minibatch_size=128)
    bc.stop()
    assert metrics["accuracy"] > 0.9, metrics
