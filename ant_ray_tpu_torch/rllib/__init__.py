"""ant_ray_tpu_torch.rllib — distributed reinforcement learning in
PyTorch, the port of ``ant_ray_tpu.rllib``.

Capability mirror of the reference's RLlib architecture (ref:
rllib/algorithms/algorithm.py, rllib/env/env_runner_group.py,
rllib/core/learner/learner_group.py:101): sampling **EnvRunner actors**
feed a **LearnerGroup** whose update step is an autograd step on the
card (``device="cpu"`` for the CPU), its DDP gradient averaging a gloo
allreduce of the port's ``util/collective``.

Algorithm families (each a config-builder → ``build()`` → ``train()``):

* **PPO** — clipped-surrogate on-policy (ref: rllib/algorithms/ppo/);
  scales its update over a :class:`LearnerGroup` with
  ``config.learners(num_learners=N)``
* **APPO** — async PPO: IMPALA collection + V-trace-corrected clipped
  surrogate (ref: rllib/algorithms/appo/)
* **DQN** — double-Q with uniform replay + target net
  (ref: rllib/algorithms/dqn/)
* **IMPALA** — V-trace-corrected actor-critic
  (ref: rllib/algorithms/impala/)
* **SAC** — discrete max-entropy off-policy with twin critics and a
  learned temperature (ref: rllib/algorithms/sac/)
* **BC** — behavior cloning from offline data
  (ref: rllib/algorithms/bc/)

Building blocks: :class:`RLModule` / :class:`RLModuleSpec` (the
network unit, ref rl_module.py) and :class:`LearnerGroup` (DDP-style
sharded-gradient learners, ref learner_group.py:101).  Parameters keep
the JAX package's trees and leaf names; ``convert.params_from_jax_numpy``
carries them across.
"""

from ant_ray_tpu_torch.rllib.algorithm import (
    DQN,
    IMPALA,
    Algorithm,
    DQNConfig,
    IMPALAConfig,
    PPOConfig,
)
from ant_ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ant_ray_tpu_torch.rllib.bc import BC
from ant_ray_tpu_torch.rllib.env import CartPoleEnv, make_env, register_env
from ant_ray_tpu_torch.rllib.offline import OfflineData
from ant_ray_tpu_torch.rllib.learner_group import Learner, LearnerGroup
from ant_ray_tpu_torch.rllib.rl_module import (
    DiscretePolicyModule,
    RLModule,
    RLModuleSpec,
    TwinQModule,
)
from ant_ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = ["APPO", "APPOConfig", "Algorithm", "BC", "CartPoleEnv",
           "DQN", "DQNConfig", "DiscretePolicyModule", "IMPALA",
           "IMPALAConfig", "Learner", "LearnerGroup", "OfflineData",
           "PPOConfig", "RLModule", "RLModuleSpec", "SAC", "SACConfig",
           "TwinQModule", "make_env", "register_env"]
