"""BC (behavior cloning): supervised policy learning from offline
(obs, action) data (ref: rllib/algorithms/bc/ — the simplest offline
algorithm, and the catalog's exercise of the RLModule + LearnerGroup
path: the loss is pure cross-entropy over a module's train forward;
the JAX package's ``rllib/bc.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ant_ray_tpu_torch.rllib.learner_group import LearnerGroup
from ant_ray_tpu_torch.rllib.rl_module import DiscretePolicyModule, RLModuleSpec


def bc_loss(module, params, batch):
    """Negative log-likelihood of the dataset actions under the policy
    (ref: bc_torch_policy loss)."""
    out = module.forward_train(params, batch)
    logp = F.log_softmax(out["logits"], dim=-1)
    nll = -torch.mean(logp.gather(-1, batch["actions"][:, None])[:, 0])
    accuracy = torch.mean(
        (torch.argmax(out["logits"], dim=-1)
         == batch["actions"]).to(torch.float32))
    return nll, {"nll": nll, "accuracy": accuracy}


class BC:
    """Offline trainer: iterate minibatches of a fixed dataset through
    a LearnerGroup (1..N learners with gradient allreduce) on
    ``device`` (the card unless it is ``"cpu"``)."""

    def __init__(self, *, obs_dim: int, n_actions: int,
                 hidden: int = 64, lr: float = 1e-3,
                 num_learners: int = 1, seed: int = 0, device=None):
        spec = RLModuleSpec(DiscretePolicyModule, obs_dim, n_actions,
                            {"hidden": hidden})
        self.learners = LearnerGroup(spec, bc_loss,
                                     num_learners=num_learners,
                                     lr=lr, seed=seed, device=device)
        self._rng = np.random.RandomState(seed)
        self._iteration = 0

    def train_on_dataset(self, obs: np.ndarray, actions: np.ndarray, *,
                         epochs: int = 1, minibatch_size: int = 128
                         ) -> dict:
        n = len(actions)
        metrics: dict = {}
        for _ in range(epochs):
            perm = self._rng.permutation(n)
            for lo in range(0, n, minibatch_size):
                idx = perm[lo:lo + minibatch_size]
                if len(idx) < minibatch_size and n > minibatch_size:
                    continue
                metrics = self.learners.update_from_batch(
                    {"obs": obs[idx], "actions": actions[idx]})
        self._iteration += 1
        return {"training_iteration": self._iteration, **metrics}

    def train_on_offline_data(self, offline_data, *, epochs: int = 1,
                              minibatch_size: int = 128) -> dict:
        """Stream an OfflineData (or data.Dataset / parquet paths)
        through the learners (ref: offline_data.py:29 — training input
        flows from the Data engine, never materialized in the driver)."""
        from ant_ray_tpu_torch.rllib.offline import OfflineData  # noqa: PLC0415

        if not isinstance(offline_data, OfflineData):
            offline_data = OfflineData(offline_data)
        metrics: dict = {}
        for _ in range(epochs):
            for batch in offline_data.iter_minibatches(
                    minibatch_size, columns=("obs", "actions")):
                metrics = self.learners.update_from_batch({
                    "obs": batch["obs"].astype(np.float32),
                    "actions": batch["actions"].astype(np.int64)})
        self._iteration += 1
        return {"training_iteration": self._iteration, **metrics}

    def get_weights(self):
        return self.learners.get_weights()

    def stop(self):
        self.learners.shutdown()
