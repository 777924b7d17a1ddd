"""LearnerGroup: data-parallel update over N learner actors with
gradient allreduce (capability mirror of the reference's
rllib/core/learner/learner_group.py:101, and of the JAX package's
``rllib/learner_group.py``: each learner takes the autograd gradient of
its batch shard, the gradients average across the group over a gloo
group of the port's ``util/collective``, and every learner applies the
identical update, so replicas never drift).

Single-learner groups skip the actors entirely (RLlib local mode).
"""

from __future__ import annotations

import numpy as np

from ant_ray_tpu_torch._device import resolve_device
from ant_ray_tpu_torch.rllib import ppo
from ant_ray_tpu_torch.rllib.rl_module import RLModuleSpec


class Learner:
    """One learner replica: module params + Adam + an autograd grad
    step and an apply step (ref: rllib/core/learner/learner.py).
    ``loss_builder`` is a PURE function (module, params, batch of
    tensors) -> (loss, metrics dict), shipped to the actor."""

    def __init__(self, spec: RLModuleSpec, loss_builder, *,
                 lr: float = 3e-4, seed: int = 0,
                 world: int = 1, rank: int = 0, group_name: str = "",
                 device=None):
        self.device = resolve_device(device)
        self.module = spec.build()
        self.params = self.module.init_params(seed, self.device)
        self._optimizer = ppo.Adam(lr)
        self._opt_state = self._optimizer.init(self.params)
        self._loss_builder = loss_builder
        self._world = world
        self._rank = rank
        self._group = group_name
        if world > 1:
            from ant_ray_tpu_torch.util import collective as col  # noqa: PLC0415

            col.init_collective_group(world, rank, backend="gloo",
                                      group_name=group_name)
            self._col = col

    def _loss_of(self, params, batch):
        return self._loss_builder(self.module, params, batch)

    def grad(self, batch: dict):
        """(grads, metrics) of the loss on ``batch`` (tensors)."""
        loss, metrics, grads = ppo.value_and_grad(self._loss_of,
                                                  self.params, batch)
        return grads, dict(metrics, total_loss=loss)

    def apply(self, grads) -> None:
        self.params, self._opt_state = self._optimizer.update(
            grads, self._opt_state, self.params)

    def update(self, shard: dict) -> dict:
        """Grad on my shard -> allreduce-mean across the group -> apply.
        Every learner applies the same averaged gradient, so params stay
        bit-identical across replicas (the DDP invariant)."""
        batch = ppo.to_device(shard, self.device)
        grads, metrics = self.grad(batch)
        if self._world > 1:
            leaves = [self._col.allreduce(leaf, group_name=self._group)
                      / self._world for leaf in ppo.tree_leaves(grads)]
            grads = ppo.tree_unflatten(grads, leaves)
        self.apply(grads)
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self):
        return ppo.to_numpy(self.params)

    def set_weights(self, params):
        self.params = ppo.copy_to_device(params, self.device)


class LearnerGroup:
    """N learners as actors (or one inline) sharing every update
    (ref: learner_group.py:101 — update_from_batch shards the batch,
    learners allreduce gradients).  ``device`` is every learner's: the
    card unless it is ``"cpu"``."""

    _seq = 0

    def __init__(self, spec: RLModuleSpec, loss_builder, *,
                 num_learners: int = 1, lr: float = 3e-4, seed: int = 0,
                 device=None):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        self._num = max(1, num_learners)
        if self._num == 1:
            self._local = Learner(spec, loss_builder, lr=lr, seed=seed,
                                  device=device)
            self._actors = []
            return
        if not art.is_initialized():
            raise RuntimeError(
                "num_learners > 1 needs a running cluster (art.init)")
        LearnerGroup._seq += 1
        group_name = f"learner-group-{LearnerGroup._seq}"
        self._local = None
        learner_cls = art.remote(Learner)
        self._actors = [
            learner_cls.remote(spec, loss_builder, lr=lr, seed=seed,
                               world=self._num, rank=rank,
                               group_name=group_name, device=device)
            for rank in range(self._num)
        ]
        self._art = art

    @property
    def num_learners(self) -> int:
        return self._num

    def update_from_batch(self, batch: dict) -> dict:
        """Shard the batch across learners; one synchronized update."""
        if self._local is not None:
            return self._local.update(batch)
        n = len(next(iter(batch.values())))
        if n < self._num:
            raise ValueError(
                f"batch of {n} rows cannot shard across "
                f"{self._num} learners — an empty shard means NaN "
                "gradients poisoning every replica; use fewer learners "
                "or bigger minibatches")
        bounds = [round(i * n / self._num) for i in range(self._num + 1)]
        shards = [{k: v[bounds[i]:bounds[i + 1]]
                   for k, v in batch.items()}
                  for i in range(self._num)]
        all_metrics = self._art.get(
            [actor.update.remote(shard)
             for actor, shard in zip(self._actors, shards)],
            timeout=600)
        return {k: float(np.mean([m[k] for m in all_metrics]))
                for k in all_metrics[0]}

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return self._art.get(self._actors[0].get_weights.remote(),
                             timeout=120)

    def set_weights(self, params) -> None:
        if self._local is not None:
            self._local.set_weights(params)
            return
        self._art.get([a.set_weights.remote(params)
                       for a in self._actors], timeout=120)

    def shutdown(self) -> None:
        for actor in self._actors:
            try:
                self._art.kill(actor)
            except Exception:  # noqa: BLE001
                pass
        self._actors = []
