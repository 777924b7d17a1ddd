"""Distributed training (ref capability: ray.train v2 — the TorchTrainer
path): the JAX package's train plane under the port's names
(``TorchTrainer`` for ``JaxTrainer`` / ``TpuTrainer``, ``use_gpu`` for
``use_tpu``), plus the one-process training step on the port's models
(``train_step``, ``make_optimizer``: llama and GPT-2 through the flash
kernels).  A data-parallel loop calls ``llama.loss_fn``, ``backward``,
``sync_gradients`` and the optimizer's ``step`` itself.

``make_optimizer`` and ``train_step`` load on first use: the train
plane's controller and a CPU gang never import torch's models for them.
"""

import importlib

from ant_ray_tpu_torch.train.checkpoint import Checkpoint, load_pytree, save_pytree
from ant_ray_tpu_torch.train.config import (
    CheckpointConfig,
    DataConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ant_ray_tpu_torch.train.session import (
    PreemptionInterrupt,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_world_rank,
    get_world_size,
    gradient_syncer,
    report,
    sync_gradients,
)
from ant_ray_tpu_torch.train.trainer import DataParallelTrainer, TorchTrainer

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "DataConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "PreemptionInterrupt",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_world_rank",
    "get_world_size",
    "gradient_syncer",
    "load_pytree",
    "make_optimizer",
    "report",
    "save_pytree",
    "sync_gradients",
    "train_step",
]


def __getattr__(name: str):
    if name in ("make_optimizer", "train_step"):
        value = getattr(importlib.import_module(
            "ant_ray_tpu_torch.train.step"), name)
        globals()[name] = value
        return value
    raise AttributeError(
        f"module 'ant_ray_tpu_torch.train' has no attribute {name!r}")
