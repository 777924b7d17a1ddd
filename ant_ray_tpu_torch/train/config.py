"""Train configuration dataclasses (ref: train/v2/api/config.py —
ScalingConfig, RunConfig, FailureConfig): a copy of the JAX package's
``train/config.py`` whose TPU fields become GPU ones."""

from __future__ import annotations

import dataclasses
import os
import tempfile


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each needs.

    ``use_gpu`` / ``gpus_per_worker`` are the counterparts of the JAX
    package's ``use_tpu`` / ``chips_per_worker`` (the reference's
    ScalingConfig(use_gpu=True)): each worker asks for
    ``{"GPU": gpus_per_worker}`` unless ``resources_per_worker`` names
    its own GPU share, and the gang's ``sync_gradients`` group is NCCL.
    With ``topology`` (e.g. ``"2x8"``) the gang reserves whole GPU
    slices of ``accelerator_type`` (``util/gpu.py``), one worker per
    host, and each worker binds all of its host's cards, as
    ``chips_per_worker=0`` means "all" in the JAX package.
    """

    num_workers: int = 1
    # Elastic scaling (ref: scaling_policy/): 0 = fixed group size;
    # >0 = the group may launch/relaunch with as few as min_workers
    # ranks when the cluster can't place num_workers, growing back on
    # later restarts.  Incompatible with a whole-slice topology.
    min_workers: int = 0
    # Multi-slice training: the gang spans this many accelerator
    # slices (num_workers % num_slices == 0, contiguous rank blocks per
    # slice).  >1 feeds sync_gradients a SliceTopology so the fused
    # allreduce runs its two-level intra-slice (NVLink) / inter-slice
    # (network) schedule, and with use_gpu and a topology the gang
    # reserves one slice per block (co-located by gpu-pod-name).
    num_slices: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 1.0        # GPUs each worker binds (use_gpu)
    topology: str = ""                  # e.g. "2x8" (whole-slice reservation)
    accelerator_type: str = "H100"      # generation for slice math
    resources_per_worker: dict = dataclasses.field(default_factory=dict)
    placement_strategy: str = "PACK"

    def worker_resources(self) -> dict:
        res = dict(self.resources_per_worker)
        if self.use_gpu and self.topology:
            from ant_ray_tpu_torch._private.accelerators import gpu  # noqa: PLC0415

            res["GPU"] = float(gpu.chips_per_host(self.topology,
                                                  self.accelerator_type))
        elif self.use_gpu and self.gpus_per_worker:
            res.setdefault("GPU", float(self.gpus_per_worker))
        res.setdefault("CPU", 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0               # worker-group restarts allowed
    # Controller recreations after the controller ACTOR itself dies
    # (node loss); a separate budget — multiplying it into max_failures
    # would turn 2 worker retries into 9 gang launches.
    max_controller_failures: int = 1
    # Base wait between group-restart attempts after a FAILURE: gives
    # failure detection a beat so the next capacity read sees the dead
    # node as dead.  Grows exponentially (x2 per consecutive failure,
    # capped at 16x base, +/-20% jitter so restarting gangs don't
    # stampede the scheduler in lockstep).  Drain-triggered restarts
    # skip the wait entirely — the workers checkpointed and exited
    # cleanly, and the draining node is already fenced off.
    group_restart_backoff_s: float = 2.0


@dataclasses.dataclass
class DataConfig:
    """How the trainer's ``datasets=`` feed the workers (ref:
    train/_internal/data_config.py — DataConfig.configure).

    Datasets named in ``datasets_to_split`` ("all" = every dataset) are
    streaming_split across ranks with ``equal=True`` (every rank gets
    the same row count per epoch — SPMD lockstep must not starve a
    rank); the rest are broadcast whole to every worker (e.g. a small
    validation set)."""

    datasets_to_split: "str | list[str]" = "all"
    equal: bool = True
    # Defaults forwarded to every shard's configure_device_feed(), so a
    # worker loop can call get_dataset_shard(name).iter_device_batches()
    # with no arguments and get prefetched host→device delivery.  Keys:
    # batch_size, prefetch_batches, sharding, collate_fn, pad_value,
    # drop_last.  ``sharding`` (the device batches land on) may be a
    # callable ``(rank, world) -> device`` — the controller forwards each
    # worker's rank/world and the callable resolves on the worker's own
    # devices (device handles never cross processes).
    device_feed: dict | None = None

    def splits(self, name: str) -> bool:
        if self.datasets_to_split == "all":
            return True
        wanted = self.datasets_to_split
        if isinstance(wanted, str):   # a single name, not a char match
            wanted = [wanted]
        return name in wanted


@dataclasses.dataclass
class CheckpointConfig:
    """Checkpoint retention + durability plane.

    ``async_save``: reported pytree checkpoints are saved by a
    controller-side background thread instead of inside the report RPC,
    so the gang's step loop never blocks on storage I/O.  Saves
    complete in report order; restore (group restart / fit result)
    waits for in-flight saves, and a torn save is never adopted — the
    on-disk rename and the run-token stamp both happen only after a
    complete write.

    ``replicate``: each completed checkpoint is also packed into the
    in-cluster object store (pulled over the bulk transfer channel,
    striped across holders) — recovery then restores at object-plane
    bandwidth from any node, and no shared ``storage_path`` is needed:
    a restarted worker whose node can't see the original directory
    materializes the checkpoint from the replica.
    """

    num_to_keep: int | None = None      # None = keep all
    async_save: bool = True
    replicate: bool = True


@dataclasses.dataclass
class RunConfig:
    name: str = ""
    storage_path: str = ""
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    # Aggregate step records (attached by session.report when the loop
    # runs a StepProfiler) into cluster Prometheus gauges —
    # art_train_step_time_s / art_train_step_phase_fraction /
    # art_train_step_skew_ratio, labeled with the run name.  Off: the
    # controller still collects records (Result-level summaries) but
    # emits nothing.
    step_metrics: bool = True

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.join(
            tempfile.gettempdir(), "art_train")
        name = self.name or "run"
        return os.path.join(base, name)

    def pg_name(self) -> str:
        """The run's placement-group name — ONE definition shared by
        gang reservation (controller) and leaked-group cleanup
        (trainer); a drifted copy would silently stop matching."""
        return f"train-{self.name or 'run'}"


@dataclasses.dataclass
class Result:
    """What fit() returns (ref: ray.train.Result)."""

    metrics: dict
    checkpoint: "object | None"
    error: Exception | None
    path: str

    @property
    def best_checkpoint(self):
        return self.checkpoint
