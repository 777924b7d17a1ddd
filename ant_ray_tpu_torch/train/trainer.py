"""TorchTrainer — the user-facing distributed trainer
(ref: train/v2/torch/torch_trainer.py + api/data_parallel_trainer.py:155),
a copy of the JAX package's ``train/trainer.py`` (its ``JaxTrainer``,
also named ``TpuTrainer`` there).
"""

from __future__ import annotations

import logging
from typing import Any, Callable

from ant_ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig

logger = logging.getLogger(__name__)


class TorchTrainer:
    """Distributed training driver: one actor per worker (a rank, with
    its share of a GPU under ``use_gpu``), rendezvous, metric/checkpoint
    reporting, elastic restarts.

    Example::

        def train_loop(config):
            ctx = train.get_context()
            for step in range(config["steps"]):
                loss = llama.loss_fn(params, batch, cfg)
                loss.backward()
                grads = train.sync_gradients(
                    {k: p.grad for k, p in params.items()})
                ...
                optimizer.step()
                train.report({"loss": loss.item()}, checkpoint=params)

        trainer = TorchTrainer(
            train_loop,
            train_loop_config={"steps": 100},
            scaling_config=ScalingConfig(num_workers=4, use_gpu=True),
        )
        result = trainer.fit()
    """

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: dict | None = None,
                 scaling_config: ScalingConfig | None = None,
                 run_config: RunConfig | None = None,
                 datasets: dict | None = None,
                 dataset_config=None):
        self._loop = train_loop_per_worker
        self._loop_config = train_loop_config
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        # datasets={"train": ds}: each worker pulls its coordinated
        # streaming shard via train.get_dataset_shard("train") (ref:
        # api/data_parallel_trainer.py:83, datasets= + DataConfig).
        self._datasets = datasets or {}
        self._dataset_config = dataset_config
        if not self._run_config.name:
            # Anonymous runs get a per-trainer unique name: two
            # concurrent fits in one job must not share a PG name (the
            # leaked-group cleanup would remove the healthy run's
            # reservation) or a checkpoint dir (a fresh run would
            # clobber the previous anonymous run's checkpoints).
            import dataclasses as _dc  # noqa: PLC0415
            import uuid as _uuid  # noqa: PLC0415

            self._run_config = _dc.replace(
                self._run_config, name=f"run-{_uuid.uuid4().hex[:6]}")

    def fit(self) -> Result:
        import ant_ray_tpu_torch as art  # noqa: PLC0415
        from ant_ray_tpu_torch.train.controller import TrainController  # noqa: PLC0415

        if not art.is_initialized():
            art.init()
        # Soft-pin the controller to the driver's node: the controller
        # must survive worker-node loss to run the elastic restart, and
        # the driver's node is the head for every local flow — an
        # owned cluster's node_address IS the spawned head, and a
        # connecting driver gets the first-registered (head) node from
        # services.find_local_node.  The pin is SOFT (falls back to
        # DEFAULT if that node is gone) and the controller-death retry
        # below covers the residual mis-pin cases (e.g. a head that
        # re-registered after a restart).  Ref: the reference runs its
        # TrainController where the driver entrypoint lives.
        strategy = None
        try:
            from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415
            from ant_ray_tpu_torch.util.scheduling_strategies import (  # noqa: PLC0415
                NodeAffinitySchedulingStrategy,
            )

            runtime = global_worker.runtime
            my_address = getattr(runtime, "node_address", None)
            if my_address:
                node_id = next(
                    (n["NodeID"] for n in art.nodes()
                     if n["Alive"] and n["Address"] == my_address), None)
                if node_id is not None:
                    strategy = NodeAffinitySchedulingStrategy(
                        node_id, soft=True)
        except Exception as e:  # noqa: BLE001 — cluster state probe
            logger.warning("controller node pin unavailable (%s); "
                           "using DEFAULT placement", e)
        controller_cls = art.remote(TrainController).options(
            max_concurrency=8, num_cpus=0, scheduling_strategy=strategy)
        # The controller itself can die with a node (the soft pin only
        # covers owned-cluster drivers) — recreate it up to
        # max_failures times; run() resumes from the latest persisted
        # checkpoint, so a controller loss costs the current interval,
        # not the run (ref: Trainer.restore semantics).
        from ant_ray_tpu_torch.exceptions import ActorDiedError  # noqa: PLC0415

        retries = max(
            0, self._run_config.failure_config.max_controller_failures)
        # The trainer OWNS the fit's checkpoint run-token: a retry then
        # adopts only checkpoints this fit stamped, even if an earlier
        # controller died before writing any token (a stale .run_token
        # from a previous same-named run can never match).
        import uuid as _uuid  # noqa: PLC0415

        run_token = _uuid.uuid4().hex
        for attempt in range(retries + 1):
            controller = controller_cls.remote(
                self._loop, self._loop_config, self._scaling,
                self._run_config, attempt > 0, run_token,
                self._datasets, self._dataset_config)
            try:
                result: Result = art.get(
                    controller.run.remote(controller), timeout=None)
                break
            except ActorDiedError:
                if attempt == retries:
                    # Final failure still must not leak the gang: the
                    # dead controller never ran its PG release, and the
                    # PG removal also kills the orphaned workers.
                    self._release_leaked_groups(art)
                    self._kill_leaked_workers(art)
                    raise
                logger.warning(
                    "train controller died (attempt %d/%d); recreating "
                    "— resumes from the latest checkpoint IN "
                    "storage_path (%s); node-local paths restart from "
                    "scratch after node loss",
                    attempt + 1, retries + 1,
                    self._run_config.resolved_storage_path())
                self._release_leaked_groups(art)
                self._kill_leaked_workers(art)
            finally:
                try:
                    art.kill(controller)
                except Exception:  # noqa: BLE001
                    pass
        if result.error is not None:
            raise result.error
        return result

    # A controller usually dies WITH its node — often in the same event
    # (GCS restart, head blip) that makes the first cleanup RPCs fail.
    # The GCS persists and daemons reconnect well within this window,
    # so the sweeps retry with backoff instead of leaking the gang.
    _CLEANUP_RETRY_WINDOW_S = 30.0

    @classmethod
    def _retry_cleanup(cls, what: str, sweep) -> None:
        """Run ``sweep`` until it succeeds or the GCS-restart window
        closes (capped exponential backoff between tries)."""
        import time as _time  # noqa: PLC0415

        deadline = _time.monotonic() + cls._CLEANUP_RETRY_WINDOW_S
        delay = 0.25
        while True:
            try:
                sweep()
                return
            except Exception as e:  # noqa: BLE001 — GCS may be restarting
                if _time.monotonic() >= deadline:
                    logger.warning("%s failed (giving up after %.0fs): %s",
                                   what, cls._CLEANUP_RETRY_WINDOW_S, e)
                    return
                logger.info("%s hit %s; retrying in %.2fs", what, e, delay)
                _time.sleep(delay)
                delay = min(delay * 2, 4.0)

    def _release_leaked_groups(self, art) -> None:
        """A controller that died with its node never ran its PG
        release — remove this run's leftover reservations so the
        recreated controller's gang can actually place (there is no
        GCS owner-fate-sharing for placement groups)."""
        from ant_ray_tpu_torch._private.ids import PlacementGroupID  # noqa: PLC0415
        from ant_ray_tpu_torch.util.placement_group import (  # noqa: PLC0415
            PlacementGroup,
            placement_group_table,
            remove_placement_group,
        )

        pg_name = self._run_config.pg_name()

        def sweep():
            my_job_hex = self._my_job_hex()
            for pg_hex, rec in placement_group_table().items():
                if rec.get("name") != pg_name or \
                        rec.get("state") == "REMOVED":
                    continue
                if self._foreign_job(rec, my_job_hex):
                    continue
                remove_placement_group(PlacementGroup(
                    id=PlacementGroupID.from_hex(pg_hex),
                    bundles=tuple(rec.get("bundles", ())),
                    strategy=rec.get("strategy", "PACK")))

        self._retry_cleanup("leaked placement-group cleanup", sweep)

    @staticmethod
    def _my_job_hex() -> str | None:
        from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415

        my_job = getattr(global_worker.runtime, "job_id", None)
        return my_job.hex() if my_job is not None else None

    @staticmethod
    def _foreign_job(rec: dict, my_job_hex: str | None) -> bool:
        """Cleanup scope: another job's same-named run keeps its
        reservations and workers (one rule for both cleanups)."""
        return (rec.get("job_id") is not None and my_job_hex is not None
                and rec["job_id"] != my_job_hex)

    def _kill_leaked_workers(self, art) -> None:
        """Kill this run's surviving TrainWorker actors by their
        "<pg_name>-w" name prefix — a PG-less run (world<=1)
        has no placement group whose removal would take them down, so
        they would otherwise hold their resources until job teardown."""
        from ant_ray_tpu_torch._private.ids import ActorID  # noqa: PLC0415
        from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415

        prefix = f"{self._run_config.pg_name()}-w"

        def sweep():
            my_job_hex = self._my_job_hex()
            gcs = global_worker.runtime._gcs
            for rec in gcs.call("ListActors", retries=3):
                if not (rec.get("name") or "").startswith(prefix) or \
                        rec.get("state") == "DEAD":
                    continue
                if self._foreign_job(rec, my_job_hex):
                    continue
                gcs.call("KillActor", {
                    "actor_id": ActorID.from_hex(rec["actor_id"]),
                    "no_restart": True}, retries=3)

        self._retry_cleanup("leaked worker cleanup", sweep)


# Alias mirroring the reference's generic data-parallel trainer name.
DataParallelTrainer = TorchTrainer
