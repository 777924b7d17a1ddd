"""TrainController + worker group — the driving actors of a training run
(ref: train/v2/_internal/execution/controller/controller.py:101 control
loop :505-527, worker_group.py:269,376-391).

The controller is an actor (max_concurrency > 1 so workers can report
while the control loop blocks), the worker group is one actor per rank.
Failure handling: a dead worker fails the epoch; the controller restarts
the whole group up to FailureConfig.max_failures, handing the latest
checkpoint to the restarted loop (elastic recovery — ref:
failure_handling/).

A copy of the JAX package's ``train/controller.py``: the jax.distributed
rendezvous of a multi-rank TPU gang becomes torch's (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the
environment of a multi-rank GPU gang's loop), and a whole-slice
reservation takes GPU slices (``util/gpu.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ant_ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    pack_checkpoint_dir,
    save_pytree,
)
from ant_ray_tpu_torch.train.config import FailureConfig, RunConfig, ScalingConfig
from ant_ray_tpu_torch.train.session import (
    PreemptionInterrupt,
    TrainContext,
    _set_context,
)

logger = logging.getLogger(__name__)

# Sentinel return of a worker that unwound on a drain notice (its last
# report's checkpoint is registered; nothing was lost).
_PREEMPTED = "__preempted__"


class _DrainRestart(Exception):
    """Group interrupted by a node drain — relaunch off the draining
    node WITHOUT consuming a failure-budget attempt or a backoff wait
    (the workers checkpointed and exited cleanly)."""


class TrainWorker:
    """One rank of the worker group (actor)."""

    def __init__(self, rank: int, world_size: int, storage_path: str,
                 experiment_name: str, use_gpu: bool,
                 num_slices: int = 1):
        self._rank = rank
        self._world_size = world_size
        self._storage_path = storage_path
        self._experiment_name = experiment_name
        self._use_gpu = use_gpu
        self._num_slices = num_slices
        self._local_rank = 0

    def node_id(self) -> str:
        return os.environ.get("ART_NODE_ID", "")

    def propose_coordinator(self) -> str:
        """Rank 0 advertises host:port for torch.distributed's env://
        rendezvous (the counterpart of the JAX package's rank-0 address
        for jax.distributed; ref: train/v2/torch/config.py).  The loop
        binds the port itself, as under torchrun, so it is only
        advertised here."""
        import socket  # noqa: PLC0415

        from ant_ray_tpu_torch._private.protocol import find_free_port  # noqa: PLC0415

        try:
            host = socket.gethostbyname(socket.gethostname())
        except OSError:
            host = "127.0.0.1"
        return f"{host}:{find_free_port()}"

    def setup_distributed(self, coordinator: str | None,
                          local_rank: int = 0) -> bool:
        """Export torch.distributed's env:// rendezvous to the loop of a
        multi-rank GPU gang: ``MASTER_ADDR`` / ``MASTER_PORT`` (rank 0's
        coordinator), ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (this
        rank's position among the gang's ranks on its node).  It does
        not call ``init_process_group``: the gang's collective group
        (``sync_gradients``) stays the process's only one unless the
        loop makes its own."""
        self._local_rank = local_rank
        if not self._use_gpu or self._world_size == 1 or coordinator is None:
            return False
        host, port = coordinator.rsplit(":", 1)
        os.environ.update({"MASTER_ADDR": host, "MASTER_PORT": port,
                           "RANK": str(self._rank),
                           "WORLD_SIZE": str(self._world_size),
                           "LOCAL_RANK": str(local_rank)})
        return True

    def run(self, loop_fn, loop_config, controller, latest_checkpoint,
            attempt: int = 0, dataset_shards: dict | None = None):
        topo = None
        if (self._num_slices > 1
                and self._world_size % self._num_slices == 0):
            # Contiguous rank blocks per slice — matches the multi-slice
            # PG's bundle layout (bundle s*hosts+i = host i of slice s),
            # so sync_gradients' hierarchical allreduce keeps its DCN
            # exchange to one message per slice.
            from ant_ray_tpu_torch.util.collective.types import SliceTopology  # noqa: PLC0415

            topo = SliceTopology.regular(self._world_size,
                                         self._num_slices)
        ctx = TrainContext(
            world_rank=self._rank,
            world_size=self._world_size,
            local_rank=self._local_rank,
            experiment_name=self._experiment_name,
            storage_path=self._storage_path,
            controller=controller,
            latest_checkpoint=latest_checkpoint,
            attempt=attempt,
            use_gpu=self._use_gpu,
            slice_topology=topo,
            dataset_shards=dataset_shards or {},
        )
        _set_context(ctx)
        try:
            if loop_config is None:
                return loop_fn()
            return loop_fn(loop_config)
        except PreemptionInterrupt:
            # Controlled drain exit: the controller told report() to
            # stop; the checkpoint that report carried is registered.
            return _PREEMPTED
        finally:
            _set_context(None)  # type: ignore[arg-type]

    def ping(self):
        return "pong"


class TrainController:
    """Detached driving actor of one training run."""

    def __init__(self, loop_fn, loop_config, scaling: ScalingConfig,
                 run_config: RunConfig, resume: bool = False,
                 run_token: str | None = None, datasets: dict | None = None,
                 data_config=None):
        self._loop_fn = loop_fn
        self._loop_config = loop_config
        self._scaling = scaling
        self._run_config = run_config
        self._datasets = datasets or {}
        self._data_config = data_config
        self._storage_path = run_config.resolved_storage_path()
        self._ckpt_manager = CheckpointManager(
            self._storage_path, run_config.checkpoint_config.num_to_keep,
            restore=resume, run_token=run_token)
        self._metrics_history: list[dict] = []
        self._latest_metrics: dict = {}
        # rank -> latest step record dict (observability/step_profiler);
        # folded into cluster gauges on every report.
        self._step_records: dict[int, dict] = {}
        self._step_gauges = None
        # Resume past any on-disk checkpoints (a recreated controller
        # must not reuse their directories).
        self._report_index = self._ckpt_manager.next_index
        self._lock = threading.Lock()
        # Drain plane: set by the drain monitor when a node hosting the
        # gang got a preemption notice; report() acks carry it to every
        # rank, whose next report becomes the zero-step-loss exit.
        self._drain_stop = False
        self._drain_deadline_ts = 0.0
        # Async checkpoint plane: one background save thread (order-
        # preserving) + in-flight save futures the restart/result paths
        # flush before reading `latest`.
        self._save_pool = None
        self._pending_saves: list = []

    # ---- called by workers (concurrently with run())

    def report_from_worker(self, rank: int, metrics: dict, checkpoint):
        step_record = metrics.pop("_step_record", None)
        with self._lock:
            if step_record is not None:
                self._step_records[rank] = step_record
            if rank == 0:
                self._latest_metrics = metrics
                self._metrics_history.append(metrics)
                if checkpoint is not None:
                    self._accept_checkpoint(checkpoint)
                self._report_index += 1
        # Emit once per step, not once per rank-report: N ranks each
        # re-aggregating N records would make telemetry cost quadratic
        # in world size.  The lowest rank carrying records is the
        # designated emitter (rank 0 normally; still works if only a
        # subset of ranks runs a profiler).
        if step_record is not None and rank == min(self._step_records):
            self._emit_step_gauges()
        # The ack doubles as the drain channel (see session.report).
        return {"ok": True, "stop": self._drain_stop}

    # ---- checkpoint save/replication (CheckpointConfig knobs)

    def _accept_checkpoint(self, checkpoint) -> None:
        """Queue or perform the save+replicate+register of a reported
        checkpoint.  Called under self._lock (report path)."""
        cfg = self._run_config.checkpoint_config
        if isinstance(checkpoint, Checkpoint):
            # Already a directory handle: nothing to save off-thread —
            # but the optional replication pack is real I/O, and a
            # mixed run (pytree reports queued behind this one) must
            # register in REPORT order or `latest` regresses when the
            # queued save lands later.  Under async_save both concerns
            # route it through the same single-thread pool.
            if not getattr(cfg, "async_save", True):
                self._finish_checkpoint(checkpoint,
                                        registered_under_lock=True)
                return
            self._ensure_save_pool()
            self._pending_saves = [f for f in self._pending_saves
                                   if not f.done()]
            self._pending_saves.append(
                self._save_pool.submit(self._finish_checkpoint,
                                       checkpoint))
            return
        path = self._ckpt_manager.next_checkpoint_dir(self._report_index)
        if not getattr(cfg, "async_save", True):
            save_pytree(checkpoint, path)
            self._finish_checkpoint(Checkpoint.from_directory(path),
                                    registered_under_lock=True)
            return
        # Background save: the report RPC (and with it the gang's step
        # loop) returns immediately; the single-thread pool preserves
        # report order, and `latest` only ever sees COMPLETED saves —
        # a controller restart flushes the queue first, so restore can
        # never adopt a torn save.
        self._ensure_save_pool()

        def _save(tree=checkpoint, path=path):
            try:
                save_pytree(tree, path)
            except Exception:  # noqa: BLE001 — a failed save must not
                logger.exception(   # kill the save thread; the PREVIOUS
                    "background checkpoint save to %s failed", path)
                return              # checkpoint stays `latest`
            self._finish_checkpoint(Checkpoint.from_directory(path))

        self._pending_saves = [f for f in self._pending_saves
                               if not f.done()]
        self._pending_saves.append(self._save_pool.submit(_save))

    def _ensure_save_pool(self) -> None:
        if self._save_pool is None:
            from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

            self._save_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="art-ckpt-save")

    def _finish_checkpoint(self, ckpt: Checkpoint,
                           registered_under_lock: bool = False) -> None:
        """Replicate (best-effort) then register a COMPLETED save."""
        if getattr(self._run_config.checkpoint_config, "replicate", True) \
                and not os.path.isdir(ckpt.path):
            # A directory handle the controller can't see (worker-local
            # path, no shared storage): nothing to pack from here —
            # skip quietly rather than raise-and-warn every report.
            logger.debug("checkpoint %s not visible from the controller; "
                         "skipping replication", ckpt.path)
        elif getattr(self._run_config.checkpoint_config, "replicate", True):
            try:
                import ant_ray_tpu_torch as art  # noqa: PLC0415

                ckpt = ckpt.with_replica(
                    art.put(pack_checkpoint_dir(ckpt.path)))
            except Exception as e:  # noqa: BLE001 — replication is a
                # durability bonus; the on-disk copy is the authority.
                logger.warning("checkpoint replication failed: %s", e)
        if registered_under_lock:
            self._ckpt_manager.register(ckpt)
        else:
            with self._lock:
                self._ckpt_manager.register(ckpt)

    def _flush_checkpoints(self, timeout: float = 300.0) -> None:
        """Wait for in-flight background saves — every path that READS
        ``latest`` (group restart, fit result) flushes first, so a
        restore reflects every acked report."""
        with self._lock:
            pending, self._pending_saves = self._pending_saves, []
        for fut in pending:
            try:
                fut.result(timeout=timeout)
            except Exception:  # noqa: BLE001 — logged by the save job
                pass

    # ---- step telemetry (observability/step_profiler.py records)

    def get_step_summary(self) -> dict:
        """Cross-rank aggregation of each rank's LATEST step record:
        step-time mean/p50/max, mean per-phase fractions, and the
        straggler ratio (max/median step time — 1.0 means a perfectly
        even gang; arXiv:2510.20171's skew telemetry)."""
        with self._lock:
            records = dict(self._step_records)
        if not records:
            return {"ranks": 0}
        times = sorted(float(r.get("total_s", 0.0))
                       for r in records.values())
        n = len(times)
        # True median — an even gang (the common case: 2 hosts) must
        # not read the max as "median" and report skew=1.0 forever.
        median = (times[(n - 1) // 2] + times[n // 2]) / 2
        out: dict = {
            "ranks": n,
            "step_time_mean_s": sum(times) / n,
            "step_time_p50_s": median,
            "step_time_max_s": times[-1],
            "skew_ratio": (times[-1] / median) if median > 0 else 1.0,
        }
        names: set = set()
        for r in records.values():
            names.update(r.get("phases") or {})
        for name in sorted(names):
            fracs = []
            for r in records.values():
                total = float(r.get("total_s", 0.0))
                sec = float((r.get("phases") or {}).get(name, 0.0))
                fracs.append(min(1.0, sec / total) if total > 0 else 0.0)
            out[f"phase_{name}_fraction"] = sum(fracs) / n
        mfus = [r.get("mfu") for r in records.values()
                if r.get("mfu") is not None]
        if mfus:
            out["mfu_mean"] = sum(mfus) / len(mfus)
        return out

    def _emit_step_gauges(self) -> None:
        """Publish the cross-rank aggregation as cluster gauges (best
        effort, metrics-style — a no-op when emission is disabled or
        the worker is not connected)."""
        if not getattr(self._run_config, "step_metrics", True):
            return
        summary = self.get_step_summary()
        if not summary.get("ranks"):
            return
        try:
            from ant_ray_tpu_torch.util.metrics import Gauge  # noqa: PLC0415

            if self._step_gauges is None:
                run = self._run_config.name or "run"
                self._step_gauges = {
                    "time": Gauge(
                        "art_train_step_time_s",
                        description="train step time across ranks",
                        tag_keys=("run", "stat")).set_default_tags(
                            {"run": run}),
                    "phase": Gauge(
                        "art_train_step_phase_fraction",
                        description="mean fraction of step time per "
                                    "phase",
                        tag_keys=("run", "phase")).set_default_tags(
                            {"run": run}),
                    "skew": Gauge(
                        "art_train_step_skew_ratio",
                        description="straggler gauge: max/median step "
                                    "time over ranks",
                        tag_keys=("run",)).set_default_tags(
                            {"run": run}),
                    "mfu": Gauge(
                        "art_train_step_mfu",
                        description="mean MFU across ranks",
                        tag_keys=("run",)).set_default_tags(
                            {"run": run}),
                }
            g = self._step_gauges
            for stat in ("mean", "p50", "max"):
                g["time"].set(summary[f"step_time_{stat}_s"],
                              tags={"stat": stat})
            for key, value in summary.items():
                if key.startswith("phase_") and key.endswith("_fraction"):
                    g["phase"].set(
                        value, tags={"phase": key[len("phase_"):
                                                  -len("_fraction")]})
            g["skew"].set(summary["skew_ratio"])
            if "mfu_mean" in summary:
                g["mfu"].set(summary["mfu_mean"])
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    def get_metrics_history(self):
        with self._lock:
            return list(self._metrics_history)

    # ---- control loop

    def run(self, self_handle):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        from ant_ray_tpu_torch.train.scaling_policy import policy_for  # noqa: PLC0415

        policy = policy_for(self._scaling)
        failure_config: FailureConfig = self._run_config.failure_config
        attempts = failure_config.max_failures + 1
        last_error: Exception | None = None
        failures = 0
        incarnation = 0       # every launch, drains included — feeds
        while True:           # attempt-unique collective-group names
            world = policy.workers_for_attempt(
                self._scaling, art.available_resources(),
                art.cluster_resources(), attempt=failures)
            try:
                self._run_worker_group(art, self_handle, world,
                                       incarnation)
                return self._result(error=None)
            except _DrainRestart as e:
                # An ANNOUNCED departure costs neither a failure-budget
                # attempt nor a backoff wait: every rank checkpointed
                # through its last report and exited cleanly, and the
                # draining node is already fenced off the scheduler —
                # relaunch immediately, resuming at the exact step.
                incarnation += 1
                logger.info(
                    "worker group drained (%s); relaunching off the "
                    "draining node (failure budget untouched: %d/%d)",
                    e, failures, attempts - 1)
                continue
            # RuntimeError covers gang-reservation failures (an
            # infeasible PG after a node died is an attempt, not a
            # crash of the controller itself).
            except (art.exceptions.ArtError, RuntimeError) as e:
                last_error = e
                failures += 1
                incarnation += 1
                if (hasattr(policy, "note_unplaceable")
                        and isinstance(e, RuntimeError)
                        and ("reserve" in str(e)
                             or "infeasible" in str(e))):
                    # Aggregate capacity over-estimated placeability
                    # (fragmentation): converge downward.
                    policy.note_unplaceable(world)
                logger.warning(
                    "worker group (world=%d) failed (attempt %d/%d): %s",
                    world, failures, attempts, e)
                if failures >= attempts:
                    return self._result(error=last_error)
                # Give failure detection a beat: the next attempt's
                # capacity read must see the dead node as dead, or an
                # elastic resize would re-request the old world size.
                # Capped exponential backoff + jitter (FailureConfig.
                # group_restart_backoff_s) so a crash-looping gang
                # doesn't hammer the scheduler at a fixed cadence.
                time.sleep(self._restart_backoff_s(failure_config,
                                                   failures))

    def _restart_backoff_s(self, failure_config, failures: int) -> float:
        import random  # noqa: PLC0415

        base = getattr(failure_config, "group_restart_backoff_s", 2.0)
        if not getattr(self._scaling, "min_workers", 0):
            # Fixed-size groups don't resize by a capacity read, so
            # they keep the historical snappy retry: a quarter of the
            # base (0.5s at the default), scaling with the knob.
            base = base / 4.0
        delay = min(base * (2 ** (failures - 1)), base * 16, 60.0)
        return delay * random.uniform(0.8, 1.2)

    def _run_worker_group(self, art, self_handle, world: int | None = None,
                          attempt: int = 0):
        from ant_ray_tpu_torch.api import remote  # noqa: PLC0415

        scaling = self._scaling
        world = world if world is not None else scaling.num_workers
        self._drain_stop = False      # fresh gang, fresh drain state
        self._drain_deadline_ts = 0.0
        pg, slice_pg = self._reserve_gang(scaling, world)
        self._worker_pg = pg          # set BEFORE anything can fail, so
        self._worker_slice = slice_pg  # the finally always releases it
        workers = []
        drain_watch_stop = threading.Event()
        try:
            base_opts = {"resources": scaling.worker_resources(),
                         "num_cpus": 0}
            worker_cls = remote(TrainWorker)
            import uuid as _uuid  # noqa: PLC0415

            # Unique per-incarnation names: the trainer's leaked-worker
            # cleanup after a controller death finds survivors by the
            # "<pg_name>-w" prefix (a PG-less world<=1 run has no
            # placement group whose removal would kill them).
            tag = _uuid.uuid4().hex[:4]
            workers = [
                worker_cls.options(
                    **base_opts,
                    name=f"{self._run_config.pg_name()}-w{rank}-{tag}",
                    placement_group=pg,
                    # Rank r on bundle r: with a slice PG this pins rank
                    # r to the slice host with gpu-worker-id == r.
                    placement_group_bundle_index=(
                        rank if pg is not None else -1),
                ).remote(rank, world,
                         self._storage_path,
                         self._run_config.name or "run",
                         scaling.use_gpu,
                         getattr(scaling, "num_slices", 1))
                for rank in range(world)
            ]
            # Rendezvous: rank 0's host coordinates torch.distributed's
            # env:// (multi-rank GPU gangs); LOCAL_RANK counts the ranks
            # before this one on its node.
            coordinator = None
            local_ranks = [0] * world
            if scaling.use_gpu and world > 1:
                coordinator = art.get(
                    workers[0].propose_coordinator.remote())
                nodes = art.get([w.node_id.remote() for w in workers])
                local_ranks = [nodes[:rank].count(node)
                               for rank, node in enumerate(nodes)]
            art.get([w.setup_distributed.remote(coordinator, local_ranks[r])
                     for r, w in enumerate(workers)])
            # Adopt every acked report before reading `latest` — an
            # async save still in flight from the PREVIOUS incarnation
            # must land first or the resume point regresses.
            self._flush_checkpoints()
            latest = self._ckpt_manager.latest
            shards = self._make_dataset_shards(art, world)
            run_refs = [
                w.run.remote(self._loop_fn, self._loop_config,
                             self_handle, latest, attempt, shards[rank])
                for rank, w in enumerate(workers)
            ]
            # Preemption watcher: a drain notice on any node hosting a
            # gang worker flips _drain_stop, which the report acks
            # relay to every rank (see session.report).
            threading.Thread(
                target=self._watch_for_drain,
                args=(art, drain_watch_stop,
                      {f"{self._run_config.pg_name()}-w{rank}-{tag}"
                       for rank in range(world)}),
                daemon=True, name="art-train-drain-watch").start()
            # Fail FAST on the first rank failure (ref: worker_group
            # poll_status aborts the group on any error) — a plain
            # gather would sit behind the healthy ranks' remaining work
            # before surfacing a death, delaying recovery by minutes.
            # The short wait timeout is the drain poll: on _drain_stop
            # the loop keeps collecting ranks until the drain deadline,
            # then abandons stragglers (the finally kills them — their
            # progress is already checkpointed through rank 0).
            pending = list(run_refs)
            interrupted = False
            while pending:
                done, pending = art.wait(pending, num_returns=1,
                                         timeout=0.5)
                if done and art.get(done[0]) == _PREEMPTED:
                    interrupted = True
                if self._drain_stop and pending and \
                        time.time() >= self._drain_deadline_ts:
                    logger.warning(
                        "drain deadline passed with %d rank(s) still "
                        "running; abandoning them (progress is "
                        "checkpointed)", len(pending))
                    interrupted = True
                    break
            # Restart ONLY if a rank actually unwound on the notice: a
            # drain observed after every rank already finished its loop
            # is a completed fit, not one to re-execute.
            if self._drain_stop and interrupted:
                raise _DrainRestart(
                    "preemption notice on a gang node")
        finally:
            drain_watch_stop.set()
            for w in workers:
                try:
                    art.kill(w)
                except Exception:  # noqa: BLE001
                    pass
            self._release_gang()
            self._kill_data_coordinators(art)

    def _watch_for_drain(self, art, stop: threading.Event,
                         worker_names: set) -> None:
        """Poll node drain state while a gang runs; when a DRAINING
        node hosts one of this gang's workers, order the proactive
        stop.  Every rank then unwinds at its next report — WITH its
        checkpoint registered — and the control loop relaunches the
        gang on the remaining nodes before the announced deadline."""
        from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415

        while not stop.wait(0.5):
            if self._drain_stop:
                return
            try:
                draining = {n["NodeID"]: n.get("DrainDeadline", 0.0)
                            for n in art.nodes()
                            if n["Alive"] and n.get("Draining")}
                if not draining:
                    continue
                gcs = global_worker.runtime._gcs
                hit = [rec for rec in gcs.call("ListActors", retries=3)
                       if (rec.get("name") or "") in worker_names
                       and rec.get("state") != "DEAD"
                       and rec.get("node_id") in draining]
                if not hit:
                    continue
                deadline = min(filter(None,
                                      (draining[r["node_id"]]
                                       for r in hit)),
                               default=0.0)
                # A watcher from a PREVIOUS incarnation can reach here
                # seconds after its gang ended (ListActors retries) —
                # it must not drain-stop the fresh gang, which was
                # already placed off the draining node.
                if stop.is_set():
                    return
                # No announced deadline -> a generous local one: the
                # stop order still reaches ranks at their next report.
                self._drain_deadline_ts = deadline or (time.time() + 30.0)
                self._drain_stop = True
                logger.warning(
                    "drain notice on node(s) hosting %d gang worker(s); "
                    "ordering proactive checkpoint + migration "
                    "(deadline in %.0fs)", len(hit),
                    self._drain_deadline_ts - time.time())
                return
            except Exception as e:  # noqa: BLE001 — monitoring only
                logger.debug("drain watch poll failed: %s", e)

    def _make_dataset_shards(self, art, world: int) -> list:
        """Per-rank {name: DataIterator} from the trainer's datasets=.
        Fresh coordinators every attempt: a restarted (possibly
        resized) gang re-splits the stream across the NEW world size —
        a dead rank's unconsumed shard is thereby reassigned (ref:
        DataConfig.configure runs per worker-group start,
        train/v2/api/data_parallel_trainer.py:83)."""
        if not self._datasets:
            return [None] * world
        from ant_ray_tpu_torch.data.iterator import make_streaming_split  # noqa: PLC0415
        from ant_ray_tpu_torch.train.config import DataConfig  # noqa: PLC0415

        cfg = self._data_config or DataConfig()
        self._kill_data_coordinators(art)   # previous attempt's actors
        coords = []
        shards: list[dict] = [dict() for _ in range(world)]
        for name, ds in self._datasets.items():
            if cfg.splits(name):
                its = make_streaming_split(ds, world, equal=cfg.equal,
                                           name=name)
                coords.append(its[0]._coord)
                for rank in range(world):
                    shards[rank][name] = its[rank]
            else:
                for rank in range(world):
                    shards[rank][name] = ds.iterator()
            if cfg.device_feed:
                # Forward per-worker device-feed defaults (incl. rank/
                # world, so a callable sharding resolves per worker on
                # its own devices) — the loop then just calls
                # get_dataset_shard(name).iter_device_batches().
                for rank in range(world):
                    # dict-merge (not kwargs) so a user-supplied rank/
                    # world in device_feed is overridden, not a
                    # TypeError; the controller's values are the truth.
                    shards[rank][name].configure_device_feed(
                        **{**cfg.device_feed,
                           "rank": rank, "world": world})
        self._data_coords = coords
        return shards

    def _kill_data_coordinators(self, art) -> None:
        for coord in getattr(self, "_data_coords", ()):
            try:
                art.kill(coord)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        self._data_coords = []

    def _reserve_gang(self, scaling, world: int | None = None):
        """Gang-reserve the worker group's resources before spawning any
        rank (ref: WorkerGroup placement-group creation,
        worker_group.py:269).  GPU + topology ⇒ reserve whole slices
        (util/gpu.py); otherwise a plain PG with the scaling config's
        strategy.  Single local worker ⇒ no PG (keeps the laptop path
        free of reservation latency)."""
        world = world if world is not None else scaling.num_workers
        if scaling.use_gpu and scaling.topology:
            # Bundles must cover everything a rank actor demands — the
            # cards AND its CPU share — or the bundle lease rejects it.
            extra = {k: v for k, v in scaling.worker_resources().items()
                     if k != "GPU"}
            num_slices = getattr(scaling, "num_slices", 1)
            if num_slices > 1:
                from ant_ray_tpu_torch.util.gpu import (  # noqa: PLC0415
                    multi_slice_placement_group,
                )

                ms_pg = multi_slice_placement_group(
                    scaling.topology, num_slices,
                    scaling.accelerator_type,
                    name=self._run_config.pg_name(),
                    bundle_extra=extra)
                if scaling.num_workers != ms_pg.num_hosts:
                    ms_pg.remove()
                    raise ValueError(
                        f"num_workers={scaling.num_workers} does not "
                        f"match the {ms_pg.num_hosts} hosts of "
                        f"{num_slices}x slice {scaling.topology}")
                if not ms_pg.ready(timeout=120):
                    ms_pg.remove()
                    raise RuntimeError(
                        f"could not reserve {num_slices} GPU slices of "
                        f"{scaling.topology}")
                return ms_pg.placement_group, ms_pg
            from ant_ray_tpu_torch.util.gpu import slice_placement_group  # noqa: PLC0415

            slice_pg = slice_placement_group(
                scaling.topology, scaling.accelerator_type,
                name=self._run_config.pg_name(),
                bundle_extra=extra)
            if scaling.num_workers != slice_pg.num_hosts:
                slice_pg.remove()
                raise ValueError(
                    f"num_workers={scaling.num_workers} does not match "
                    f"the {slice_pg.num_hosts} hosts of slice "
                    f"{scaling.topology}")
            if not slice_pg.ready(timeout=120):
                slice_pg.remove()
                raise RuntimeError(
                    f"could not reserve GPU slice {scaling.topology}")
            return slice_pg.placement_group, slice_pg
        if world <= 1:
            return None, None
        from ant_ray_tpu_torch.util.placement_group import placement_group  # noqa: PLC0415

        pg = placement_group(
            [scaling.worker_resources()
             for _ in range(world)],
            strategy=scaling.placement_strategy,
            name=self._run_config.pg_name())
        # Elastic groups fail reservations fast — a shrunken cluster
        # should trigger a resize within seconds, not after a two-minute
        # stall on an unplaceable gang.
        ready_timeout = 20 if getattr(scaling, "min_workers", 0) else 120
        if not pg.ready(timeout=ready_timeout):
            from ant_ray_tpu_torch.util.placement_group import (  # noqa: PLC0415
                remove_placement_group,
            )

            remove_placement_group(pg)  # don't leak a PENDING reservation
            raise RuntimeError("could not reserve training worker group")
        return pg, None

    def _release_gang(self):
        pg = getattr(self, "_worker_pg", None)
        self._worker_pg = None
        self._worker_slice = None
        if pg is not None:
            from ant_ray_tpu_torch.util.placement_group import (  # noqa: PLC0415
                remove_placement_group,
            )

            try:
                remove_placement_group(pg)
            except Exception:  # noqa: BLE001 — release is best-effort
                pass

    def _result(self, error):
        from ant_ray_tpu_torch.train.config import Result  # noqa: PLC0415

        # Every acked report's checkpoint must be visible in the
        # result, async saves included.
        self._flush_checkpoints()
        return Result(
            metrics=dict(self._latest_metrics),
            checkpoint=self._ckpt_manager.latest,
            error=error,
            path=self._storage_path,
        )
