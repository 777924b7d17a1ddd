"""Deterministic chaos harness (the port of the JAX package's
``util/chaos.py``).

The runtime grew its fault-injection knobs one at a time —
``testing_rpc_failure`` (seeded per-method RPC drops, protocol.py),
``testing_rpc_latency_s`` (per-method client-side latency, protocol.py),
``testing_chunk_serve_delay_s`` / ``testing_chunk_truncate`` (bulk
transfer-channel faults, transfer.py), ``testing_preemption_notice``
(the file-based stand-in for a maintenance event, accelerators/gpu.py).
This module drives them behind
one seeded :class:`ChaosSchedule` (ref in spirit: src/ray/rpc/rpc_chaos.h
+ the reference's chaos-testing release jobs):

* **knob faults** — build the ``_system_config`` dict once
  (``schedule.system_config()``) and hand it to ``init`` /
  ``Cluster(head_node_args={"_system_config": ...})``; every daemon in
  the cluster inherits the faults via the env-var channel.
* **scheduled actions** — ``at_step(n, fn)`` registers an action fired
  by a *logical* trigger (``schedule.fire(step)`` from the driver or
  the train loop): kill a worker/daemon at step N, drop a node, kill
  the GCS leader.  Logical steps, not wall clock, keep runs
  reproducible — the same seed and the same step sequence replay the
  same fault schedule.
* **drain notices** — ``preemption_notice()`` registers (and
  ``trigger_preemption()`` later arms) the notice file the daemon's
  preemption watch polls, standing in for a real maintenance event.

Typical test shape::

    chaos = ChaosSchedule(seed=7)
    chaos.chunk_serve_delay(0.01)
    cluster = Cluster(head_node_args={
        "_system_config": chaos.system_config()})
    chaos.at_step(3, lambda: cluster.remove_node(victim))
    ...
    for step in range(10):
        chaos.fire(step)       # deterministic kill at step 3
        ...

The ``chaos_schedule`` pytest fixture (import it into a test module)
yields a fresh schedule and removes its notice files afterwards.
"""

from __future__ import annotations

import logging
import os
import random
import tempfile
import uuid
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass(order=True)
class _Action:
    step: int
    order: int                      # registration order tie-break
    label: str = field(compare=False)
    fn: object = field(compare=False)
    fired: bool = field(default=False, compare=False)


class ChaosSchedule:
    """A seeded, deterministic fault schedule.

    Knob methods accumulate the ``_system_config`` overrides; action
    methods register step-triggered callbacks.  ``seed`` feeds both the
    RPC chaos injector (via ``testing_rpc_failure``'s seeded RNG) and
    this schedule's own RNG (``self.rng`` — use it for any randomized
    choice inside actions so replays stay identical)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._rpc_failures: dict[str, float] = {}
        self._rpc_latency: dict[str, float] = {}
        self._config: dict = {}
        self._actions: list[_Action] = []
        self._notice_files: list[str] = []

    # ------------------------------------------------------ knob faults

    def rpc_failure(self, method: str, prob: float) -> "ChaosSchedule":
        """Drop ``method`` RPCs with probability ``prob`` (seeded —
        protocol._ChaosInjector; ref: rpc_chaos.h)."""
        self._rpc_failures[method] = prob
        return self

    def rpc_latency(self, method: str, seconds: float) -> "ChaosSchedule":
        """Inject ``seconds`` of client-side latency before every
        ``method`` RPC (testing_rpc_latency_s — protocol._ChaosInjector).
        The deterministic slow-replica / slow-network knob: e.g.
        ``rpc_latency("PushTask", 0.05)`` makes every actor call ride a
        congested link."""
        self._rpc_latency[method] = seconds
        return self

    def chunk_serve_delay(self, seconds: float) -> "ChaosSchedule":
        """Holder-side delay per served transfer chunk, so a holder can
        be killed mid-transfer deterministically."""
        self._config["testing_chunk_serve_delay_s"] = seconds
        return self

    def chunk_truncate(self, max_bytes: int) -> "ChaosSchedule":
        """Truncate bulk-channel chunk replies to ``max_bytes`` — torn
        transfers that exercise the stripe-failover path."""
        self._config["testing_chunk_truncate"] = max_bytes
        return self

    def preemption_notice(self, path: str | None = None) -> str:
        """Register a preemption-notice FILE (not yet armed): daemons
        configured with it poll for its existence.  Returns the path —
        call :meth:`trigger_preemption` (or create the file yourself)
        to fire the notice."""
        if path is None:
            path = os.path.join(
                tempfile.gettempdir(),
                f"art_chaos_notice_{uuid.uuid4().hex[:8]}")
        self._config["testing_preemption_notice"] = path
        self._notice_files.append(path)
        return path

    def trigger_preemption(self, deadline_s: float = 30.0,
                           reason: str = "chaos preemption") -> None:
        """Arm the registered notice file: every daemon polling it
        drains itself within one poll interval."""
        path = self._config.get("testing_preemption_notice")
        if not path:
            raise RuntimeError(
                "call preemption_notice() before trigger_preemption()")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{deadline_s} {reason}\n")
        os.rename(tmp, path)     # atomic: watchers never see a torn file

    def system_config(self) -> dict:
        """The unified ``_system_config`` dict for init/Cluster."""
        out = dict(self._config)
        if self._rpc_failures:
            # The leading seed entry carries the schedule's seed into
            # every daemon's _ChaosInjector — different seeds really do
            # produce different RPC fault sequences.
            out["testing_rpc_failure"] = ",".join(
                [f"seed:{self.seed}"]
                + [f"{m}:{p}"
                   for m, p in sorted(self._rpc_failures.items())])
        if self._rpc_latency:
            out["testing_rpc_latency_s"] = ",".join(
                f"{m}:{s}" for m, s in sorted(self._rpc_latency.items()))
        return out

    # ------------------------------------------------- scheduled actions

    def at_step(self, step: int, fn, label: str = "") -> "ChaosSchedule":
        """Register ``fn`` to run when :meth:`fire` first reaches
        ``step`` (kill a node, drain a daemon, flip a knob...)."""
        self._actions.append(_Action(
            step=step, order=len(self._actions),
            label=label or getattr(fn, "__name__", "action"), fn=fn))
        return self

    def kill_leader(self, step: int, cluster) -> "ChaosSchedule":
        """Schedule a GCS **leader kill** at logical step ``step`` —
        the control-plane-loss action for a replicated head
        (``Cluster(head_node_args={"gcs_standbys": N})``).  Resolves
        the leader at fire time (it may have moved since scheduling),
        SIGKILLs that replica, and leaves it dead: the cluster must
        fail over to a standby, not wait for a restart.  The killed
        address lands in :attr:`killed_leaders` for assertions."""
        self.killed_leaders: list[str] = getattr(
            self, "killed_leaders", [])

        def _kill():
            self.killed_leaders.append(cluster.kill_gcs_leader())

        return self.at_step(step, _kill, label="kill_leader")

    def fault_slice(self, step: int, slice_id: str, cluster,
                    label: str = "art-slice-id") -> "ChaosSchedule":
        """Schedule a **whole-slice failure** at logical step ``step``:
        SIGKILL every node daemon of one accelerator slice (nodes
        labeled ``label=slice_id``) in the same fire — the multi-slice
        failure domain, where a slice's power/DCN drops all its hosts
        as a unit and the training gang must drain and restart from the
        last checkpoint with zero steps lost.  Membership resolves at
        fire time (nodes may have joined since scheduling).  The killed
        addresses land in :attr:`killed_slices` for assertions."""
        self.killed_slices: dict[str, list[str]] = getattr(
            self, "killed_slices", {})

        def _kill():
            self.killed_slices[str(slice_id)] = cluster.kill_slice(
                slice_id, label=label)

        return self.at_step(step, _kill,
                            label=f"fault_slice:{slice_id}")

    def fire(self, step: int) -> list[str]:
        """Run every not-yet-fired action scheduled at or before
        ``step`` (deterministic order: step, then registration).
        Returns the labels fired — handy for test assertions."""
        fired = []
        for action in sorted(self._actions):
            if action.fired or action.step > step:
                continue
            action.fired = True
            logger.info("chaos: firing %r (scheduled step %d, now %d)",
                        action.label, action.step, step)
            action.fn()
            fired.append(action.label)
        return fired

    @property
    def pending(self) -> list[str]:
        return [a.label for a in sorted(self._actions) if not a.fired]

    # ------------------------------------------------------------ cleanup

    def cleanup(self) -> None:
        for path in self._notice_files:
            for p in (path, f"{path}.tmp"):
                try:
                    os.unlink(p)
                except OSError:
                    pass


def chaos_schedule_fixture():
    """Body of the ``chaos_schedule`` pytest fixture (kept import-safe
    for non-pytest consumers): yields a fresh schedule, cleans up its
    notice files afterwards."""
    schedule = ChaosSchedule(seed=0)
    try:
        yield schedule
    finally:
        schedule.cleanup()


try:  # pragma: no cover — exercised by the tests that import it
    import pytest as _pytest

    chaos_schedule = _pytest.fixture(name="chaos_schedule")(
        chaos_schedule_fixture)
except ImportError:  # pragma: no cover
    chaos_schedule = None
