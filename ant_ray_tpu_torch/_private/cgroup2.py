"""cgroup v2 resource isolation for node processes (ref:
src/ray/common/cgroup2/ — CgroupManagerInterface and its factory: the
raylet splits SYSTEM processes (daemons) from USER processes (workers)
into sibling cgroups so a worker memory blow-up is contained by the
kernel before it takes the daemon down).

Layout under the delegated root (usually ``/sys/fs/cgroup``):

    <root>/art_<session>/            (+memory +cpu enabled)
        system/                      node daemon + helpers
        workers/                     every spawned worker
            memory.max               workers' collective hard cap
            memory.oom.group = 0     kill one worker, not the group
            cpu.weight               relative share vs system

Opt-in via ``enable_cgroups`` (needs a writable delegated cgroup2 tree
— root or a systemd-delegated slice).  Everything degrades to a no-op
when unavailable: isolation is an upgrade, never a boot requirement.
The constructor takes the tree root so tests drive it against a fake
directory."""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

DEFAULT_ROOT = "/sys/fs/cgroup"


class CgroupManager:
    """Best-effort cgroup v2 subtree for one node's processes."""

    def __init__(self, session_name: str, root: str = DEFAULT_ROOT,
                 workers_memory_max: int = 0,
                 workers_cpu_weight: int = 0):
        self._root = root
        self._base = os.path.join(root, f"art_{session_name}")
        self._system = os.path.join(self._base, "system")
        self._workers = os.path.join(self._base, "workers")
        self._workers_memory_max = workers_memory_max
        self._workers_cpu_weight = workers_cpu_weight
        self.active = False

    # ------------------------------------------------------------ setup

    @staticmethod
    def available(root: str = DEFAULT_ROOT) -> bool:
        """A usable cgroup2 tree: the controllers file exists and the
        root is writable (delegation)."""
        return (os.path.isfile(os.path.join(root, "cgroup.controllers"))
                and os.access(root, os.W_OK))

    def setup(self) -> bool:
        """Create the subtree and apply limits; False (and inactive) on
        any failure — callers must treat isolation as optional."""
        try:
            os.makedirs(self._system, exist_ok=True)
            os.makedirs(self._workers, exist_ok=True)
            # Enable controllers for the children.  Requires the base's
            # parent to have them enabled for us (delegation); partial
            # support (e.g. cpu missing) is tolerated per-controller.
            avail = self._read(os.path.join(self._base,
                                            "cgroup.controllers")) or ""
            enable = [c for c in ("memory", "cpu") if c in avail.split()]
            if enable:
                self._write(os.path.join(self._base,
                                         "cgroup.subtree_control"),
                            " ".join(f"+{c}" for c in enable))
            # Per-controller best effort: a host that delegates only
            # memory still gets memory isolation — a failed cpu.weight
            # write must not throw away the memory.max already applied.
            if self._workers_memory_max > 0:
                self._try_limit(os.path.join(self._workers, "memory.max"),
                                str(self._workers_memory_max))
                # One runaway worker dies alone — group-kill would turn
                # a single OOM into a whole-node worker massacre.
                self._try_limit(os.path.join(self._workers,
                                             "memory.oom.group"), "0")
            if self._workers_cpu_weight > 0:
                self._try_limit(os.path.join(self._workers, "cpu.weight"),
                                str(self._workers_cpu_weight))
            self.active = True
            return True
        except OSError as e:
            logger.info("cgroup2 isolation unavailable: %s", e)
            self.active = False
            self.cleanup()    # never leak a half-built subtree
            return False

    @classmethod
    def _try_limit(cls, path: str, value: str) -> None:
        try:
            cls._write(path, value)
        except OSError as e:
            logger.info("cgroup limit %s not applied: %s", path, e)

    # ----------------------------------------------------------- placing

    def add_system_process(self, pid: int) -> bool:
        return self._add(self._system, pid)

    def add_worker_process(self, pid: int) -> bool:
        return self._add(self._workers, pid)

    def _add(self, cgroup: str, pid: int) -> bool:
        if not self.active:
            return False
        try:
            self._write_procs(os.path.join(cgroup, "cgroup.procs"), pid)
            return True
        except OSError:
            return False  # process already gone, or no permission

    # ---------------------------------------------------------- teardown

    def workers_memory_current(self) -> int | None:
        value = self._read(os.path.join(self._workers, "memory.current"))
        try:
            return int(value) if value is not None else None
        except ValueError:
            return None

    def cleanup(self) -> None:
        """Migrate stragglers back to the root and remove the subtree.
        Safe to call when inactive or half-built."""
        if not os.path.isdir(self._base):
            return
        for group in (self._workers, self._system):
            procs = self._read(os.path.join(group, "cgroup.procs")) or ""
            for pid in procs.split():
                try:
                    self._write_procs(
                        os.path.join(self._root, "cgroup.procs"), int(pid))
                except (OSError, ValueError):
                    pass
            try:
                os.rmdir(group)
            except OSError:
                pass
        try:
            os.rmdir(self._base)
        except OSError:
            pass
        self.active = False

    # ------------------------------------------------------------- io

    @staticmethod
    def _read(path: str) -> str | None:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            return None

    @staticmethod
    def _write(path: str, value: str) -> None:
        with open(path, "w") as f:
            f.write(value)

    @staticmethod
    def _write_procs(path: str, pid: int) -> None:
        # cgroup.procs takes one pid per write() call; append mode is
        # equivalent on cgroupfs and keeps a faithful record when the
        # manager is driven against a plain-directory fake in tests.
        with open(path, "a") as f:
            f.write(f"{pid}\n")
