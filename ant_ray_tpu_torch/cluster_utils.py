"""Multi-node-on-one-host test cluster (ref: python/ray/cluster_utils.py:135
— the mechanism by which all distributed scheduling/FT tests run without
real machines: N node daemons, each a full node, on one host).

The JAX package's ``Cluster`` can also replicate the control plane
(``head_node_args={"gcs_standbys": N}``, ``kill_gcs_leader()``); GCS HA
is ROADMAP queue A item 6.6, so this one runs a single GCS, which
``kill_gcs`` / ``restart_gcs`` restart from its store."""

from __future__ import annotations

import json
import os
import shutil
import subprocess

from ant_ray_tpu_torch._private import services
from ant_ray_tpu_torch._private.protocol import ClientPool


def _descendant_pids(root_pid: int) -> list[int]:
    """Every live descendant of ``root_pid`` (workers, agents, ...),
    via one /proc scan.  Workers detach into their own sessions
    (``start_new_session=True``) so a process-group kill can't reach
    them — but their PPID still names the daemon that spawned them."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                # "pid (comm) state ppid ..." — comm may itself contain
                # parens/spaces, so split off the LAST ')'.
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out: list[int] = []
    stack = [root_pid]
    while stack:
        for child in children.get(stack.pop(), ()):
            out.append(child)
            stack.append(child)
    return out


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: dict | None = None):
        head_node_args = dict(head_node_args or {})
        if head_node_args.pop("gcs_standbys", 0):
            raise NotImplementedError(
                "GCS HA (gcs_standbys) is not ported (ROADMAP queue A item "
                "6.6)")
        self._session_dir = services.new_session_dir()
        self._gcs_procs: list[tuple[subprocess.Popen, str]] = []
        self._node_procs: list[subprocess.Popen] = []
        self._node_addresses: list[str] = []
        self._node_labels: list[dict] = []
        # Each node's arena directory: a node killed without a chance to
        # destroy its store (remove_node, kill_slice) leaves it in
        # /dev/shm, so the cluster removes it once the node is gone.
        self._store_dirs: list[str] = []
        self._pool = ClientPool()
        self._saved_env: list[tuple[str, str | None]] = []
        # _system_config flags travel to every daemon this cluster spawns
        # as ART_<NAME> env vars — same channel api.init uses
        # (ref: _system_config embedded into raylet launch,
        # services.py:1518).
        for key, value in (head_node_args.pop("_system_config", None)
                           or {}).items():
            name = f"ART_{key.upper()}"
            self._saved_env.append((name, os.environ.get(name)))
            os.environ[name] = (json.dumps(value)
                                if isinstance(value, (dict, list))
                                else str(value))
        if initialize_head:
            self.add_node(**head_node_args)

    @property
    def gcs_address(self) -> str | None:
        """The GCS endpoint handed to daemons and drivers."""
        if not self._gcs_procs:
            return None
        return self._gcs_procs[0][1]

    @property
    def address(self) -> str:
        assert self._gcs_procs, "cluster has no head"
        return self.gcs_address

    # ------------------------------------------------------------ members

    def add_node(self, num_cpus: int | None = None,
                 num_tpus: int | None = None,
                 resources: dict | None = None,
                 labels: dict | None = None,
                 num_gpus: int | None = None) -> str:
        """Start one more node daemon; the first call also starts the
        GCS.  ``num_gpus`` overrides the detected cards, as in
        ``init``."""
        if not self._gcs_procs:
            self._gcs_procs.append(services.start_gcs(self._session_dir))
        node_resources = services.default_resources(
            num_cpus if num_cpus is not None else 1, num_tpus, resources,
            num_gpus)
        proc, address = services.start_node(
            self.gcs_address, node_resources, self._session_dir, labels)
        self._node_procs.append(proc)
        self._node_addresses.append(address)
        self._node_labels.append(dict(labels or {}))
        self._store_dirs.append(services.store_dir_of(address))
        return address

    # ---------------------------------------------------------- GCS chaos

    def kill_gcs(self) -> None:
        """Kill the head's (first) GCS process (simulates head failure
        in the single-replica restart-FT scenario)."""
        assert self._gcs_procs
        proc, _addr = self._gcs_procs[0]
        proc.kill()
        proc.wait(timeout=5)

    def restart_gcs(self) -> None:
        """Restart the GCS on the same port, resuming from its sqlite
        store (the test_gcs_fault_tolerance scenario)."""
        assert self._gcs_procs
        _old_proc, old_addr = self._gcs_procs[0]
        port = int(old_addr.rsplit(":", 1)[1])
        proc, address = services.start_gcs(self._session_dir, port=port)
        assert address == old_addr
        self._gcs_procs[0] = (proc, address)

    # -------------------------------------------------------------- nodes

    def drain_node(self, address: str, reason: str = "preemption",
                   deadline_s: float = 30.0) -> None:
        """Inject a drain/preemption notice into one node daemon (the
        announced-departure scenario: a TPU maintenance event fires
        minutes before the host dies).  The node stops taking new
        leases; Serve and Train migrate off it."""
        self._pool.get(address).call(
            "NotifyDrain", {"reason": reason, "deadline_s": deadline_s},
            timeout=10)

    def remove_node(self, address: str, graceful: bool = False) -> None:
        """Kill a node daemon (simulates node failure when not graceful)."""
        index = self._node_addresses.index(address)
        proc = self._node_procs[index]
        if graceful:
            try:
                self._pool.get(address).call("Shutdown", timeout=2)
            except Exception:  # noqa: BLE001
                pass
            proc.terminate()
        else:
            proc.kill()
        proc.wait(timeout=5)
        shutil.rmtree(self._store_dirs[index], ignore_errors=True)

    def nodes_with_label(self, key: str, value: str) -> list[str]:
        """Addresses of live node daemons started with label
        ``key=value`` (e.g. every host of one simulated TPU slice)."""
        return [addr
                for addr, labels, proc in zip(self._node_addresses,
                                              self._node_labels,
                                              self._node_procs)
                if labels.get(key) == value and proc.poll() is None]

    def kill_slice(self, slice_id: str,
                   label: str = "art-slice-id") -> list[str]:
        """SIGKILL every process of every node labeled as slice
        ``slice_id`` — the whole-slice failure domain of multi-slice
        training (one DCN-linked slice loses power as a UNIT, taking
        daemon AND workers with it; single-node kills never
        exercise the gang's all-ranks-at-once recovery).  Unlike
        ``remove_node`` — whose orphaned workers model a daemon crash
        and suicide only after their lagged liveness poll — power loss
        is instantaneous, so the daemon's whole process tree dies
        first.  Returns the killed addresses."""
        import signal

        victims = self.nodes_with_label(label, str(slice_id))
        if not victims:
            raise RuntimeError(
                f"no live nodes labeled {label}={slice_id!r}")
        for address in victims:
            daemon = self._node_procs[self._node_addresses.index(address)]
            for pid in _descendant_pids(daemon.pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
            self.remove_node(address)
        return victims

    def connect(self, **init_kwargs):
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        return art.init(address=self.address, **init_kwargs)

    def shutdown(self):
        self._pool.close_all()
        procs = [p for p, _a in self._gcs_procs] + self._node_procs
        services.stop_processes(procs)
        for store_dir in self._store_dirs:
            shutil.rmtree(store_dir, ignore_errors=True)
        self._gcs_procs.clear()
        self._node_procs.clear()
        self._node_addresses.clear()
        self._store_dirs.clear()
        services.remove_session_dir(self._session_dir)
        for name, old in self._saved_env:
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old
        self._saved_env.clear()
