"""Node providers: how the autoscaler turns "launch a node of type X"
into a machine.

The port of the JAX package's ``autoscaler/node_provider.py`` (itself a
mirror of the reference's NodeProvider abstraction, ref:
python/ray/autoscaler/node_provider.py + v2 instance manager), reduced
to the three verbs the v2 control loop actually needs.  Two built-ins:

* :class:`LocalSubprocessProvider` — real node daemons as local
  subprocesses joining the live cluster (the multi-node simulator; also
  how tests exercise the full scale-up/scale-down loop end-to-end).
* :class:`GkeTpuNodePoolProvider` — scales GKE TPU node pools by
  resizing them through the injected client; TPU-slice node types map
  to node pools of the matching machine/topology (ref capability:
  kuberay + the TPU webhook).  The Kubernetes client is injected so the
  provisioning logic is unit-testable without a cluster (and the image
  ships no kubernetes dependency).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class NodeTypeConfig:
    """One launchable node shape (ref: available_node_types entries).

    ``hosts_per_launch > 1`` declares a **gang unit**: one
    ``create_node`` call provisions that many hosts joining together —
    how GKE TPU node pools scale (a slice is atomic; resizing the pool
    by one adds every host of one slice).  The per-launch label fields
    describe the labels those hosts advertise once registered, so the
    autoscaler can tell that launching one unit satisfies a whole gang
    demand (slice placement group) even though no live node carries the
    labels yet:

    * ``launch_shared_label`` — key whose value is shared by all hosts
      of one launch and unique per launch (``tpu-pod-name``);
    * ``launch_indexed_label`` — key enumerating hosts within a launch
      as "0".."N-1" (``tpu-worker-id``);
    * ``head_resources`` — extra resources on host index 0 only (the
      ``TPU-<pod_type>-head`` claim resource).
    """

    name: str
    resources: dict
    labels: dict = field(default_factory=dict)
    min_workers: int = 0
    max_workers: int = 8
    hosts_per_launch: int = 1
    launch_shared_label: str | None = None
    launch_indexed_label: str | None = None
    head_resources: dict = field(default_factory=dict)

    def launch_host_views(self) -> list[dict]:
        """Predicted (labels, resources) of each host one launch yields —
        what the autoscaler matches gang demands against."""
        hosts = []
        for i in range(self.hosts_per_launch):
            labels = {**self.labels, "art/node-type": self.name,
                      "art/autoscaled": "1"}
            if self.launch_shared_label is not None:
                labels[self.launch_shared_label] = "<pending-launch>"
            if self.launch_indexed_label is not None:
                labels[self.launch_indexed_label] = str(i)
            resources = dict(self.resources)
            if i == 0:
                for key, value in self.head_resources.items():
                    resources[key] = resources.get(key, 0.0) + value
            hosts.append({"id": f"{self.name}/{i}", "labels": labels,
                          "resources": resources})
        return hosts


def tpu_slice_node_type(topology: str,
                        accelerator_type: str = "TPU-V5E",
                        name: str = "",
                        cpus_per_host: float = 8.0,
                        min_workers: int = 0,
                        max_workers: int = 4) -> NodeTypeConfig:
    """NodeTypeConfig for a whole-TPU-slice gang unit.  Not ported: it
    reads the slice geometry of ``_private/accelerators/tpu.py``, which
    comes with slice placement turned into GPU placement (ROADMAP queue
    A item 9).  A gang of plain nodes needs no such type: a
    ``NodeTypeConfig`` with ``hosts_per_launch`` and the launch labels
    describes it."""
    raise NotImplementedError(
        "tpu_slice_node_type is not ported: slice geometry comes with "
        "GPU placement (ROADMAP queue A item 9)")


class NodeProvider:
    """Launch/terminate/list — everything else (what to launch, when)
    lives in the Autoscaler control loop."""

    def create_node(self, node_type: NodeTypeConfig) -> str:
        """Start one node of the given type; returns a provider id."""
        raise NotImplementedError

    def terminate_node(self, provider_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> dict[str, str]:
        """provider id -> node type name."""
        raise NotImplementedError

    def node_address(self, provider_id: str) -> str | None:
        """The daemon address of a launched node, once known — the
        autoscaler matches it against the GCS node table to track
        idleness.  Providers that can't map ids to addresses return
        None; their nodes are exempt from idle scale-down (the
        autoscaler logs this once per node)."""
        return None

    def node_addresses(self, provider_id: str) -> list[str] | None:
        """All daemon addresses of a launch (gang units yield several
        hosts); idle scale-down requires every one to be idle."""
        address = self.node_address(provider_id)
        return None if address is None else [address]


class LocalSubprocessProvider(NodeProvider):
    """Real node daemons as local subprocesses (the cluster_utils
    simulator path, reused as a provider)."""

    def __init__(self, gcs_address: str, session_dir: str):
        self._gcs_address = gcs_address
        self._session_dir = session_dir
        self._lock = threading.Lock()
        self._nodes: dict[str, dict] = {}   # provider id -> record
        self._counter = 0

    def create_node(self, node_type: NodeTypeConfig) -> str:
        """One launch = one gang unit: ``hosts_per_launch`` daemons, each
        carrying the per-launch labels a real slice host would advertise
        (shared slice id, per-host worker index) — the local simulator
        of a GKE TPU node-pool resize."""
        from ant_ray_tpu_torch._private.services import (  # noqa: PLC0415
            start_node)

        with self._lock:
            self._counter += 1
            launch_no = self._counter
        pid = f"local-{node_type.name}-{launch_no}"
        procs = []
        addresses = []
        try:
            for i in range(node_type.hosts_per_launch):
                labels = {**node_type.labels,
                          "art/node-type": node_type.name,
                          "art/autoscaled": "1"}
                if node_type.launch_shared_label is not None:
                    labels[node_type.launch_shared_label] = pid
                if node_type.launch_indexed_label is not None:
                    labels[node_type.launch_indexed_label] = str(i)
                resources = dict(node_type.resources)
                if i == 0:
                    for key, value in node_type.head_resources.items():
                        resources[key] = resources.get(key, 0.0) + value
                proc, address = start_node(
                    self._gcs_address, resources,
                    self._session_dir, labels=labels)
                procs.append(proc)
                addresses.append(address)
        except Exception:
            # Partial gang unit: tear down the hosts already started so
            # they don't linger as orphan capacity nobody tracks.
            for proc in procs:
                proc.terminate()
            raise
        with self._lock:
            self._nodes[pid] = {"procs": procs, "addresses": addresses,
                                "type": node_type.name}
        return pid

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            record = self._nodes.pop(provider_id, None)
        if record is None:
            return
        for proc in record["procs"]:
            proc.terminate()
        for proc in record["procs"]:
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 — escalate
                proc.kill()

    def non_terminated_nodes(self) -> dict[str, str]:
        with self._lock:
            dead = [pid for pid, r in self._nodes.items()
                    if all(p.poll() is not None for p in r["procs"])]
            for pid in dead:
                del self._nodes[pid]
            return {pid: r["type"] for pid, r in self._nodes.items()}

    def node_address(self, provider_id: str) -> str | None:
        with self._lock:
            record = self._nodes.get(provider_id)
            return record["addresses"][0] if record else None

    def node_addresses(self, provider_id: str) -> list[str] | None:
        with self._lock:
            record = self._nodes.get(provider_id)
            return list(record["addresses"]) if record else None


class GkeApiError(Exception):
    """A GKE REST call failed (carries the HTTP-ish status code)."""

    def __init__(self, status: int, message: str = ""):
        super().__init__(f"GKE API error {status}: {message}")
        self.status = status


class GkeRestNodePoolClient:
    """Node-pool client over the GKE REST surface (ref:
    container.googleapis.com v1 —
    ``projects.locations.clusters.nodePools`` get / ``:setSize`` and
    zone operation polling; the surface behind
    ``gcloud container clusters resize``).

    ``request(method, path, body=None) -> dict`` is injected — a
    google-auth session in production, a recorded fake in the contract
    test — so the client itself is dependency-free.  The GKE semantics
    encoded here (and pinned by tests/test_gke_provider.py):

    * ``:setSize`` is ASYNC — it returns an Operation that must poll to
      ``DONE`` before the resize is real;
    * one resize per pool at a time — a concurrent ``:setSize`` fails
      with 409/FAILED_PRECONDITION and must be retried after the
      in-flight operation finishes;
    * the pool's node count reads from the nodePool resource
      (``initialNodeCount``, which GKE rewrites on resize).

    Exposes the ``get_pool_size``/``set_pool_size`` seam
    ``GkeTpuNodePoolProvider`` consumes.
    """

    def __init__(self, request, cluster_path: str, *,
                 poll_interval_s: float = 1.0,
                 resize_timeout_s: float = 900.0):
        self._request = request
        self._cluster = cluster_path.rstrip("/")
        # "projects/P/locations/L/clusters/C" → operations live under
        # "projects/P/locations/L".
        self._location = self._cluster.rsplit("/clusters/", 1)[0]
        self._poll_interval_s = poll_interval_s
        self._resize_timeout_s = resize_timeout_s

    def get_pool_size(self, pool: str) -> int:
        resp = self._request(
            "GET", f"{self._cluster}/nodePools/{pool}")
        return int(resp.get("currentNodeCount",
                            resp.get("initialNodeCount", 0)))

    def set_pool_size(self, pool: str, size: int) -> None:
        deadline = time.monotonic() + self._resize_timeout_s
        while True:
            try:
                op = self._request(
                    "POST", f"{self._cluster}/nodePools/{pool}:setSize",
                    {"nodeCount": int(size)})
                break
            except GkeApiError as e:
                # Another resize is in flight on this pool: wait it out.
                if e.status not in (409, 412) or \
                        time.monotonic() > deadline:
                    raise
                time.sleep(self._poll_interval_s)
        self._wait_operation(op, deadline)

    def _wait_operation(self, op: dict, deadline: float) -> None:
        name = op.get("name")
        while True:
            if op.get("status") == "DONE":
                # DONE is NOT success: a failed resize completes DONE
                # with an `error` (or legacy `statusMessage`) attached —
                # e.g. stockout / quota — and treating it as success
                # leaves the autoscaler believing nodes exist.
                self._raise_if_operation_failed(op)
                return
            if time.monotonic() > deadline:
                raise GkeApiError(
                    504, f"operation {name} did not finish in time")
            if name is None:
                # No handle to poll and no DONE status: the response is
                # malformed — fail loudly instead of assuming success.
                raise GkeApiError(
                    500, "operation response carried no name/status: "
                    f"{op!r}")
            time.sleep(self._poll_interval_s)
            op = self._request(
                "GET", f"{self._location}/operations/{name}")

    @staticmethod
    def _raise_if_operation_failed(op: dict) -> None:
        err = op.get("error")
        msg = op.get("statusMessage") or ""
        if not err and not msg:
            return
        code = 500
        if isinstance(err, dict):
            code = int(err.get("code") or 500)
            msg = err.get("message") or msg or repr(err)
        elif err:
            msg = msg or repr(err)
        raise GkeApiError(
            code, f"operation {op.get('name')} finished with error: {msg}")


class GkeTpuNodePoolProvider(NodeProvider):
    """Resizes GKE node pools; each node type names a pool.

    ``client`` must expose ``get_pool_size(pool) -> int`` and
    ``set_pool_size(pool, size)`` — a thin seam over the GKE API
    (``container.projects.locations.clusters.nodePools.setSize``) that
    tests fake.  TPU slices scale at whole-slice granularity: one
    "node" here is one slice's worth of hosts, matching how the
    reference reserves slices atomically (ref: python/ray/util/tpu.py
    slice reservation).
    """

    def __init__(self, client, pool_for_type: dict[str, str]):
        if client is None:
            raise ValueError(
                "GkeTpuNodePoolProvider needs a GKE client object "
                "(get_pool_size/set_pool_size); none is bundled — pass "
                "one built on google-cloud-container, or use "
                "LocalSubprocessProvider outside GKE")
        self._client = client
        self._pool_for_type = dict(pool_for_type)
        self._lock = threading.Lock()
        self._launched: dict[str, str] = {}   # provider id -> type
        self._counter = 0

    def create_node(self, node_type: NodeTypeConfig) -> str:
        pool = self._pool_for_type[node_type.name]
        with self._lock:
            size = self._client.get_pool_size(pool)
            self._client.set_pool_size(pool, size + 1)
            self._counter += 1
            pid = f"gke-{node_type.name}-{self._counter}"
            self._launched[pid] = node_type.name
        return pid

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            type_name = self._launched.pop(provider_id, None)
            if type_name is None:
                return
            pool = self._pool_for_type[type_name]
            size = self._client.get_pool_size(pool)
            if size > 0:
                self._client.set_pool_size(pool, size - 1)

    def non_terminated_nodes(self) -> dict[str, str]:
        with self._lock:
            return dict(self._launched)
