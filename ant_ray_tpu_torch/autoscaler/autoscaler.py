"""The autoscaler control loop.

Re-design of the reference's v2 autoscaler (ref:
python/ray/autoscaler/v2/autoscaler.py:50 — Reconciler over cluster
status + instance manager + scheduler) on this framework's primitives:

* **input**: the GCS's unfulfilled-demand table (``ResourceDemands`` —
  recorded on every SelectNode / actor-scheduling miss) plus the live
  node table (``GetAllNodes``);
* **decision**: first-fit bin-packing of demand shapes onto configured
  node types, bounded by per-type max_workers; min_workers backfill;
  idle-node termination after ``idle_timeout_s`` (only nodes this
  autoscaler launched — the head and statically-provisioned nodes are
  never touched);
* **actuation**: a NodeProvider (node_provider.py).

Run it in-process (``start()`` spawns the loop thread next to the
driver/head) or drive ``run_once()`` from a supervisor.  Heartbeats to
the GCS flip the cluster into "infeasible demands wait for capacity"
mode (core.py lease loop, gcs.py actor scheduling).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field

from ant_ray_tpu_torch._private.protocol import ClientPool
from ant_ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider,
    NodeTypeConfig,
)

logger = logging.getLogger(__name__)


@dataclass
class AutoscalerConfig:
    node_types: list[NodeTypeConfig] = field(default_factory=list)
    idle_timeout_s: float = 60.0
    interval_s: float = 5.0
    # Max launch units per reconcile round (upscaling_speed analogue).
    max_launches_per_round: int = 8
    # After launching for a gang demand, wait this long for the hosts to
    # register before considering launching for the same gang again
    # (a GKE node-pool resize takes minutes; relaunching every reconcile
    # would provision N slices for one demand).
    gang_provision_grace_s: float = 120.0


# ---------------------------------------------------------------- gang plan
# Capacity-feasibility planner for gang (placement group) demands: can
# this host set EVER hold every bundle under the strategy + selector +
# same-label constraints?  Mirrors the GCS's _plan_bundles semantics
# (gcs.py) but runs on TOTAL resources — the autoscaler asks "is more
# hardware needed", not "does it fit right now" (ref: gang resource
# requests in src/ray/gcs/gcs_autoscaler_state_manager.h consumed by
# python/ray/autoscaler/v2/scheduler.py).


def _plan_gang_in(hosts: list[dict], bundles, selectors,
                  strategy) -> tuple[list[str] | None, int]:
    """Greedy assignment of bundles to ``hosts`` ([{"id", "labels",
    "resources"}]).  Returns (plan, -1) or (None, first_failed_bundle)."""
    remaining = {h["id"]: dict(h["resources"]) for h in hosts}
    labels = {h["id"]: h["labels"] for h in hosts}

    def sel_ok(hid, index):
        if not selectors or index >= len(selectors):
            return True
        return all(labels[hid].get(k) == v
                   for k, v in (selectors[index] or {}).items())

    def fits(hid, bundle):
        return all(remaining[hid].get(k, 0.0) >= v
                   for k, v in bundle.items())

    def take(hid, bundle):
        for k, v in bundle.items():
            remaining[hid][k] = remaining[hid].get(k, 0.0) - v

    if strategy in ("STRICT_PACK", "PACK"):
        for h in hosts:
            hid = h["id"]
            if not all(sel_ok(hid, i) for i in range(len(bundles))):
                continue
            snapshot = dict(remaining[hid])
            ok = True
            for bundle in bundles:
                if fits(hid, bundle):
                    take(hid, bundle)
                else:
                    ok = False
                    break
            remaining[hid] = snapshot
            if ok:
                return [hid] * len(bundles), -1
        if strategy == "STRICT_PACK":
            return None, 0
    used: set = set()
    plan: list[str] = []
    for index, bundle in enumerate(bundles):
        chosen = None
        for h in sorted(hosts, key=lambda h: (h["id"] in used, h["id"])):
            hid = h["id"]
            if strategy == "STRICT_SPREAD" and hid in used:
                continue
            if sel_ok(hid, index) and fits(hid, bundle):
                chosen = hid
                break
        if chosen is None:
            return None, index
        take(chosen, bundle)
        used.add(chosen)
        plan.append(chosen)
    return plan, -1


def plan_gang(hosts: list[dict], bundles, selectors, strategy,
              same_label) -> list[str] | None:
    """Full gang plan: with ``same_label``, every chosen host must share
    one value of that label key (the slice-affinity constraint)."""
    if same_label is not None:
        values = sorted({h["labels"].get(same_label) for h in hosts
                         if h["labels"].get(same_label) is not None})
        for value in values:
            group = [h for h in hosts
                     if h["labels"].get(same_label) == value]
            plan, _ = _plan_gang_in(group, bundles, selectors, strategy)
            if plan is not None:
                return plan
        return None
    plan, _ = _plan_gang_in(hosts, bundles, selectors, strategy)
    return plan


def _fits(demand: dict, node_type: NodeTypeConfig,
          selector: dict | None = None) -> bool:
    if selector:
        labels = {**node_type.labels, "art/node-type": node_type.name,
                  "art/autoscaled": "1"}
        if not all(labels.get(k) == v for k, v in selector.items()):
            return False
    return all(node_type.resources.get(k, 0.0) >= v
               for k, v in demand.items())


class Autoscaler:
    def __init__(self, gcs_address: str, provider: NodeProvider,
                 config: AutoscalerConfig):
        self._gcs_address = gcs_address
        self._provider = provider
        self._config = config
        self._clients = ClientPool()
        self._launched: dict[str, str] = {}      # provider id -> type
        self._idle_since: dict[str, float] = {}  # provider id -> ts
        # gang demand key -> launch time: suppresses relaunching while
        # the provisioned hosts are still registering.
        self._gang_pending: dict[str, float] = {}
        self._no_address_warned: set[str] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="art-autoscaler")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self._config.interval_s):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — keep reconciling
                logger.exception("autoscaler reconcile failed")

    # --------------------------------------------------------- one round

    def run_once(self) -> dict:
        """One reconcile: returns {"launched": [...], "terminated": [...]}
        for observability/tests."""
        gcs = self._clients.get(self._gcs_address)
        gcs.call("AutoscalerHeartbeat", {}, retries=3)
        demands = gcs.call("ResourceDemands", {}, retries=3) or []
        nodes = list((gcs.call("GetAllNodes", {}, retries=3)
                      or {}).values())

        launched = self._scale_up(demands, nodes)
        budget = self._config.max_launches_per_round - len(launched)
        launched += self._backfill_min_workers(budget)
        terminated = self._scale_down(nodes)
        return {"launched": launched, "terminated": terminated}

    # --------------------------------------------------------- scale up

    def _counts_by_type(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for type_name in self._provider.non_terminated_nodes().values():
            counts[type_name] = counts.get(type_name, 0) + 1
        return counts

    @staticmethod
    def _node_satisfies(info, shape: dict, selector: dict | None) -> bool:
        """Can this live node EVER run the shape?  (total capacity +
        labels — mirrors the GCS's own infeasibility test, so a demand
        recorded before a node arrived stops driving launches once the
        node registers.)"""
        if not getattr(info, "alive", False):
            return False
        labels = getattr(info, "labels", {}) or {}
        if selector and not all(labels.get(k) == v
                                for k, v in selector.items()):
            return False
        total = getattr(info, "total_resources", {}) or {}
        return all(total.get(k, 0.0) >= v for k, v in shape.items())

    @staticmethod
    def _node_views(nodes: list, field: str = "total_resources"
                    ) -> list[dict]:
        """Live GCS nodes as planner host views.  Ids are strings: the
        plain-gang planner sorts them beside the string ids of planned
        launches, and a NodeID does not compare with a str (the JAX
        package's planner raises TypeError there, ROADMAP §C)."""
        return [{"id": str(getattr(n, "node_id", getattr(n, "address",
                                                         ""))),
                 "labels": getattr(n, "labels", {}) or {},
                 "resources": getattr(n, field, {}) or {}}
                for n in nodes if getattr(n, "alive", False)]

    def _scale_up(self, demands: list[dict], nodes: list) -> list[str]:
        counts = self._counts_by_type()
        launched: list[str] = []
        budget = self._config.max_launches_per_round
        now = time.monotonic()
        gang_keys_seen: set[str] = set()
        for demand in demands:
            if budget <= 0:
                break
            if "bundles" in demand:
                gang_keys_seen.add(self._gang_key(demand))
                units = self._scale_up_gang(demand, nodes, counts,
                                            budget, now, launched)
                budget -= units
                continue
            shape = demand.get("resources", {})
            if not shape:
                # An empty shape would "fit" anywhere and "be satisfied"
                # by any node — never act on one (malformed demand).
                continue
            selector = demand.get("label_selector") or None
            # Stale demand: some live node can already run it (leases
            # queue there); launching more would double-provision.
            if any(self._node_satisfies(n, shape, selector)
                   for n in nodes):
                continue
            # Skip shapes a pending node will satisfy — launched this
            # round, or launched earlier and still registering with the
            # GCS (provider sees it, the node table doesn't yet).
            pending_types = launched + list(
                self._provider.non_terminated_nodes().values())
            if any(_fits(shape, self._type_by_name(t), selector)
                   for t in pending_types):
                continue
            choice = self._pick_type(shape, selector, counts)
            if choice is None:
                logger.warning(
                    "demand %s (selector %s) fits no configured node "
                    "type within max_workers", shape, selector)
                continue
            pid = self._provider.create_node(choice)
            self._launched[pid] = choice.name
            counts[choice.name] = counts.get(choice.name, 0) + 1
            launched.append(choice.name)
            budget -= 1
            logger.info("autoscaler launched %s (%s) for demand %s",
                        pid, choice.name, shape)
        # Gangs that vanished (PG committed or removed) free their
        # provisioning-grace records.
        for key in [k for k in self._gang_pending
                    if k not in gang_keys_seen]:
            del self._gang_pending[key]
        return launched

    # ----------------------------------------------------- gang scale up

    @staticmethod
    def _gang_key(demand: dict) -> str:
        # Per-PG when the GCS says which PG this is (two identical-shape
        # pending PGs are two gangs needing two node sets).
        if demand.get("pg_id"):
            return f"pg:{demand['pg_id']}"
        return json.dumps(
            [[sorted(b.items()) for b in demand["bundles"]],
             [sorted((s or {}).items())
              for s in demand.get("bundle_selectors") or []],
             demand.get("strategy"), demand.get("same_label")])

    def _scale_up_gang(self, demand: dict, nodes: list,
                       counts: dict[str, int], budget: int, now: float,
                       launched: list[str]) -> int:
        """Provision for one gang demand (an unplaceable placement
        group): pick a node SET that satisfies every bundle atomically
        — for slice PGs (same_label), one whole gang-unit launch; for
        plain gangs, the minimal set of single launches — and launch it
        as a unit.  Returns the number of launch units consumed.

        Ref: python/ray/autoscaler/v2/scheduler.py gang resource
        requests; src/ray/gcs/gcs_autoscaler_state_manager.h."""
        bundles = demand["bundles"]
        selectors = demand.get("bundle_selectors")
        strategy = demand.get("strategy", "PACK")
        same_label = demand.get("same_label")
        key = self._gang_key(demand)

        # AVAILABLE resources, not totals: a gang is per-PG, so capacity
        # another committed PG or running job holds cannot serve it —
        # a pending gang whose resources are merely occupied still needs
        # new hardware (ref: v2 scheduler treats pending gang requests
        # as demand against free capacity).
        views = self._node_views(nodes, "available_resources")
        if plan_gang(views, bundles, selectors, strategy,
                     same_label) is not None:
            # Some live node set can hold the whole gang — placement is
            # the GCS PG scheduler's job, not ours.
            self._gang_pending.pop(key, None)
            return 0
        pending_since = self._gang_pending.get(key)
        if pending_since is not None and \
                now - pending_since < self._config.gang_provision_grace_s:
            return 0          # our earlier launch is still registering

        # 1) Whole-gang unit launch (TPU slice node types): one launch
        #    yields hosts_per_launch hosts that cover every bundle.
        unit_types = sorted(
            self._config.node_types,
            key=lambda t: sum(t.resources.values()) * t.hosts_per_launch)
        for node_type in unit_types:
            if counts.get(node_type.name, 0) >= node_type.max_workers:
                continue
            if plan_gang(node_type.launch_host_views(), bundles,
                         selectors, strategy, same_label) is None:
                continue
            if budget < 1:
                return 0
            pid = self._provider.create_node(node_type)
            self._launched[pid] = node_type.name
            counts[node_type.name] = counts.get(node_type.name, 0) + 1
            launched.append(node_type.name)
            self._gang_pending[key] = now
            logger.info(
                "autoscaler launched gang unit %s (%s, %d hosts) for "
                "%d-bundle gang demand", pid, node_type.name,
                node_type.hosts_per_launch, len(bundles))
            return 1

        if same_label is not None:
            # A slice-affinity gang can't be assembled from independent
            # single launches (each would carry a different slice id).
            logger.warning(
                "gang demand (%d bundles, same_label=%s) fits no "
                "configured gang-unit node type within max_workers — "
                "configure a node type with hosts_per_launch/"
                "launch_shared_label matching the slice "
                "(see tpu_slice_node_type)", len(bundles), same_label)
            return 0

        # 2) Plain gang: grow a virtual view of (live nodes + planned
        #    launches) until the whole gang plans, then launch the
        #    additions together — all or nothing within this round.
        needed: list[NodeTypeConfig] = []
        planned_counts = dict(counts)
        virtual = list(views)
        for _ in range(len(bundles)):
            plan, failed = _plan_gang_in(virtual, bundles, selectors,
                                         strategy)
            if plan is not None:
                break
            selector = (selectors[failed]
                        if selectors and failed < len(selectors) else None)
            choice = self._pick_type(bundles[failed], selector or None,
                                     planned_counts)
            if choice is None:
                logger.warning(
                    "gang demand bundle %s (selector %s) fits no "
                    "configured node type within max_workers",
                    bundles[failed], selector)
                return 0
            needed.append(choice)
            planned_counts[choice.name] = \
                planned_counts.get(choice.name, 0) + 1
            virtual += [{**h, "id": f"planned-{len(needed)}/{h['id']}"}
                        for h in choice.launch_host_views()]
        else:
            plan, _ = _plan_gang_in(virtual, bundles, selectors, strategy)
            if plan is None:
                return 0
        if not needed:
            return 0
        if len(needed) > budget:
            # A gang larger than one round's budget launches in chunks:
            # after the grace period the registered chunk shrinks the
            # replan, so successive rounds converge on the full set.
            logger.info(
                "gang needs %d launches but round budget leaves %d — "
                "launching a chunk, remainder next round",
                len(needed), budget)
            needed = needed[:budget]
        for node_type in needed:
            pid = self._provider.create_node(node_type)
            self._launched[pid] = node_type.name
            counts[node_type.name] = counts.get(node_type.name, 0) + 1
            launched.append(node_type.name)
        self._gang_pending[key] = now
        logger.info("autoscaler launched %d nodes (%s) for %d-bundle "
                    "gang demand", len(needed),
                    [t.name for t in needed], len(bundles))
        return len(needed)

    def _backfill_min_workers(self, budget: int) -> list[str]:
        counts = self._counts_by_type()
        launched = []
        for node_type in self._config.node_types:
            while counts.get(node_type.name, 0) < node_type.min_workers:
                if budget <= 0:  # rest next round — keep rounds short
                    return launched
                pid = self._provider.create_node(node_type)
                self._launched[pid] = node_type.name
                counts[node_type.name] = counts.get(node_type.name, 0) + 1
                launched.append(node_type.name)
                budget -= 1
        return launched

    def _type_by_name(self, name: str) -> NodeTypeConfig:
        for node_type in self._config.node_types:
            if node_type.name == name:
                return node_type
        raise KeyError(name)

    def _pick_type(self, shape: dict, selector: dict | None,
                   counts: dict[str, int]) -> NodeTypeConfig | None:
        """Smallest feasible type with headroom (first fit by total
        resource sum — the v2 scheduler's utilization-score analogue)."""
        feasible = [t for t in self._config.node_types
                    if _fits(shape, t, selector)
                    and counts.get(t.name, 0) < t.max_workers]
        if not feasible:
            return None
        return min(feasible, key=lambda t: sum(t.resources.values()))

    # --------------------------------------------------------- scale down

    def _scale_down(self, nodes: list) -> list[str]:
        """Terminate autoscaled nodes idle past the timeout (never below
        min_workers for their type)."""
        provider_nodes = self._provider.non_terminated_nodes()
        counts = self._counts_by_type()
        now = time.monotonic()
        terminated: list[str] = []

        # Which GCS nodes are idle?  (all resources back to total and no
        # leases — the heartbeat view.)
        idle_addresses = set()
        for info in nodes:
            if not getattr(info, "alive", False):
                continue
            total = getattr(info, "total_resources", {})
            available = getattr(info, "available_resources", {})
            if all(available.get(k, 0.0) >= v for k, v in total.items()):
                idle_addresses.add(getattr(info, "address", ""))

        for pid, type_name in list(provider_nodes.items()):
            if pid not in self._launched:
                continue  # not ours (statically provisioned)
            addresses = self._provider.node_addresses(pid)
            if addresses is None:
                if pid not in self._no_address_warned:
                    self._no_address_warned.add(pid)
                    logger.warning(
                        "provider gives no address for %s — idle "
                        "scale-down disabled for it; terminate via the "
                        "provider explicitly when it drains", pid)
                continue
            # A gang unit (TPU slice) terminates as a whole, so it only
            # counts as idle when EVERY host is idle.
            if not all(a in idle_addresses for a in addresses):
                self._idle_since.pop(pid, None)
                continue
            node_type = self._type_by_name(type_name)
            if counts.get(type_name, 0) <= node_type.min_workers:
                continue
            first_idle = self._idle_since.setdefault(pid, now)
            if now - first_idle < self._config.idle_timeout_s:
                continue
            logger.info("autoscaler terminating idle node %s (%s)",
                        pid, type_name)
            self._provider.terminate_node(pid)
            self._launched.pop(pid, None)
            self._idle_since.pop(pid, None)
            counts[type_name] -= 1
            terminated.append(type_name)
        return terminated
