"""Runtime lock-order detector for the runtime's planes (the port of the
JAX package's ``_lint/lockcheck.py``; its static lint rules check that
package's sources and are not copied).

A static pass can prove a blocking call sits inside ONE critical
section; what it cannot see is the ORDER two threads take two locks in.
A→B in the lease path and B→A in the eviction path is a deadlock that
fires once a year, under load.  This module finds it in any chaos soak
instead:

* :func:`make_lock` / :func:`make_rlock` are the factories the planes
  use (the object store, the memory store, the worker, the RPC client
  pool, the node daemon, task events).  **Off** (the default), they
  return a plain ``threading.Lock`` / ``RLock`` — zero wrappers, zero
  overhead.  **On** (``ART_LOCKCHECK=1`` or
  ``_system_config={"lockcheck": True}``, which ``init`` exports to the
  processes it spawns as that variable), they return an instrumented
  wrapper that records, per process:

  - the **lock-acquisition graph**: an edge A→B each time a thread
    acquires B while holding A.  A cycle in that graph is a lock-order
    inversion — two threads interleaving those paths can deadlock —
    and is reported the moment the closing edge is recorded, with both
    edges' acquire stacks.
  - **long holds over blocking calls**: sites that hold a lock across
    a sync RPC, socket I/O or a subprocess call :func:`note_blocking`;
    if a lock held across such a call exceeds
    ``lockcheck_hold_budget_s``, the hold is reported with its acquire
    stack.

* Reports are logged (``LOCKCHECK: ...`` on the process's log) and go
  through the flight recorder as force-sampled error spans
  (``lockcheck:cycle`` / ``lockcheck:long-hold``), so a detection is
  visible in the GCS span ring like any other failure evidence.

The detector observes orders that actually executed, so its coverage is
exactly what the run exercised: wire it into every chaos run
(``util/chaos.py``'s users do, through a ``lockcheck_hunt`` fixture).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback

logger = logging.getLogger(__name__)

_tls = threading.local()

# Module state (per process).  _STATE_LOCK is a plain lock guarding the
# graph — the detector must not instrument itself.
_STATE_LOCK = threading.Lock()
_edges: dict[str, set[str]] = {}            # name -> names acquired under it
_edge_stacks: dict[tuple[str, str], str] = {}
_reported_cycles: set[frozenset] = set()
_reports: list[dict] = []
_counter = 0

_enabled_cache: bool | None = None


def enabled() -> bool:
    """Lockcheck verdict for this process, decided once: the
    ``ART_LOCKCHECK`` env var (the channel spawned daemons inherit) or
    the ``lockcheck`` config flag (``_system_config`` path)."""
    global _enabled_cache
    if _enabled_cache is None:
        if os.environ.get("ART_LOCKCHECK", "").lower() in ("1", "true",
                                                           "yes"):
            _enabled_cache = True
        else:
            try:
                from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415

                _enabled_cache = bool(global_config().lockcheck)
            except Exception:  # noqa: BLE001 — config must never wedge a lock
                _enabled_cache = False
    return _enabled_cache


def refresh_enabled() -> bool:
    """Re-evaluate the verdict.  ``art.init`` calls this after applying
    ``_system_config``: import-time factory calls (the worker singleton)
    may have cached a pre-init False, which would otherwise make the
    config channel dead in the driver process.  Locks created BEFORE
    the refresh stay plain — instrumentation covers everything built
    from init onward (daemons decide once at boot, via the env var
    init exports)."""
    global _enabled_cache
    _enabled_cache = None
    return enabled()


def _hold_budget_s() -> float:
    try:
        from ant_ray_tpu_torch._private.config import global_config  # noqa: PLC0415

        return float(global_config().lockcheck_hold_budget_s)
    except Exception:  # noqa: BLE001
        return 0.25


def make_lock(name: str | None = None):
    """A mutex for the daemon planes.  Disabled: exactly
    ``threading.Lock()``.  Enabled: an :class:`InstrumentedLock`."""
    if not enabled():
        return threading.Lock()
    return InstrumentedLock(threading.Lock(), _name(name))


def make_rlock(name: str | None = None):
    if not enabled():
        return threading.RLock()
    return InstrumentedLock(threading.RLock(), _name(name), reentrant=True)


def _name(name: str | None) -> tuple[str, str]:
    """(display name, graph node id).  The graph is keyed by INSTANCE
    (``name#seq``), not by name: two same-named locks (every ClientPool
    shares "rpc.client_pool") taken A→B on one thread and B→A on
    another are a genuine inversion that name-keying would hide, and a
    cycle stitched together from edges of two *different* instances
    would be a false positive.  Reports render the names."""
    global _counter
    with _STATE_LOCK:
        _counter += 1
        n = _counter
    name = name or f"anon-lock-{n}"
    return name, f"{name}#{n}"


class _Held:
    """One live acquisition on a thread's hold stack."""

    __slots__ = ("node", "t0", "blocking")

    def __init__(self, node: str):
        self.node = node
        self.t0 = time.monotonic()
        self.blocking: str | None = None


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def note_blocking(what: str) -> None:
    """Mark every lock the calling thread currently holds as having
    executed a known-blocking call (sync RPC round trip, socket I/O,
    subprocess).  Free when lockcheck is off; the long-hold report
    fires only for holds that both carried a blocking call AND
    exceeded the budget."""
    if _enabled_cache is not True:   # fast path: disabled or undecided
        if not enabled():
            return
    for held in getattr(_tls, "held", ()) or ():
        if held.blocking is None:
            held.blocking = what


class InstrumentedLock:
    """Context-manager/lock-API wrapper recording acquisition order.

    Not handed to ``threading.Condition`` — conditions manage their own
    lock internals; the daemon planes only wrap plain mutexes."""

    __slots__ = ("_lock", "name", "_node", "_reentrant")

    def __init__(self, lock, name: tuple[str, str],
                 reentrant: bool = False):
        self._lock = lock
        self.name, self._node = name
        self._reentrant = reentrant

    # -- lock API -------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._on_acquire()
        return got

    def release(self):
        self._on_release()
        self._lock.release()

    def locked(self):
        return self._lock.locked() if hasattr(self._lock, "locked") \
            else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- graph bookkeeping ---------------------------------------------
    def _on_acquire(self) -> None:
        stack = _held_stack()
        holding = [h.node for h in stack if h.node != self._node]
        stack.append(_Held(self._node))
        if not holding:
            return
        new_edges = []
        with _STATE_LOCK:
            for outer in holding:
                under = _edges.setdefault(outer, set())
                if self._node not in under:
                    under.add(self._node)
                    new_edges.append(outer)
                    _edge_stacks[(outer, self._node)] = "".join(
                        traceback.format_stack(limit=8)[:-1])
            cycles = [self._find_cycle(outer) for outer in new_edges]
        for cycle in cycles:
            if cycle:
                self._report_cycle(cycle)

    def _find_cycle(self, outer: str) -> list[str] | None:
        """A node path self._node → ... → outer closes the new edge
        outer → self._node into a cycle.  Called under _STATE_LOCK."""
        target, start = outer, self._node
        seen = {start}
        path = [start]

        def dfs(node: str) -> bool:
            if node == target:
                return True
            for nxt in _edges.get(node, ()):
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                if dfs(nxt):
                    return True
                path.pop()
            return False

        if dfs(start):
            # path runs start..target; target == outer already heads
            # the cycle, so drop it from the tail: [B, A] renders as
            # B -> A -> B with edges (B->A new, A->B recorded).
            return [outer, *path[:-1]]
        return None

    def _report_cycle(self, nodes: list[str]) -> None:
        key = frozenset(nodes)
        with _STATE_LOCK:
            if key in _reported_cycles:
                return
            _reported_cycles.add(key)
            stacks = {
                f"{a}->{b}": _edge_stacks.get((a, b), "")
                for a, b in zip(nodes, nodes[1:] + nodes[:1])
                if (a, b) in _edge_stacks}
        names = [n.rsplit("#", 1)[0] for n in nodes]
        order = " -> ".join([*names, names[0]])
        report = {"kind": "cycle", "cycle": names, "nodes": list(nodes),
                  "order": order, "stacks": stacks,
                  "thread": threading.current_thread().name}
        _emit(report,
              f"lock-order inversion (potential deadlock): {order}")

    def _on_release(self) -> None:
        stack = getattr(_tls, "held", None)
        if not stack:
            return
        # Non-LIFO release is legal; drop the newest matching entry.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].node == self._node:
                held = stack.pop(i)
                break
        else:
            return
        if self._reentrant and any(h.node == self._node for h in stack):
            return   # inner release of a reentrant hold
        dur = time.monotonic() - held.t0
        if held.blocking is not None and dur > _hold_budget_s():
            report = {"kind": "long-hold", "lock": self.name,
                      "held_s": round(dur, 4),
                      "blocking": held.blocking,
                      "budget_s": _hold_budget_s(),
                      "thread": threading.current_thread().name}
            _emit(report,
                  f"lock {self.name!r} held {dur:.3f}s across blocking "
                  f"call {held.blocking!r} "
                  f"(budget {_hold_budget_s():.3f}s)")

    def __repr__(self):  # pragma: no cover — debugging aid
        return f"InstrumentedLock({self.name!r})"


def _emit(report: dict, message: str) -> None:
    """Console + flight recorder: the report rides the force-sampled
    ring, so ``/api/flightrecorder`` and the GCS span ring surface it
    even at trace_sample_rate=0."""
    with _STATE_LOCK:
        _reports.append(report)
    logger.error("LOCKCHECK: %s", message)
    try:
        from ant_ray_tpu_torch.observability import tracing_plane  # noqa: PLC0415

        attrs = {k: (v if isinstance(v, (str, int, float)) else repr(v))
                 for k, v in report.items() if k != "stacks"}
        tracing_plane.record_span(
            tracing_plane.mint(sampled=False),
            f"lockcheck:{report['kind']}", ts=time.time(), dur_s=0.0,
            attrs=attrs, error=True, service="lockcheck")
    except Exception:  # noqa: BLE001 — reporting must never deadlock
        pass


# ----------------------------------------------------------- introspection

def reports() -> list[dict]:
    """Detections so far in this process (tests and soak assertions)."""
    with _STATE_LOCK:
        return list(_reports)


def edges() -> dict[str, set[str]]:
    with _STATE_LOCK:
        return {k: set(v) for k, v in _edges.items()}


def reset(enabled_override: bool | None = None) -> None:
    """Clear graph/report state (tests).  ``enabled_override`` pins the
    verdict without consulting env/config; None re-evaluates lazily."""
    global _enabled_cache
    with _STATE_LOCK:
        _edges.clear()
        _edge_stacks.clear()
        _reported_cycles.clear()
        _reports.clear()
    _enabled_cache = enabled_override
