"""Serve: deployments, replicas, routing, HTTP ingress (the port of
ant_ray_tpu/serve/api.py, which the port does not import).

Scaled-down mirror of the reference architecture (SURVEY §2.4 Serve /
§3.6): ``serve.run`` starts a named **controller actor** that reconciles
desired deployment state into **replica actors**; **handles** route calls
to replicas with power-of-two-choices over reported queue depths
(ref: serve/_private/router.py:472); an optional aiohttp **proxy actor**
exposes deployments over HTTP (ref: serve/_private/proxy.py).  Replicas
report ongoing-request counts, which also drive **queue-based
autoscaling** (ref: serve/_private/autoscaling_state.py), and
``@serve.batch`` coalesces concurrent calls into one model invocation
(ref: serve/batching.py).

The module imports no torch: the controller, the proxies and the
handles run in processes that never touch a tensor, and a replica
imports torch only if the class it wraps does.  aiohttp and grpcio are
imported when a proxy starts, never at import.

A replica sets ``_request_deadline`` around the user code it invokes,
from the deadline the ingress or handle stamped; a caller that drives
an ``LLMServer`` in its own process sets it itself::

    token = _request_deadline.set(time.time() + 2.0)
    try:
        server(request)
    finally:
        _request_deadline.reset(token)

A ContextVar is per thread (and per asyncio task): a deadline set in one
thread is not seen by another.
"""

from __future__ import annotations

import collections
import contextvars
import functools
import itertools
import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ant_ray_tpu_torch.exceptions import (
    BackPressureError,
    DeadlineExceededError,
    GetTimeoutError,
)
from ant_ray_tpu_torch.observability import tracing_plane
from ant_ray_tpu_torch.observability.tracing_plane import TraceContext

CONTROLLER_NAME = "_serve_controller"


def _art():
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    return art


def _runtime():
    """This process's runtime (None once it shut down).  Serve's
    background loops stop when it changes: their next API call would
    otherwise auto-init a new cluster in a process that shut its own
    down."""
    from ant_ray_tpu_torch._private.worker import global_worker  # noqa: PLC0415

    return global_worker.runtime


# ------------------------------------------------------------- observability

_METRICS: dict | None = None
_METRICS_LOCK = threading.Lock()


def _metrics() -> dict:
    """Lazy ``art_serve_*`` instruments (the metrics plane: recorded to
    the GCS metrics table, read with ``MetricsGet``).  Lazy
    so importing serve never touches the worker runtime; emission is
    best-effort and a no-op outside a cluster."""
    global _METRICS
    if _METRICS is None:
        with _METRICS_LOCK:
            if _METRICS is None:
                from ant_ray_tpu_torch.util.metrics import Counter, Gauge  # noqa: PLC0415

                _METRICS = {
                    "shed": Counter(
                        "art_serve_shed_requests_total",
                        "Requests shed by admission control / deadlines "
                        "(reason: backpressure|deadline)",
                        tag_keys=("deployment", "reason")),
                    "queue_depth": Gauge(
                        "art_serve_queue_depth",
                        "Sum of per-replica ongoing+queued requests",
                        tag_keys=("deployment",)),
                    "breaker": Gauge(
                        "art_serve_breaker_state",
                        "Per-replica circuit breaker state "
                        "(0=closed 1=half-open 2=open)",
                        tag_keys=("deployment", "replica")),
                    "suspect": Gauge(
                        "art_serve_suspect_replicas",
                        "Replicas ejected for repeated ongoing-poll "
                        "timeouts", tag_keys=("deployment",)),
                    "retries": Counter(
                        "art_serve_retries_total",
                        "Handle-level retries re-picked to another "
                        "replica", tag_keys=("deployment",)),
                    "retry_exhausted": Counter(
                        "art_serve_retry_budget_exhausted_total",
                        "Retries suppressed by an empty token bucket",
                        tag_keys=("deployment",)),
                }
    return _METRICS


def _emit(name: str, value: float, tags: dict) -> None:
    try:
        metric = _metrics()[name]
        if hasattr(metric, "inc"):
            metric.inc(value, tags)
        else:
            metric.set(value, tags)
    except Exception:  # noqa: BLE001 — observability must never fail a request
        pass


def _typed_cause(exc: BaseException):
    """Unwrap the typed overload error from an actor-task error chain
    (a replica-raised BackPressureError arrives as
    ``ActorError(cause=BackPressureError)``)."""
    for c in (exc, getattr(exc, "cause", None)):
        if isinstance(c, (BackPressureError, DeadlineExceededError)):
            return c
    return None


def _expire_replica_series(replica) -> None:
    """Drop a torn-down replica's per-replica gauges (the breaker-state
    series is tagged by replica id) from the GCS metrics table —
    without this every scaled-down or migrated replica haunts /metrics
    forever."""
    try:
        from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415

        rt = global_worker.runtime
        rt._send_oneway(
            rt.gcs_address, "MetricsExpire",
            {"match_tags": {"replica": replica.actor_id.hex()[:12]}})
    except Exception:  # noqa: BLE001 — observability is best-effort
        pass


def _record_result(routing, replica, exc: BaseException | None = None):
    """Feed a request outcome into the replica's breaker.  Typed
    overload sheds are the admission gate speaking, not a health
    outcome; any other error (handler raise, actor death, connection
    loss) counts as a failure — per-replica corruption usually
    manifests as handler errors, and the ejection CAP
    (``max_eject_fraction``) is what protects a healthy fleet from a
    deterministic bad-input stream, not the error taxonomy."""
    if exc is not None and _typed_cause(exc) is not None:
        return
    routing.record_outcome(replica, exc is None)


# ---------------------------------------------------------------- public

@dataclass(frozen=True)
class AutoscalingConfig:
    """Queue-depth-driven replica scaling
    (ref: serve/_private/autoscaling_state.py + AutoscalingConfig)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    # Seconds between controller scaling decisions.
    interval_s: float = 0.5
    # Consecutive low-load intervals required before scaling down
    # (downscale damping, ref: downscale_delay_s).
    downscale_patience: int = 4
    # Signal-targeted scaling: when set, the controller ALSO polls each
    # replica's ``load_signals()`` dict (e.g. the LLM engine loop's
    # art_llm_tokens_per_s / art_llm_queue_depth /
    # art_llm_resident_sessions gauges) and sizes the deployment so
    # sum(signal) / target_value replicas carry the load; the final
    # desired count is the max of the ongoing-based and signal-based
    # answers — queue depth still protects against a signal going
    # stale.  Replicas without a load_signals() method contribute 0.
    target_signal: str | None = None
    target_value: float = 1.0


@dataclass(frozen=True)
class RequestRetryConfig:
    """Opt-in handle-level retries for IDEMPOTENT handlers, bounded by
    a token-bucket retry budget (ref in spirit: the reference router's
    retryable-request semantics + SRE retry-budget practice).  Each
    completed request earns ``budget_fraction`` tokens (capped at
    ``budget_burst``); a retry spends one — a full outage can never
    amplify offered load by more than ~``budget_fraction``."""

    max_attempts: int = 3
    budget_fraction: float = 0.1
    budget_burst: float = 10.0
    # Also retry replica-side BackPressureError sheds on a different
    # replica (a re-pick, not a re-execution: the shed request never
    # ran).
    retry_backpressure: bool = True


@dataclass(frozen=True)
class CircuitBreakerConfig:
    """Per-replica circuit breaker in the router (ref capability:
    envoy-style outlier ejection; the reference routes around failing
    replicas via health checks).  Opens on failure rate over a sliding
    outcome window or on controller 'suspect' marks (repeated
    ongoing-poll timeouts); after ``cooldown_s`` one probation probe is
    allowed through (half-open) and a success closes the breaker."""

    window: int = 20
    min_outcomes: int = 5
    failure_rate: float = 0.5
    cooldown_s: float = 2.0
    # Ejection cap (envoy max_ejection_percent): failure-RATE opens
    # never eject more than this fraction of the replica set, so a
    # deterministic bad-input stream (which fails on EVERY replica)
    # cannot breaker-open a healthy deployment into a 429 outage.  A
    # single-replica deployment is never rate-ejected (cap rounds to
    # 0) — its errors surface to the client as themselves.  Liveness
    # (controller suspect) opens bypass the cap: a genuinely dead
    # replica must be ejected no matter how many already are.
    max_eject_fraction: float = 0.5


@dataclass
class Deployment:
    cls_or_fn: Any
    name: str
    num_replicas: int = 1
    route_prefix: str | None = None
    ray_actor_options: dict = field(default_factory=dict)
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)
    autoscaling_config: AutoscalingConfig | None = None
    # Redeploys replace replicas version-by-version, at most this many
    # extra replicas alive at once (ref: deployment_state.py:2597
    # rolling updates + max surge).
    rolling_max_surge: int = 1
    # ---- overload-resilience knobs (ref: DeploymentConfig
    # max_ongoing_requests / max_queued_requests + proxy
    # request_timeout_s).  None max_ongoing_requests = no admission
    # gate (legacy behavior).
    max_ongoing_requests: int | None = None
    max_queued_requests: int = 0
    request_timeout_s: float | None = None
    retry_config: RequestRetryConfig | None = None
    breaker_config: CircuitBreakerConfig | None = None

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, *, num_replicas: int | None = None,
                route_prefix: str | None = None,
                name: str | None = None,
                autoscaling_config: AutoscalingConfig | dict | None = None,
                rolling_max_surge: int | None = None,
                max_ongoing_requests: int | None = None,
                max_queued_requests: int | None = None,
                request_timeout_s: float | None = None,
                retry_config: "RequestRetryConfig | dict | None" = None,
                breaker_config: "CircuitBreakerConfig | dict | None" = None,
                ) -> "Deployment":
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if isinstance(retry_config, dict):
            retry_config = RequestRetryConfig(**retry_config)
        if isinstance(breaker_config, dict):
            breaker_config = CircuitBreakerConfig(**breaker_config)
        return Deployment(
            cls_or_fn=self.cls_or_fn,
            name=name or self.name,
            num_replicas=num_replicas or self.num_replicas,
            route_prefix=(route_prefix if route_prefix is not None
                          else self.route_prefix),
            ray_actor_options=dict(self.ray_actor_options),
            init_args=self.init_args,
            init_kwargs=dict(self.init_kwargs),
            autoscaling_config=(autoscaling_config
                                or self.autoscaling_config),
            rolling_max_surge=(rolling_max_surge
                               if rolling_max_surge is not None
                               else self.rolling_max_surge),
            max_ongoing_requests=(max_ongoing_requests
                                  if max_ongoing_requests is not None
                                  else self.max_ongoing_requests),
            max_queued_requests=(max_queued_requests
                                 if max_queued_requests is not None
                                 else self.max_queued_requests),
            request_timeout_s=(request_timeout_s
                               if request_timeout_s is not None
                               else self.request_timeout_s),
            retry_config=retry_config or self.retry_config,
            breaker_config=breaker_config or self.breaker_config,
        )

    def overload_config(self) -> dict:
        """The routing-relevant knobs, pushed to every handle through
        the controller's long-poll channel."""
        return {
            "request_timeout_s": self.request_timeout_s,
            "retry": self.retry_config,
            "breaker": self.breaker_config or CircuitBreakerConfig(),
        }


@dataclass
class Application:
    deployment: Deployment
    args: tuple
    kwargs: dict


def deployment(_cls=None, *, name: str | None = None, num_replicas: int = 1,
               route_prefix: str | None = None,
               ray_actor_options: dict | None = None,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               max_ongoing_requests: int | None = None,
               max_queued_requests: int = 0,
               request_timeout_s: float | None = None,
               retry_config: "RequestRetryConfig | dict | None" = None,
               breaker_config: "CircuitBreakerConfig | dict | None" = None):
    """``@serve.deployment`` decorator (ref: serve/api.py)."""
    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)
    if isinstance(retry_config, dict):
        retry_config = RequestRetryConfig(**retry_config)
    if isinstance(breaker_config, dict):
        breaker_config = CircuitBreakerConfig(**breaker_config)

    def wrap(cls_or_fn):
        return Deployment(
            cls_or_fn=cls_or_fn,
            name=name or getattr(cls_or_fn, "__name__", "deployment"),
            num_replicas=num_replicas,
            route_prefix=route_prefix,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling_config=autoscaling_config,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            request_timeout_s=request_timeout_s,
            retry_config=retry_config,
            breaker_config=breaker_config,
        )

    if _cls is not None:
        return wrap(_cls)
    return wrap


# How far AHEAD of the earliest request deadline the flusher fires: a
# flush at exactly the deadline would shed the item it was pulled
# forward for (the expiry check runs at flush time), so fire with this
# much runway for the model call to complete and the reply to ship.
_BATCH_FLUSH_MARGIN_S = 0.1


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch``: coalesce concurrent single-item calls into one
    list call (ref: serve/batching.py).  The wrapped method must accept a
    LIST of items and return a LIST of results, one per item; callers
    still call it with a single item.  Requires the deployment to run
    with ``ray_actor_options={"max_concurrency": N}`` so calls can
    overlap inside the replica."""

    def wrap(fn):
        # Batch state lives on the INSTANCE (created lazily on first
        # call): a closure-level Lock would make the deployment class
        # unpicklable for shipping to replica workers.
        state_attr = f"_art_batch_state_{fn.__name__}"

        def get_state(self_obj):
            state = getattr(self_obj, state_attr, None)
            if state is None:
                cv = threading.Condition()
                state = self_obj.__dict__.setdefault(
                    state_attr, {"cv": cv, "items": []})
            return state

        def flush(self_obj, my_batch):
            # Deadline-aware flush: items whose end-to-end deadline
            # already expired are SHED (typed error, event set) without
            # ever reaching the model — executing them would waste a
            # model invocation slot on work nobody is waiting for.
            now = time.time()
            live = []
            for item, slot in my_batch:
                dl = slot["deadline_ts"]
                if dl is not None and now >= dl:
                    slot["result"] = DeadlineExceededError(
                        f"request deadline expired "
                        f"{now - dl:.3f}s before batch flush")
                    slot["event"].set()
                else:
                    live.append((item, slot))
            if not live:
                return
            items = [it for it, _ in live]
            try:
                results = fn(self_obj, items)
                if len(results) != len(items):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} "
                        f"results for {len(items)} items")
            except Exception as e:  # noqa: BLE001 — fan the error out
                results = [e] * len(items)
            for (_, slot), result in zip(live, results):
                slot["result"] = result
                slot["event"].set()

        def wrapper(self_obj, item):
            state = get_state(self_obj)
            cv = state["cv"]
            # NB: read the deadline via the module-level accessor, not
            # the ContextVar itself — this closure is cloudpickled by
            # value with the user's class, and ContextVars can't be
            # pickled (the accessor is resolved by reference).
            slot = {"event": threading.Event(), "result": None,
                    "deadline_ts": get_request_deadline()}
            with cv:
                state["items"].append((item, slot))
                is_flusher = len(state["items"]) == 1
                cv.notify_all()
            if is_flusher:
                # Event-driven wait (no polling tax): arrivals notify
                # the condition, so a full batch flushes the moment its
                # last item lands, and an item with a tight end-to-end
                # deadline pulls the flush forward so it is served
                # before it expires.
                wait_deadline = time.monotonic() + batch_wait_timeout_s
                with cv:
                    while len(state["items"]) < max_batch_size:
                        remaining = wait_deadline - time.monotonic()
                        req_deadline_ts = [
                            s["deadline_ts"] for _, s in state["items"]
                            if s["deadline_ts"] is not None]
                        if req_deadline_ts:
                            # Wall clock: deadline_ts is the wire field.
                            remaining = min(
                                remaining,
                                min(req_deadline_ts) - time.time()
                                - _BATCH_FLUSH_MARGIN_S)
                        if remaining <= 0:
                            break
                        cv.wait(remaining)
                # Drain in ≤max_batch_size chunks until empty: the model
                # never sees an oversized batch, and late arrivals that
                # saw a non-empty queue (so didn't become flushers) are
                # never stranded.
                while True:
                    with cv:
                        my_batch = state["items"][:max_batch_size]
                        state["items"] = state["items"][max_batch_size:]
                    if not my_batch:
                        break
                    flush(self_obj, my_batch)
            # Non-flushers wait for their batch-mate to flush; the
            # flusher's own event was set inside flush().
            slot["event"].wait()
            if isinstance(slot["result"], Exception):
                raise slot["result"]
            return slot["result"]

        wrapper.__name__ = fn.__name__
        wrapper.__wrapped__ = fn
        wrapper.__art_serve_batch__ = (max_batch_size,
                                       batch_wait_timeout_s)
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


# ------------------------------------------------------------ multiplexing

_multiplexed_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")

# Absolute (time.time) end-to-end deadline of the in-flight request,
# stamped by the ingress/handle and set by the replica around user-code
# invocation so nested machinery (@serve.batch, the LLM engine) can
# shed expired work instead of executing it.
_request_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "serve_request_deadline", default=None)


def get_multiplexed_model_id() -> str:
    """Model id of the in-flight request, inside a replica method
    (ref: serve.get_multiplexed_model_id)."""
    return _multiplexed_model_id.get()


def get_request_deadline() -> float | None:
    """Absolute ``time.time()`` deadline of the in-flight request (None
    when the caller set no deadline), inside a replica method."""
    return _request_deadline.get()


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate a replica's model-loader method: per-replica LRU of
    loaded models, keyed by model id (ref: serve/_private/multiplex.py +
    @serve.multiplexed).  Callers steer requests with
    ``handle.options(multiplexed_model_id="m")``; the handle keeps
    model→replica affinity so one model isn't re-loaded on every
    replica (design note: affinity is handle-local here, where the
    reference shares replica model sets via controller long-poll — same
    steady state for any given caller, no extra control-plane chatter).
    """

    def wrap(fn):
        cache_attr = f"__serve_mux_cache_{fn.__name__}"
        lock_attr = f"__serve_mux_lock_{fn.__name__}"

        @functools.wraps(fn)
        def wrapper(self_obj, model_id=None):
            if model_id is None:
                model_id = get_multiplexed_model_id()
            lock = getattr(self_obj, lock_attr, None)
            if lock is None:
                lock = threading.Lock()
                setattr(self_obj, lock_attr, lock)
            # One lock over lookup AND load: replicas run requests on a
            # thread pool, and two concurrent misses for one model must
            # not both run the loader (double model load = OOM with
            # real weights) or race the OrderedDict.
            with lock:
                cache = getattr(self_obj, cache_attr, None)
                if cache is None:
                    cache = collections.OrderedDict()
                    setattr(self_obj, cache_attr, cache)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = fn(self_obj, model_id)
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)  # LRU eviction
                return model

        wrapper.__serve_multiplexed__ = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap



class _Breaker:
    """Per-replica circuit state inside a routing family (closed →
    open → half-open → closed).  Mutated only under the routing lock."""

    __slots__ = ("state", "outcomes", "opened_at", "last_probe_at")

    def __init__(self, window: int):
        self.state = "closed"
        self.outcomes: collections.deque = collections.deque(
            maxlen=max(1, window))
        self.opened_at = 0.0
        self.last_probe_at = 0.0


class _RoutingState:
    """Replica set + queue snapshot shared by an options()-derived
    handle family, kept fresh by ONE controller long-poll listener
    thread (ref: serve/_private/long_poll.py LongPollClient).  The
    controller blocks the listen call until the deployment's version
    advances, so scale-ups/downs reach every handle within one push —
    no TTL staleness window.  A slow TTL poll remains as fallback for
    the window before the listener's first reply (or if it dies).

    Also owns the deployment's ROUTER RESILIENCE state: per-replica
    circuit breakers (opened by observed failure rate or by controller
    'suspect' marks from repeated ongoing-poll timeouts, re-entered via
    half-open probation probes) and the token-bucket retry budget."""

    def __init__(self, name: str, replicas: list, controller):
        self.lock = threading.Lock()
        self.name = name
        self.replicas = list(replicas)
        self.ongoing: list = [0] * len(replicas)
        self.local_extra: dict[int, int] = {}
        # -1 = "never synced": the first listen_for_change round trip
        # returns immediately with the deployment's CURRENT state —
        # critically the overload config (request_timeout_s / retry /
        # breaker) — instead of blocking until the next version bump.
        # Construction sites that already hold a get_handle_info
        # payload apply() it synchronously and skip this window.
        self.version = -1
        self.controller = controller
        self._listener: threading.Thread | None = None
        self._last_poll = time.monotonic()
        # Overload-plane config pushed by the controller (deployment
        # defaults); present before the first push so raw handles work.
        self.config: dict = {"request_timeout_s": None, "retry": None,
                             "breaker": CircuitBreakerConfig()}
        self.suspect: set = set()           # actor ids, controller-fed
        self.breakers: dict = {}            # actor id -> _Breaker
        self.retry_tokens: float | None = None

    def apply(self, info: dict) -> None:
        with self.lock:
            old_replicas = self.replicas
            old_extra = self.local_extra
            new_replicas = list(info["replicas"])
            # Carry this family's in-flight dispatch counts across the
            # update (remapped by replica identity): wiping them would
            # erase the load signal mid-burst and skew po2 routing.
            new_index = {r.actor_id: i
                         for i, r in enumerate(new_replicas)}
            extra: dict[int, int] = {}
            for index, count in old_extra.items():
                if index < len(old_replicas):
                    ni = new_index.get(old_replicas[index].actor_id)
                    if ni is not None:
                        extra[ni] = extra.get(ni, 0) + count
            self.replicas = new_replicas
            self.ongoing = list(info.get("ongoing",
                                         [0] * len(new_replicas)))
            self.local_extra = extra
            self.version = info.get("version", self.version)
            if info.get("config") is not None:
                self.config = info["config"]
            self._apply_suspects_locked(
                set(info.get("suspect", ()) or ()), set(new_index))
        self._last_poll = time.monotonic()

    # ------------------------------------------------- circuit breakers

    def _apply_suspects_locked(self, new_suspect: set, live: set) -> None:
        """Controller liveness verdicts are authoritative: a replica
        whose ongoing polls time out repeatedly is force-opened (sticky
        while suspect); when the controller's poll succeeds again the
        breaker drops to half-open so the next request is a probation
        probe, not a stampede."""
        new_suspect &= live
        now = time.monotonic()
        for aid in new_suspect - self.suspect:
            br = self._breaker_locked(aid)
            if br.state != "open":
                self._set_state_locked(aid, br, "open")
                br.opened_at = now
        for aid in self.suspect - new_suspect:
            br = self.breakers.get(aid)
            if br is not None and br.state == "open":
                self._set_state_locked(aid, br, "half_open")
                br.last_probe_at = 0.0
        self.suspect = new_suspect
        for aid in list(self.breakers):
            if aid not in live:
                del self.breakers[aid]

    def _breaker_locked(self, aid) -> _Breaker:
        br = self.breakers.get(aid)
        if br is None:
            br = _Breaker(self.config["breaker"].window)
            self.breakers[aid] = br
        return br

    def _set_state_locked(self, aid, br: _Breaker, state: str) -> None:
        br.state = state
        _emit("breaker", {"closed": 0, "half_open": 1, "open": 2}[state],
              {"deployment": self.name, "replica": aid.hex()[:12]})

    def _probe_due_locked(self, aid, br: _Breaker, now: float) -> bool:
        """True when an ejected replica has earned its probation probe:
        never while the controller still suspects it, and at most one
        probe per cooldown interval."""
        if aid in self.suspect:
            return False
        cooldown = self.config["breaker"].cooldown_s
        if br.state == "open":
            if now - br.opened_at < cooldown:
                return False
            self._set_state_locked(aid, br, "half_open")
            br.last_probe_at = 0.0
        return now - br.last_probe_at >= cooldown

    def record_outcome(self, replica, ok: bool) -> None:
        """Feed a request outcome (observed wherever results are read:
        handle.call(), the ingresses) into the replica's breaker and
        earn retry-budget tokens."""
        with self.lock:
            rcfg = self.config.get("retry")
            if rcfg is not None:
                if self.retry_tokens is None:
                    self.retry_tokens = float(rcfg.budget_burst)
                self.retry_tokens = min(float(rcfg.budget_burst),
                                        self.retry_tokens
                                        + rcfg.budget_fraction)
            aid = replica.actor_id
            br = self._breaker_locked(aid)
            if br.state != "closed":
                # Only a HALF-OPEN success closes the breaker: a
                # success landing while still "open" is a stale
                # in-flight request dispatched before the trip, not a
                # probation verdict — closing on it would bypass the
                # cooldown and flap the breaker under concurrent
                # traffic.  Failures always (re-)open.
                if (ok and br.state == "half_open"
                        and aid not in self.suspect):
                    self._set_state_locked(aid, br, "closed")
                    br.outcomes.clear()
                elif not ok:
                    self._set_state_locked(aid, br, "open")
                    br.opened_at = time.monotonic()
                return
            br.outcomes.append(ok)
            if ok:
                return
            bcfg = self.config["breaker"]
            fails = sum(1 for o in br.outcomes if not o)
            if (len(br.outcomes) >= bcfg.min_outcomes
                    and fails / len(br.outcomes) >= bcfg.failure_rate):
                # Ejection cap: rate-driven opens stop once the open
                # share would exceed max_eject_fraction — a failure
                # mode shared by EVERY replica (bad input) then keeps
                # most of the fleet routable (suspect/liveness opens
                # bypass this in _apply_suspects_locked).
                already_open = sum(1 for o in self.breakers.values()
                                   if o.state == "open")
                cap = int(bcfg.max_eject_fraction * len(self.replicas))
                if already_open < cap:
                    self._set_state_locked(aid, br, "open")
                    br.opened_at = time.monotonic()

    def take_retry_token(self) -> bool:
        with self.lock:
            rcfg = self.config.get("retry")
            if rcfg is None:
                return False
            if self.retry_tokens is None:
                self.retry_tokens = float(rcfg.budget_burst)
            if self.retry_tokens >= 1.0:
                self.retry_tokens -= 1.0
                return True
            return False

    def default_timeout(self) -> float | None:
        return self.config.get("request_timeout_s")

    def ensure_listener(self) -> None:
        if self.controller is None or self._listener is not None:
            return
        with self.lock:
            if self._listener is not None:
                return
            self._listener = threading.Thread(
                target=self._listen_loop, daemon=True,
                name=f"serve-listen-{self.name}")
        self._listener.start()

    def _listen_loop(self) -> None:
        # Calls go to the runtime this loop started under, not through
        # the API: after a shutdown they raise instead of auto-initing a
        # new cluster, and the loop stops once the runtime has changed.
        from ant_ray_tpu_torch._private.task_options import TaskOptions  # noqa: PLC0415

        runtime = _runtime()
        while runtime is not None and _runtime() is runtime:
            try:
                ref = runtime.submit_actor_task(
                    self.controller, "listen_for_change",
                    ({self.name: self.version},), {}, TaskOptions())
                changed = runtime.get([ref],
                                      timeout=_LISTEN_TIMEOUT_S + 15)[0]
            except Exception:  # noqa: BLE001 — controller restarting
                if _runtime() is not runtime:
                    return
                time.sleep(0.5)
                continue
            if not changed:
                continue                       # listen timeout: re-arm
            info = changed.get(self.name)
            if info is None:
                return                         # deployment deleted
            self.apply(info)

    def poll_fallback(self) -> None:
        """TTL refresh for the pre-listener window (and as a safety net
        if the push channel wedges)."""
        if self.controller is None:
            return
        if time.monotonic() - self._last_poll < \
                DeploymentHandle._REFRESH_TTL_S:
            return
        self._last_poll = time.monotonic()
        try:
            info = _art().get(
                self.controller.get_handle_info.remote(self.name))
        except Exception:  # noqa: BLE001 — keep the cached set
            return
        if info:
            self.apply(info)


# Controller-side long-poll window; client waits a bit longer.
_LISTEN_TIMEOUT_S = 30.0

# Ongoing-poll liveness: per-replica answer budget, and how many
# consecutive failed polls make a replica SUSPECT (force-opens its
# breaker in every handle).  ~3 × (0.25s loop + 2s budget) ≈ a wedge is
# ejected within ~7s of going dark.
_POLL_TIMEOUT_S = 2.0
_POLL_STRIKE_LIMIT = 3


class DeploymentHandle:
    """Client handle routing calls across a deployment's replicas with
    power-of-two-choices over reported queue depths
    (ref: PowerOfTwoChoicesRequestRouter, serve/_private/router.py:472).

    Replica-set changes are PUSHED: a listener long-polls the
    controller's version channel and rewrites the shared routing state
    the moment a deployment scales (ref: serve/_private/long_poll.py
    LongPollClient) — a scale-up is visible to the very next request,
    not after a TTL.  A slow TTL poll remains as the fallback when the
    listener cannot run."""

    _REFRESH_TTL_S = 30.0           # fallback only — push is primary

    def __init__(self, deployment_name: str, replicas: list,
                 method_name: str = "__call__", stream: bool = False,
                 controller=None, multiplexed_model_id: str = "",
                 _mux_affinity: dict | None = None,
                 _routing: "_RoutingState | None" = None,
                 _info: dict | None = None,
                 trace_ctx: "TraceContext | None" = None):
        self._name = deployment_name
        self._method = method_name
        self._stream = stream
        self._controller = controller
        self._mux_model_id = multiplexed_model_id
        # Bound trace context (serve composition: a handle created
        # inside a traced request and pickled into a downstream
        # deployment joins that trace when no ambient context is set;
        # the sampled flag survives the pickle via __reduce__).
        self._trace_ctx = trace_ctx
        # model id -> replica; SHARED with handles derived via
        # options() so affinity survives per-request option changes
        self._mux_affinity = ({} if _mux_affinity is None
                              else _mux_affinity)
        self._rr = itertools.count()
        # Routing state (replica set + queue snapshot) is shared across
        # the options()-derived handle family: one listener serves all.
        self._routing = (_routing if _routing is not None
                         else _RoutingState(deployment_name, replicas,
                                            controller))
        if _info is not None and _routing is None:
            # Seed the overload config (deadline default, retry budget,
            # breaker knobs) synchronously from the construction-time
            # get_handle_info payload — the very first call must honor
            # request_timeout_s, not wait for the listener's push.
            self._routing.apply(_info)
        # Arm the push listener NOW, not on first use: a scale-down can
        # kill a replica from this handle's constructor-time list before
        # the first request, and the drain grace assumes every live
        # handle hears about shrinks promptly.
        self._routing.ensure_listener()

    def options(self, method_name: str | None = None,
                stream: bool | None = None,
                multiplexed_model_id: str | None = None
                ) -> "DeploymentHandle":
        """``stream=True``: remote() returns an ObjectRefGenerator whose
        refs arrive as the replica's generator produces them
        (ref: handle.options(stream=True)).  ``multiplexed_model_id``
        routes to the replica that already serves that model."""
        return DeploymentHandle(
            self._name, self._routing.replicas,
            method_name if method_name is not None else self._method,
            self._stream if stream is None else stream,
            self._controller,
            (self._mux_model_id if multiplexed_model_id is None
             else multiplexed_model_id),
            self._mux_affinity,
            self._routing)

    # Internal views over the shared routing state (kept as properties
    # so the routing/mux logic below reads naturally).
    @property
    def _lock(self):
        return self._routing.lock

    @property
    def _replicas(self):
        return self._routing.replicas

    @property
    def _ongoing(self):
        return self._routing.ongoing

    @property
    def _local_extra(self):
        return self._routing.local_extra

    def _maybe_refresh(self):
        if self._routing.version < 0 and self._controller is not None:
            # Never-synced routing state (a handle reconstructed from a
            # pickle — serve composition embeds handles in downstream
            # deployments' args): the overload config must govern the
            # FIRST dispatch, so fetch it synchronously once instead of
            # racing the listener's first push.
            try:
                info = _art().get(
                    self._controller.get_handle_info.remote(self._name),
                    timeout=5)
            except Exception:  # noqa: BLE001 — poll fallback covers it
                pass
            else:
                if info is not None:
                    self._routing.apply(info)
        self._routing.ensure_listener()
        self._routing.poll_fallback()

    def _pick(self, exclude: set | None = None):
        """Two random candidates among breaker-ALLOWED replicas, route
        to the shorter queue (cached depth + dispatches this handle made
        since the last refresh).  An ejected replica due for its
        probation probe is chosen deliberately (exactly one request per
        cooldown) so breakers can close again; if every replica is
        ejected the caller gets a typed BackPressureError instead of a
        request lobbed at a known-bad replica.  Returns the replica
        HANDLE, resolved inside the critical section — the listener
        thread may swap the replica list at any moment, so an index is
        stale the instant the lock drops."""
        with self._lock:
            routing = self._routing
            n = len(self._replicas)
            if n == 0:
                raise RuntimeError(
                    f"deployment {self._name} has no replicas")
            now = time.monotonic()
            candidates = []
            for k in range(n):
                aid = self._replicas[k].actor_id
                if exclude and aid in exclude:
                    continue
                br = routing.breakers.get(aid)
                if br is None or br.state == "closed":
                    candidates.append(k)
                elif routing._probe_due_locked(aid, br, now):
                    # Probation probe: route THIS request to it.
                    br.last_probe_at = now
                    self._local_extra[k] = self._local_extra.get(k, 0) + 1
                    return self._replicas[k]
            if not candidates:
                cooldown = routing.config["breaker"].cooldown_s
                remaining = [max(0.0, cooldown - (now - br.opened_at))
                             for br in routing.breakers.values()
                             if br.state == "open"]
                raise BackPressureError(
                    f"deployment {self._name}: all replicas unavailable "
                    "(circuit open / excluded)",
                    retry_after_s=min(remaining, default=1.0))
            if len(candidates) == 1:
                index = candidates[0]
            else:
                i, j = random.sample(candidates, 2)

                def load(k):
                    depth = (self._ongoing[k]
                             if k < len(self._ongoing) else 0)
                    return depth + self._local_extra.get(k, 0)

                index = i if load(i) <= load(j) else j
            self._local_extra[index] = \
                self._local_extra.get(index, 0) + 1
            return self._replicas[index]

    def _trace_root(self) -> "TraceContext":
        """The request's trace identity at this handle: the ambient
        context (a proxy ingress or an enclosing traced task), the
        handle's pickled binding, or — ``handle.call``/``remote()``
        being an ingress themselves — a freshly minted head-sampled
        root."""
        return (tracing_plane.current() or self._trace_ctx
                or tracing_plane.mint())

    def _request_meta(self, timeout_s: float | None = None,
                      trace: "TraceContext | None" = None) -> dict:
        """Stamp what rides to the replica: the end-to-end deadline (an
        explicit per-call timeout wins, else the deployment's
        ``request_timeout_s`` default pushed by the controller) and the
        trace context.  The trace travels even when UNSAMPLED — a shed
        (429/504) on the replica force-samples an error span and needs
        the request's trace id to hang it off."""
        meta: dict = {}
        timeout = (timeout_s if timeout_s is not None
                   else self._routing.default_timeout())
        # NB: 0 is a real (already-expired) deadline — a gRPC client
        # whose native deadline just hit zero must be shed, not granted
        # unbounded time.
        if timeout is not None:
            meta["deadline_ts"] = time.time() + float(timeout)
        meta["trace"] = (trace if trace is not None
                         else self._trace_root()).to_wire()
        return meta

    def _dispatch(self, replica, args, kwargs, model_id: str,
                  meta: dict | None):
        # Scope the request's trace over the actor submission so the
        # task spec inherits it (the replica-side execution span nests
        # under this request, not under whatever the dispatching thread
        # happened to be doing).
        wire = (meta or {}).get("trace")
        if wire is None:
            if self._stream:
                return replica.handle_request_streaming.remote(
                    self._method, args, kwargs, model_id, meta)
            return replica.handle_request.remote(
                self._method, args, kwargs, model_id, meta)
        with tracing_plane.use(TraceContext.from_wire(wire)):
            if self._stream:
                return replica.handle_request_streaming.remote(
                    self._method, args, kwargs, model_id, meta)
            return replica.handle_request.remote(
                self._method, args, kwargs, model_id, meta)

    def _pick_affine(self, exclude: set | None = None):
        """``_pick`` honoring multiplexed-model affinity.  Affinity is
        by replica IDENTITY: handles refresh their replica lists
        independently, so a stored index could point at a different
        replica after a resize.  The remembered replica is skipped when
        it is retry-excluded or breaker-ejected — the re-pick then
        migrates the affinity (one model reload beats routing into a
        known-bad replica)."""
        model_id = self._mux_model_id
        if not model_id:
            return self._pick(exclude=exclude)
        with self._lock:
            target = self._mux_affinity.get(model_id)
            if target is not None and not (exclude
                                           and target.actor_id in exclude):
                br = self._routing.breakers.get(target.actor_id)
                if br is None or br.state == "closed":
                    for r in self._replicas:
                        if r.actor_id == target.actor_id:
                            return r
        replica = self._pick(exclude=exclude)
        with self._lock:
            self._mux_affinity[model_id] = replica
        return replica

    def remote(self, *args, **kwargs):
        self._maybe_refresh()
        replica = self._pick_affine()
        return self._dispatch(replica, args, kwargs, self._mux_model_id,
                              self._request_meta())

    def call(self, *args, timeout_s: float | None = None, **kwargs):
        """Blocking dispatch with the full resilience contract: the
        deadline bounds the WHOLE request (queueing included), queued
        work past deadline is cancelled via ``art.cancel`` so it never
        executes, outcomes feed the per-replica circuit breakers, and —
        when the deployment opts in via ``retry_config`` (idempotent
        handlers only) — failures re-pick a different replica under the
        token-bucket retry budget.  The ingresses route through here;
        ``remote()`` stays the raw ref-returning path.

        Tracing: ``call`` is an ingress — a root context is minted when
        none is ambient, a ``route:{deployment}`` span covers
        pick + dispatch + reply, and shed outcomes (429/504) are
        force-sampled error spans even on unsampled requests."""
        root = self._trace_root()
        route_ctx = root.child()
        t_wall = time.time()
        t0 = time.perf_counter()
        exc: BaseException | None = None
        try:
            with tracing_plane.use(route_ctx):
                return self._call_impl(route_ctx, timeout_s, args,
                                       kwargs)
        except BaseException as e:
            exc = e
            raise
        finally:
            typed = _typed_cause(exc) if exc is not None else None
            attrs = {"deployment": self._name}
            if typed is not None:
                attrs["shed"] = type(typed).__name__
            tracing_plane.record_span(
                root, f"route:{self._name}", ts=t_wall,
                dur_s=time.perf_counter() - t0, attrs=attrs,
                error=exc is not None, span_id=route_ctx.span_id,
                parent_id=root.span_id, service="router")

    def _call_impl(self, route_ctx, timeout_s, args, kwargs):
        art = _art()
        self._maybe_refresh()
        rcfg = self._routing.config.get("retry")
        timeout = (timeout_s if timeout_s is not None
                   else self._routing.default_timeout())
        # Wall clock BY DESIGN: this becomes the request's cross-process
        # deadline_ts wire field, the one clock every host shares.
        deadline_ts = (time.time() + float(timeout)
                       if timeout is not None else None)
        attempts = rcfg.max_attempts if rcfg is not None else 1
        exclude: set = set()
        last_exc: Exception | None = None
        for attempt in range(max(1, attempts)):
            if deadline_ts is not None and time.time() >= deadline_ts:
                raise last_exc or DeadlineExceededError(
                    f"deadline expired before dispatch to {self._name}")
            try:
                replica = self._pick_affine(exclude=exclude)
            except BackPressureError:
                if last_exc is not None:
                    # A retry that excluded every replica (e.g. a
                    # single-replica deployment): surface the REAL
                    # failure, not a misleading retriable 429.
                    raise last_exc from None
                raise
            meta: dict = {"trace": route_ctx.to_wire()}
            if deadline_ts is not None:
                meta["deadline_ts"] = deadline_ts
            ref = self._dispatch(replica, args, kwargs,
                                 self._mux_model_id, meta)
            try:
                remaining = (None if deadline_ts is None
                             else max(0.0, deadline_ts - time.time()))
                result = art.get(ref, timeout=remaining)
            except GetTimeoutError:
                # The deadline fired while the call was queued or
                # running.  Cancel reaps it if it has not started —
                # expired work is shed, not executed; running work
                # cannot be preempted and is left to finish into the
                # void.  Not a breaker outcome: slowness under load is
                # the admission gate's problem, ejection is for
                # *broken* replicas (errors / liveness strikes).
                try:
                    art.cancel(ref)
                except Exception:  # noqa: BLE001 — best-effort reap
                    pass
                raise DeadlineExceededError(
                    f"{self._name}: no reply within {timeout}s "
                    f"(attempt {attempt + 1})") from None
            except Exception as e:  # noqa: BLE001 — classified below
                typed = _typed_cause(e)
                if isinstance(typed, DeadlineExceededError):
                    raise typed  # replica shed expired work; no retry
                if isinstance(typed, BackPressureError):
                    last_exc = typed
                    retryable = (rcfg is not None
                                 and rcfg.retry_backpressure)
                else:
                    _record_result(self._routing, replica, e)
                    last_exc = e
                    retryable = rcfg is not None
                if not retryable or attempt >= attempts - 1:
                    raise last_exc
                if not self._routing.take_retry_token():
                    _emit("retry_exhausted", 1,
                          {"deployment": self._name})
                    raise last_exc
                exclude.add(replica.actor_id)
                _emit("retries", 1, {"deployment": self._name})
                continue
            self._routing.record_outcome(replica, True)
            return result
        raise last_exc  # pragma: no cover — loop always returns/raises

    def with_trace_context(self, ctx: "TraceContext | None"
                           ) -> "DeploymentHandle":
        """A handle whose dispatches join ``ctx`` when no ambient trace
        context is set — the explicit binding for serve composition
        (pass the bound handle in a downstream deployment's args; the
        sampled flag survives the pickle)."""
        return DeploymentHandle(
            self._name, self._routing.replicas, self._method,
            self._stream, self._controller, self._mux_model_id,
            self._mux_affinity, self._routing, trace_ctx=ctx)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._name, self._replicas, self._method, self._stream,
                 self._controller, self._mux_model_id,
                 None, None, None, self._trace_ctx))


# ---------------------------------------------------------------- actors

class Replica:
    """One replica actor wrapping the user's callable/class
    (ref: serve/_private/replica.py:1124).

    ADMISSION CONTROL lives here, replica-side, where the bound is
    enforceable no matter how many handles/proxies dispatch (client-side
    counting can always over-admit under fan-in): at most
    ``max_ongoing_requests`` invocations execute user code concurrently,
    at most ``max_queued_requests`` more may wait for a slot, and the
    rest fast-fail with a typed :class:`BackPressureError` (429 /
    RESOURCE_EXHAUSTED at the ingresses).  Queued work whose stamped
    end-to-end deadline expires while waiting is SHED — never executed
    (ref: DeploymentConfig.max_ongoing_requests/max_queued_requests)."""

    def __init__(self, cls_or_fn, args, kwargs, limits: dict | None = None):
        if isinstance(cls_or_fn, type):
            self._instance = cls_or_fn(*args, **kwargs)
        else:
            self._instance = cls_or_fn  # plain function deployment
        limits = limits or {}
        self._deployment = limits.get("deployment", "")
        self._max_ongoing = limits.get("max_ongoing_requests")
        self._max_queued = int(limits.get("max_queued_requests", 0) or 0)
        # One condition guards _running (user code executing now) and
        # the FIFO wait line (_waiters: one opaque token per queued
        # request, head owns the next freed slot).
        self._admit_cv = threading.Condition()
        self._running = 0
        self._waiters: collections.deque = collections.deque()
        # EWMA of service seconds — the basis for the Retry-After hint
        # (how long until a slot plausibly frees).
        self._ewma_service_s = 0.05

    # ------------------------------------------------------ admission

    def _retry_after_locked(self) -> float:
        """Server-side hint: roughly one service time per request that
        must drain before new capacity appears."""
        waiting = len(self._waiters) + 1
        slots = max(1, self._max_ongoing or 1)
        return max(0.05, self._ewma_service_s * waiting / slots)

    def _admit(self, deadline_ts: float | None):
        """Block until a user-code slot frees (bounded FIFO queue), or
        shed: BackPressureError when the queue is full,
        DeadlineExceededError when the deadline expires while queued.
        No-op (count only) when the deployment sets no bound (legacy
        behavior)."""
        with self._admit_cv:
            if self._max_ongoing is None:
                self._running += 1
                return
            # Barge-free FIFO: with waiters present a fresh arrival
            # lines up behind them even if a slot just freed (the head
            # waiter owns it) — else a steady arrival stream starves a
            # queued request into a deadline shed FIFO would have
            # served.  The head check in the wait loop enforces it: a
            # non-head waiter that wakes first goes back to sleep.
            if self._running < self._max_ongoing and not self._waiters:
                self._running += 1
                return
            if len(self._waiters) >= self._max_queued:
                _emit("shed", 1, {"deployment": self._deployment,
                                  "reason": "backpressure"})
                raise BackPressureError(
                    f"replica at capacity ({self._running} running, "
                    f"{len(self._waiters)} queued)",
                    retry_after_s=self._retry_after_locked())
            token = object()
            self._waiters.append(token)
            try:
                while (self._running >= self._max_ongoing
                       or self._waiters[0] is not token):
                    remaining = (None if deadline_ts is None
                                 else deadline_ts - time.time())
                    if remaining is not None and remaining <= 0:
                        _emit("shed", 1,
                              {"deployment": self._deployment,
                               "reason": "deadline"})
                        raise DeadlineExceededError(
                            "deadline expired while queued for a "
                            "replica slot — request shed, not "
                            "executed")
                    self._admit_cv.wait(remaining)
            except BaseException:
                self._waiters.remove(token)
                # This waiter may have consumed a wakeup meant for a
                # sibling (and its exit may promote a new head): pass
                # it on or a queued request sleeps forever beside a
                # free slot.
                self._admit_cv.notify_all()
                raise
            self._waiters.remove(token)
            self._running += 1

    def _release(self, started: float) -> None:
        with self._admit_cv:
            self._running -= 1
            elapsed = time.monotonic() - started
            self._ewma_service_s += 0.2 * (elapsed - self._ewma_service_s)
            # notify_all, not notify: only the FIFO head may take the
            # slot, and a single notify could land on a non-head waiter
            # (which re-sleeps), stranding the head.  Wait lines are
            # bounded by max_queued, so the herd is small.
            self._admit_cv.notify_all()

    def _check_deadline(self, deadline_ts: float | None) -> None:
        if deadline_ts is not None and time.time() >= deadline_ts:
            _emit("shed", 1, {"deployment": self._deployment,
                              "reason": "deadline"})
            raise DeadlineExceededError(
                "request deadline expired before execution — shed, "
                "not executed")

    # ------------------------------------------------------ dispatch

    def _invoke(self, method_name: str, args, kwargs, model_id: str = "",
                deadline_ts: float | None = None):
        token = _multiplexed_model_id.set(model_id) if model_id else None
        dl_token = _request_deadline.set(deadline_ts)
        try:
            if method_name == "__call__":
                return self._instance(*args, **kwargs)
            return getattr(self._instance, method_name)(*args, **kwargs)
        finally:
            _request_deadline.reset(dl_token)
            if token is not None:
                _multiplexed_model_id.reset(token)

    def _trace_exec_ctx(self, meta: dict | None):
        """(exec_ctx, parent_span_id) for this request, or (None, "").
        Prefers the ambient context (the worker executor set it from
        the task spec on sampled requests — nesting the replica span
        under the execution span); falls back to the meta-carried wire
        context, which travels even UNSAMPLED so shed error spans can
        be force-sampled under the request's trace id."""
        parent = tracing_plane.current()
        if parent is None:
            parent = TraceContext.from_wire((meta or {}).get("trace"))
        if parent is None:
            return None, ""
        return parent.child(), parent.span_id

    def handle_request(self, method_name: str, args, kwargs,
                       model_id: str = "", meta: dict | None = None):
        """One admission sequence for traced and untraced requests —
        the trace hooks are no-ops without a context; with one the span
        covers admission (queue stage) + execution and sheds record
        force-sampled error spans."""
        deadline_ts = (meta or {}).get("deadline_ts")
        exec_ctx, parent_span = self._trace_exec_ctx(meta)
        t_wall = time.time()
        t0 = time.perf_counter()
        token = (tracing_plane.set_current(exec_ctx)
                 if exec_ctx is not None else None)
        err: BaseException | None = None
        t_admit = t0
        try:
            try:
                self._check_deadline(deadline_ts)  # shed before queueing
                self._admit(deadline_ts)           # bounded queue / shed
            finally:
                # Stamped even when _admit sheds: a request that waited
                # 2s in the queue before its 429/504 attributes those
                # 2s to the queue stage, not to execute.
                t_admit = time.perf_counter()
            started = time.monotonic()
            try:
                self._check_deadline(deadline_ts)  # shed before execution
                return self._invoke(method_name, args, kwargs, model_id,
                                    deadline_ts)
            finally:
                self._release(started)
        except BaseException as e:
            err = e
            raise
        finally:
            if token is not None:
                tracing_plane.reset(token)
            if exec_ctx is not None:
                self._record_request_span(
                    exec_ctx, parent_span, method_name, t_wall, t0,
                    t_admit, err)

    def _record_request_span(self, exec_ctx, parent_span, method_name,
                             t_wall, t0, t_admit, err) -> None:
        now = time.perf_counter()
        attrs = {"deployment": self._deployment, "method": method_name}
        if err is not None and isinstance(
                err, (BackPressureError, DeadlineExceededError)):
            attrs["shed"] = type(err).__name__
        stages = {"queue": max(0.0, t_admit - t0),
                  "execute": max(0.0, now - max(t_admit, t0))}
        tracing_plane.record_span(
            exec_ctx, f"replica:{self._deployment or 'replica'}",
            ts=t_wall, dur_s=now - t0, stages=stages, attrs=attrs,
            error=err is not None, span_id=exec_ctx.span_id,
            parent_id=parent_span, service="replica")

    def handle_request_streaming(self, method_name: str, args, kwargs,
                                 model_id: str = "",
                                 meta: dict | None = None):
        """Streaming dispatch: the target method must return a generator;
        its items flow back as a streaming actor call.  The ongoing
        count covers the WHOLE stream — a replica mid-generation must
        look busy to routing and must not be an autoscaler down-scale
        victim."""
        deadline_ts = (meta or {}).get("deadline_ts")
        exec_ctx, parent_span = self._trace_exec_ctx(meta)
        t_wall = time.time()
        t0 = time.perf_counter()
        t_admit = t0
        err: BaseException | None = None
        trace_token = (tracing_plane.set_current(exec_ctx)
                       if exec_ctx is not None else None)
        try:
            try:
                self._check_deadline(deadline_ts)
                self._admit(deadline_ts)
            finally:
                t_admit = time.perf_counter()  # queue stage incl. sheds
            started = time.monotonic()
            # Tokens span the WHOLE stream: the generator body runs
            # during iteration, long after _invoke (which only creates
            # it, with the same context) has returned.
            token = (_multiplexed_model_id.set(model_id) if model_id
                     else None)
            dl_token = _request_deadline.set(deadline_ts)
            try:
                yield from self._invoke(method_name, args, kwargs,
                                        model_id, deadline_ts)
            finally:
                _request_deadline.reset(dl_token)
                if token is not None:
                    _multiplexed_model_id.reset(token)
                self._release(started)
        except BaseException as e:
            err = e
            raise
        finally:
            if trace_token is not None:
                tracing_plane.reset(trace_token)
            if exec_ctx is not None:
                # GeneratorExit (consumer abandoned the stream) is a
                # normal ending, not a replica failure.
                failed = err is not None and not isinstance(
                    err, GeneratorExit)
                self._record_request_span(
                    exec_ctx, parent_span, method_name, t_wall, t0,
                    t_admit, err if failed else None)

    def ongoing(self) -> int:
        """Queue-depth metric feeding autoscaling and po2 routing
        (ref: replica queue-length metrics, autoscaling_state.py):
        executing AND queued — an admitted-but-waiting request is load
        the router must see."""
        return self._running + len(self._waiters)

    def load_signals(self) -> dict:
        """Deployment-defined load gauges for signal-targeted
        autoscaling (`AutoscalingConfig.target_signal`): delegates to
        the wrapped instance's ``load_signals()`` if it has one (the
        LLM engine loop publishes tokens/s, queue depth, and resident
        sessions this way)."""
        fn = getattr(self._instance, "load_signals", None)
        if callable(fn):
            try:
                return dict(fn())
            except Exception:  # noqa: BLE001 — a gauge blip isn't fatal
                return {}
        return {}

    def health(self):
        return "ok"


# Streaming marker on the dispatch method (equivalent of decorating with
# @art.method(num_returns="streaming") without importing art at module
# import time).
Replica.handle_request_streaming.__art_num_returns__ = "streaming"


class ServeController:
    """Reconciles deployments → replica actors; a background thread polls
    replica queue depths and drives queue-based autoscaling
    (ref: serve/_private/controller.py:105 + autoscaling_state.py)."""

    def __init__(self):
        self._deployments: dict[str, dict] = {}
        self._proxy = None
        self._lock = threading.Lock()
        # Long-poll version channel: listeners block here until some
        # deployment's version advances (ref: serve/_private/
        # long_poll.py LongPollHost snapshot ids).
        self._version_cv = threading.Condition(self._lock)
        self._stopping = False
        self._scaler = threading.Thread(
            target=self._scale_loop, daemon=True, name="serve-scaler")
        self._scaler.start()
        # Drain plane: replicas on a DRAINING node (announced TPU
        # preemption / maintenance event) are replaced proactively —
        # a new replica passes readiness elsewhere, then the doomed one
        # drains its in-flight work via _drain_then_kill.
        self._drainer = threading.Thread(
            target=self._node_drain_loop, daemon=True,
            name="serve-drain-watch")
        self._drainer.start()

    def _bump_version_locked(self, entry: dict) -> None:
        entry["version"] = entry.get("version", 0) + 1
        self._version_cv.notify_all()

    def listen_for_change(self, keys: dict, timeout_s: float = 30.0):
        """Block until any listed deployment's version passes the
        caller's, then return the changed routing infos; {} on timeout
        (the caller re-arms).  A deleted deployment reports None."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                changed: dict = {}
                for name, known in keys.items():
                    entry = self._deployments.get(name)
                    if entry is None:
                        changed[name] = None
                    elif entry.get("version", 0) > known:
                        changed[name] = {
                            "version": entry["version"],
                            "replicas": list(entry["replicas"]),
                            "ongoing": list(entry["ongoing"]),
                            "config":
                                entry["deployment"].overload_config(),
                            "suspect": set(entry.get("suspect", ()))}
                if changed:
                    return changed
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._version_cv.wait(remaining)

    def _make_replicas(self, deployment: Deployment, args, kwargs, n: int,
                       timeout: float | None = None):
        art = _art()
        # Default is SERIALIZED user code (max_concurrency=1, matching
        # plain actors).  Autoscaling needs overlapping requests for a
        # meaningful queue-depth signal, so it defaults to 8 — like the
        # reference's max_ongoing_requests > 1, replica code must then
        # be thread-safe.  @serve.batch also requires an explicit
        # max_concurrency.
        default_conc = 8 if deployment.autoscaling_config is not None else 1
        if deployment.max_ongoing_requests is not None:
            # Admission control moves the execution bound into the
            # replica's gate (max_ongoing slots + max_queued waiters),
            # so the actor's thread pool must be WIDER than the gate:
            # excess calls need a thread to reach the gate and
            # fast-fail, and ongoing()/health() polls must not starve
            # behind queued work (+8 headroom for both).
            default_conc = (deployment.max_ongoing_requests
                            + max(deployment.max_queued_requests, 0) + 8)
        replica_cls = art.remote(Replica).options(
            **{"num_cpus": deployment.ray_actor_options.get("num_cpus", 0),
               "max_concurrency": deployment.ray_actor_options.get(
                   "max_concurrency", default_conc)})
        limits = {"deployment": deployment.name,
                  "max_ongoing_requests": deployment.max_ongoing_requests,
                  "max_queued_requests": deployment.max_queued_requests}
        replicas = [
            replica_cls.remote(deployment.cls_or_fn, args, kwargs, limits)
            for _ in range(n)
        ]
        try:
            # Readiness gate.  ``timeout`` lets retry-loop callers (the
            # drain watcher) bound an unplaceable replica instead of
            # wedging their thread forever.
            art.get([r.health.remote() for r in replicas],
                    timeout=timeout)
        except BaseException:
            # Never leak half-placed replicas: handles aren't reaped on
            # GC, and a retrying caller would compound the leak — worse,
            # the leaked actors hold exactly the capacity the retry
            # needs, guaranteeing it never succeeds.
            for r in replicas:
                try:
                    art.kill(r)
                except Exception:  # noqa: BLE001
                    pass
            raise
        return replicas

    def deploy(self, deployment: Deployment, args, kwargs) -> dict:
        if self._deployments.get(deployment.name) is not None:
            return self._rolling_redeploy(deployment, args, kwargs)
        return self._fresh_deploy(deployment, args, kwargs)

    def _fresh_deploy(self, deployment: Deployment, args, kwargs) -> dict:
        n = deployment.num_replicas
        if deployment.autoscaling_config is not None:
            n = deployment.autoscaling_config.min_replicas
        replicas = self._make_replicas(deployment, args, kwargs, n)
        with self._lock:
            entry = {
                "deployment": deployment,
                "args": args,
                "kwargs": kwargs,
                "replicas": replicas,
                "route_prefix": deployment.route_prefix,
                "ongoing": [0] * len(replicas),
                "low_streak": 0,
                "version": 0,
                # Per-replica consecutive ongoing-poll failures; at
                # _POLL_STRIKE_LIMIT the replica is marked suspect and
                # every handle's breaker force-opens against it.
                "strikes": {},
                "suspect": set(),
            }
            self._deployments[deployment.name] = entry
            self._bump_version_locked(entry)
        return {"name": deployment.name}

    def _rolling_redeploy(self, deployment: Deployment, args,
                          kwargs) -> dict:
        """Replace an existing deployment's replicas version-by-version
        with at most ``rolling_max_surge`` extra replicas alive at a
        time (ref: deployment_state.py:2597 rolling updates).  Each new
        replica passes its readiness gate BEFORE a predecessor starts
        draining, so the serving count never dips below target and no
        request is dropped: handles learn each swap via the long-poll
        version push while the replaced replica drains in-flight work
        on the old code before dying."""
        art = _art()
        name = deployment.name
        with self._lock:
            entry = self._deployments.get(name)
            raced_delete = entry is None
            if not raced_delete:
                entry["deployment"] = deployment
                entry["args"] = args
                entry["kwargs"] = kwargs
                entry["route_prefix"] = deployment.route_prefix
                remaining = collections.deque(entry["replicas"])
        if raced_delete:
            # The deployment vanished between deploy()'s existence check
            # and here: the caller asked for this app to be RUNNING, so
            # deploy fresh rather than returning success with nothing
            # deployed.
            return self._fresh_deploy(deployment, args, kwargs)
        surge = max(1, deployment.rolling_max_surge)
        while remaining:
            doomed = [remaining.popleft()
                      for _ in range(min(surge, len(remaining)))]
            fresh = self._make_replicas(deployment, args, kwargs,
                                        len(doomed))
            swapped = []
            with self._lock:
                entry = self._deployments.get(name)
                if entry is None:          # deleted mid-roll
                    for r in fresh:
                        try:
                            art.kill(r)
                        except Exception:  # noqa: BLE001
                            pass
                    return {"name": name}
                for old_r, new_r in zip(doomed, fresh):
                    try:
                        idx = entry["replicas"].index(old_r)
                    except ValueError:     # autoscaler removed it mid-roll
                        entry["replicas"].append(new_r)
                        entry["ongoing"].append(0)
                        continue
                    entry["replicas"][idx] = new_r
                    entry["ongoing"][idx] = 0
                    swapped.append(old_r)
                self._bump_version_locked(entry)
            for replica in swapped:
                threading.Thread(target=self._drain_then_kill,
                                 args=(replica,), daemon=True).start()
        # Converge to the new target size (autoscaling keeps its current
        # count clamped to the new bounds; fixed deployments resize).
        with self._lock:
            entry = self._deployments.get(name)
            current = len(entry["replicas"]) if entry else 0
        if entry is not None:
            cfg = deployment.autoscaling_config
            target = (max(cfg.min_replicas,
                          min(current, cfg.max_replicas)) if cfg
                      else deployment.num_replicas)
            if target > current:
                self._scale_up(name, target - current)
            elif target < current:
                self._scale_down(name, current - target)
        return {"name": name}

    def get_handle_info(self, name: str):
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None:
                return None
            return {"replicas": list(entry["replicas"]),
                    "ongoing": list(entry["ongoing"]),
                    "version": entry.get("version", 0),
                    "config": entry["deployment"].overload_config(),
                    "suspect": set(entry.get("suspect", ()))}

    # ------------------------------------------------------ autoscaling

    def _poll_ongoing_all(self, entries: list) -> dict:
        """Issue EVERY deployment's per-replica ``ongoing()`` polls up
        front and bound them with ONE combined wait: a wedged replica
        costs _POLL_TIMEOUT_S once per loop iteration, not once per
        deployment, so strike cadence (and healthy deployments' queue
        snapshots) never degrade with deployment count."""
        art = _art()
        polls = [(name, replicas,
                  [r.ongoing.remote() for r in replicas])
                 for name, replicas in entries]
        all_refs = [ref for _, _, refs in polls for ref in refs]
        if not all_refs:
            return {}
        try:
            art.wait(all_refs, num_returns=len(all_refs),
                     timeout=_POLL_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — control plane blip
            return {}
        out = {}
        for name, replicas, refs in polls:
            counts = self._collect_ongoing(name, replicas, refs)
            if counts is not None:
                out[name] = counts
        return out

    def _collect_ongoing(self, name: str, replicas: list,
                         refs: list) -> "list | None":
        """Per-replica queue-depth poll with STRIKE accounting.  The old
        loop did one batched ``art.get`` and swallowed every exception —
        a single wedged replica froze the whole deployment's queue
        snapshot at its last value, and po2 kept routing to the wedge
        forever.  Now each replica answers (or fails) individually:
        consecutive failures count strikes, and at _POLL_STRIKE_LIMIT
        the replica is marked SUSPECT — pushed to every handle, whose
        breaker force-opens against it until a later poll succeeds."""
        art = _art()
        counts: list = [None] * len(replicas)
        failed: list = []
        for i, (replica, ref) in enumerate(zip(replicas, refs)):
            try:
                counts[i] = int(art.get(ref, timeout=0))
            except Exception:  # noqa: BLE001 — timeout, died, wedged
                failed.append(replica.actor_id)
        suspect_changed = False
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None or entry["replicas"] != replicas:
                return None
            strikes = entry["strikes"]
            suspect = entry["suspect"]
            live = {r.actor_id for r in replicas}
            for aid in list(strikes):
                if aid not in live:
                    strikes.pop(aid)
            suspect_stale = suspect - live
            for i, replica in enumerate(replicas):
                aid = replica.actor_id
                if counts[i] is None:
                    strikes[aid] = strikes.get(aid, 0) + 1
                    if (strikes[aid] >= _POLL_STRIKE_LIMIT
                            and aid not in suspect):
                        suspect.add(aid)
                        suspect_changed = True
                    # Keep the last known depth for the snapshot; the
                    # breaker (not a stale low count) removes a suspect
                    # replica from routing.
                    counts[i] = (entry["ongoing"][i]
                                 if i < len(entry["ongoing"]) else 0)
                else:
                    strikes.pop(aid, None)
                    if aid in suspect:
                        suspect.discard(aid)
                        suspect_changed = True
            if suspect_stale:
                suspect -= suspect_stale
                suspect_changed = True
            entry["ongoing"] = counts
            if suspect_changed:
                # Suspect verdicts ride the same long-poll push as
                # replica-set changes: every handle hears within one
                # listen round trip.
                self._bump_version_locked(entry)
            n_suspect = len(suspect)
        _emit("queue_depth", sum(counts), {"deployment": name})
        _emit("suspect", n_suspect, {"deployment": name})
        return counts

    def _poll_signal_total(self, replicas: list,
                           signal: str) -> "float | None":
        """Sum one named load signal across a deployment's replicas
        (signal-targeted autoscaling).  A replica that fails to answer
        contributes 0; None only when EVERY poll failed (no basis for a
        decision — the ongoing-based desired stands alone)."""
        art = _art()
        refs = [r.load_signals.remote() for r in replicas]
        try:
            art.wait(refs, num_returns=len(refs),
                     timeout=_POLL_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — control plane blip
            return None
        total, answered = 0.0, 0
        for ref in refs:
            try:
                signals = art.get(ref, timeout=0)
                answered += 1
                total += float(signals.get(signal, 0.0))
            except Exception:  # noqa: BLE001 — wedged replica
                continue
        return total if answered else None

    def _scale_loop(self):
        while not self._stopping:
            time.sleep(0.25)
            if self._stopping:
                return
            with self._lock:
                snapshot = [(name, list(entry["replicas"]),
                             entry["deployment"].autoscaling_config)
                            for name, entry in self._deployments.items()]
            polled = self._poll_ongoing_all(
                [(name, replicas) for name, replicas, _ in snapshot])
            for name, replicas, cfg in snapshot:
                counts = polled.get(name)
                if counts is None:
                    continue
                if cfg is None:
                    continue
                with self._lock:
                    entry = self._deployments.get(name)
                    if entry is None:
                        continue
                    # Queue depths refresh every poll; scaling DECISIONS
                    # honour the config's cadence.
                    last = entry.get("last_decision", 0.0)
                    if time.monotonic() - last < cfg.interval_s:
                        continue
                    entry["last_decision"] = time.monotonic()
                desired = math.ceil(
                    sum(counts) / max(cfg.target_ongoing_requests, 1e-9))
                if cfg.target_signal:
                    total = self._poll_signal_total(
                        replicas, cfg.target_signal)
                    if total is not None:
                        _emit(cfg.target_signal, total,
                              {"deployment": name})
                        desired = max(desired, math.ceil(
                            total / max(cfg.target_value, 1e-9)))
                desired = max(cfg.min_replicas,
                              min(cfg.max_replicas, desired))
                if desired > len(replicas):
                    self._scale_up(name, desired - len(replicas))
                elif desired < len(replicas):
                    with self._lock:
                        entry = self._deployments.get(name)
                        if entry is None:
                            continue
                        entry["low_streak"] += 1
                        trigger = entry["low_streak"] >= \
                            cfg.downscale_patience
                    if trigger:
                        self._scale_down(name, len(replicas) - desired)
                else:
                    with self._lock:
                        entry = self._deployments.get(name)
                        if entry is not None:
                            entry["low_streak"] = 0

    def _scale_up(self, name: str, count: int):
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None:
                return
            deployment, args, kwargs = (entry["deployment"],
                                        entry["args"], entry["kwargs"])
        try:
            new = self._make_replicas(deployment, args, kwargs, count)
        except Exception:  # noqa: BLE001 — cluster may lack resources
            return
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None:
                return
            entry["replicas"] = entry["replicas"] + new
            entry["ongoing"] = entry["ongoing"] + [0] * len(new)
            entry["low_streak"] = 0
            self._bump_version_locked(entry)

    def _scale_down(self, name: str, count: int):
        doomed = []
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None:
                return
            # Prefer idle replicas, scanning from the tail.
            for index in reversed(range(len(entry["replicas"]))):
                if len(doomed) == count:
                    break
                if entry["ongoing"][index] == 0:
                    doomed.append(entry["replicas"].pop(index))
                    entry["ongoing"].pop(index)
            entry["low_streak"] = 0
            if doomed:
                self._bump_version_locked(entry)
        for replica in doomed:
            # Drain before killing: client handles cache the replica set
            # for up to the refresh TTL, so an immediate kill would turn
            # in-flight/imminent requests into ActorDiedErrors.
            threading.Thread(target=self._drain_then_kill,
                             args=(replica,), daemon=True).start()

    # -------------------------------------------------- node drain plane

    def _node_drain_loop(self):
        """Watch for DRAINING nodes (announced preemption/maintenance)
        and migrate their replicas: spin up replacements — the
        scheduler already skips draining nodes — and hand the doomed
        replicas to the existing ``_drain_then_kill`` machinery so
        in-flight requests finish before the node dies."""
        art = _art()
        while not self._stopping:
            time.sleep(1.0)
            if self._stopping:
                return
            try:
                draining = {n["NodeID"] for n in art.nodes()
                            if n["Alive"] and n.get("Draining")}
                if not draining:
                    continue
                from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415

                on_node = {rec["actor_id"]: rec.get("node_id")
                           for rec in global_worker.runtime._gcs.call(
                               "ListActors", retries=3)
                           if rec.get("state") != "DEAD"}
            except Exception:  # noqa: BLE001 — control plane blip
                continue
            with self._lock:
                names = list(self._deployments)
            for name in names:
                try:
                    self._migrate_off_draining(name, draining, on_node)
                except Exception:  # noqa: BLE001 — retried next tick
                    pass

    def _migrate_off_draining(self, name: str, draining: set,
                              on_node: dict) -> None:
        art = _art()
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None:
                return
            doomed = [r for r in entry["replicas"]
                      if on_node.get(r.actor_id.hex()) in draining]
            deployment, args, kwargs = (entry["deployment"],
                                        entry["args"], entry["kwargs"])
        if not doomed:
            return
        # Replacements pass their readiness gate BEFORE any doomed
        # replica starts draining — the serving count never dips (the
        # same no-dip invariant as _rolling_redeploy).
        fresh = self._make_replicas(deployment, args, kwargs, len(doomed),
                                    timeout=60.0)
        swapped = []
        with self._lock:
            entry = self._deployments.get(name)
            if entry is None:              # deleted mid-migration
                for r in fresh:
                    try:
                        art.kill(r)
                    except Exception:  # noqa: BLE001
                        pass
                return
            for old_r, new_r in zip(doomed, fresh):
                try:
                    idx = entry["replicas"].index(old_r)
                except ValueError:   # autoscaler removed it meanwhile
                    entry["replicas"].append(new_r)
                    entry["ongoing"].append(0)
                    continue
                entry["replicas"][idx] = new_r
                entry["ongoing"][idx] = 0
                swapped.append(old_r)
            self._bump_version_locked(entry)
        for replica in swapped:
            threading.Thread(target=self._drain_then_kill,
                             args=(replica,), daemon=True).start()

    def _drain_then_kill(self, replica):
        art = _art()
        # Handles learn about the shrink via the long-poll push within
        # one round trip; a short grace covers requests already routed
        # and listeners between poll windows.
        time.sleep(2.0)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                if art.get(replica.ongoing.remote(), timeout=5) == 0:
                    break
            except Exception:  # noqa: BLE001 — already gone
                break
            time.sleep(0.5)
        try:
            art.kill(replica)
        except Exception:  # noqa: BLE001
            pass
        _expire_replica_series(replica)

    @staticmethod
    def _expire_deployment_series(name: str) -> None:
        """Drop a removed deployment's ``art_serve_*`` series from the
        GCS metrics table (queue depth, shed counters, suspect gauges
        would otherwise report a deleted deployment forever)."""
        try:
            from ant_ray_tpu_torch.api import global_worker  # noqa: PLC0415

            rt = global_worker.runtime
            rt._send_oneway(rt.gcs_address, "MetricsExpire",
                            {"match_tags": {"deployment": name},
                             "name_prefix": "art_serve_"})
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    def list_deployments(self):
        return {
            name: {
                "num_replicas": len(e["replicas"]),
                "route_prefix": e["route_prefix"],
            }
            for name, e in self._deployments.items()
        }

    def routes(self):
        return {
            e["route_prefix"]: name
            for name, e in self._deployments.items()
            if e["route_prefix"]
        }

    def start_grpc_proxy(self, port: int) -> int:
        art = _art()
        if getattr(self, "_grpc_proxy", None) is None:
            proxy_cls = art.remote(GrpcProxy).options(
                max_concurrency=32, num_cpus=0)
            controller = art.get_actor(CONTROLLER_NAME,
                                       namespace="_serve")
            self._grpc_proxy = proxy_cls.remote(controller)
        return art.get(self._grpc_proxy.start.remote(port))

    def start_http_proxy(self, port: int) -> int:
        art = _art()
        if self._proxy is None:
            proxy_cls = art.remote(HttpProxy).options(
                max_concurrency=32, num_cpus=0)
            controller = art.get_actor(CONTROLLER_NAME,
                                       namespace="_serve")
            self._proxy = proxy_cls.remote(controller)
        return art.get(self._proxy.start.remote(port))

    def shutdown_all(self):
        art = _art()
        # Stop the background scaler/drain watchers first: a watcher
        # migrating replicas mid-shutdown would resurrect actors the
        # loop below is killing.
        self._stopping = True
        # Snapshot + clear UNDER the lock: an in-flight drain migration
        # swaps its fresh replicas into the entry under this same lock,
        # so they land either in the snapshot (killed below) or after
        # the clear (its deleted-entry branch kills them) — never in a
        # leaked gap between an unlocked kill loop and the clear.
        with self._lock:
            doomed = [r for entry in self._deployments.values()
                      for r in entry["replicas"]]
            names = list(self._deployments)
            self._deployments.clear()
            # Wake parked listeners: their deployments now read as
            # deleted, so listener threads exit instead of waiting out
            # the poll window against a dead controller.
            self._version_cv.notify_all()
        for r in doomed:
            try:
                art.kill(r)
            except Exception:  # noqa: BLE001
                pass
            _expire_replica_series(r)
        for name in names:
            self._expire_deployment_series(name)
        for proxy in (self._proxy, getattr(self, "_grpc_proxy", None)):
            if proxy is not None:
                try:
                    art.kill(proxy)
                except Exception:  # noqa: BLE001
                    pass
        self._deployments.clear()
        return True


class HttpProxy:
    """aiohttp ingress routing requests to deployments by route prefix
    (ref: serve/_private/proxy.py)."""

    def __init__(self, controller):
        self._controller = controller
        self._port = None
        self._runner = None
        # name -> DeploymentHandle: handles are long-lived (each owns a
        # routing state kept fresh by its long-poll listener), so the
        # proxy reuses one per deployment instead of re-resolving every
        # request.
        self._handles: dict[str, DeploymentHandle] = {}
        self._handles_lock = threading.Lock()

    def start(self, port: int) -> int:
        import asyncio  # noqa: PLC0415
        import threading  # noqa: PLC0415

        from aiohttp import web  # noqa: PLC0415

        art = _art()
        loop = asyncio.new_event_loop()

        def resolve_handle(path: str) -> "DeploymentHandle | None":
            routes = art.get(self._controller.routes.remote())
            for prefix, name in routes.items():
                if path.startswith(prefix):
                    with self._handles_lock:
                        handle = self._handles.get(name)
                        if handle is None:
                            info = art.get(
                                self._controller.get_handle_info.remote(
                                    name))
                            handle = DeploymentHandle(
                                name, info["replicas"],
                                controller=self._controller,
                                _info=info)
                            self._handles[name] = handle
                    return handle
            return None

        def shed_response(e: BaseException):
            """Typed overload errors → the documented HTTP statuses:
            429 + Retry-After (seconds, integral and >= 1 per RFC 9110)
            for sheds, 504 for deadline misses; None for anything else.
            The ONE place the HTTP shed contract is rendered — unary
            and streaming both route through it."""
            typed = _typed_cause(e)
            if isinstance(typed, BackPressureError):
                return web.json_response(
                    {"error": str(typed),
                     "retry_after_s": typed.retry_after_s},
                    status=429,
                    headers={"Retry-After": str(
                        max(1, math.ceil(typed.retry_after_s)))})
            if isinstance(typed, DeadlineExceededError):
                return web.json_response({"error": str(typed)},
                                         status=504)
            return None

        def dispatch(path: str, body, timeout_s: float | None):
            """Blocking route+call (runs on an executor thread so the
            aiohttp loop stays free; building an unprepared Response
            off-loop is fine).  Routes through ``handle.call`` for the
            full overload contract.

            Tracing ingress: a root context is minted per request and
            scoped over the call; the ``http:{path}`` span records the
            end-to-end server time, force-sampled with ``error:true``
            when the request sheds (429) or misses its deadline (504)."""
            handle = resolve_handle(path)
            if handle is None:
                return web.json_response(
                    {"error": f"no route for {path}"}, status=404)
            if isinstance(body, dict):
                # Deployments that serve several REST endpoints under
                # one prefix (e.g. /v1/completions + /v1/chat/...)
                # dispatch on the request path (ref: proxy passes the
                # scope through to the replica).
                body.setdefault("__route_path__", path)
            ctx = tracing_plane.mint()
            t_wall = time.time()
            t0 = time.perf_counter()
            status = 200
            try:
                with tracing_plane.use(ctx):
                    return web.json_response(
                        {"result": handle.call(body,
                                               timeout_s=timeout_s)})
            except Exception as e:  # noqa: BLE001 — classified below
                resp = shed_response(e)
                if resp is not None:
                    status = resp.status
                    return resp
                status = 500
                return web.json_response({"error": repr(e)}, status=500)
            finally:
                tracing_plane.record_span(
                    ctx, f"http:{path}", ts=t_wall,
                    dur_s=time.perf_counter() - t0,
                    attrs={"path": path, "status": status},
                    error=status >= 400, span_id=ctx.span_id,
                    parent_id="", service="http-proxy")

        def stream_start(path: str, body, timeout_s: float | None):
            """Start a streaming call; returns (handle, replica,
            ObjectRefGenerator) — the replica so the caller can feed
            the stream's outcome into its breaker (convention:
            ``{"stream": true}`` requests dispatch to the deployment's
            ``stream`` method as a generator).  The end-to-end deadline
            (explicit header or deployment default) is stamped on the
            dispatch like the unary path."""
            handle = resolve_handle(path)
            if handle is None:
                return None
            if isinstance(body, dict):
                body.setdefault("__route_path__", path)
            h = handle.options(method_name="stream", stream=True)
            h._maybe_refresh()
            # Streaming ingress mints the trace root too; the span is
            # recorded when dispatch fails (shed) — mid-stream life is
            # covered by the replica-side stream span.
            ctx = tracing_plane.mint()
            t_wall = time.time()
            t0 = time.perf_counter()
            try:
                with tracing_plane.use(ctx):
                    replica = h._pick()  # may raise typed BackPressure
                    gen = h._dispatch(replica, (body,), {},
                                      h._mux_model_id,
                                      h._request_meta(timeout_s,
                                                      trace=ctx))
            except BaseException:
                tracing_plane.record_span(
                    ctx, f"http:{path}", ts=t_wall,
                    dur_s=time.perf_counter() - t0,
                    attrs={"path": path, "stream": True}, error=True,
                    span_id=ctx.span_id, parent_id="",
                    service="http-proxy")
                raise
            return (h, replica, gen)

        def next_chunk(gen):
            try:
                ref = next(gen)
            except StopIteration:
                return None
            return art.get(ref)

        async def handler(request: "web.Request"):
            import json as _json  # noqa: PLC0415

            try:
                body = await request.json() if request.can_read_body else {}
            except Exception:  # noqa: BLE001
                body = {}
            loop_ = asyncio.get_running_loop()
            # Client-requested end-to-end deadline: seconds from now in
            # the X-Request-Timeout-S header (wins over the
            # deployment's request_timeout_s default).  Parsed before
            # the stream branch — streaming requests carry deadlines
            # too.
            timeout_s = None
            raw_timeout = request.headers.get("X-Request-Timeout-S")
            if raw_timeout:
                try:
                    timeout_s = float(raw_timeout)
                except ValueError:
                    return web.json_response(
                        {"error": "X-Request-Timeout-S must be a "
                                  "float (seconds)"}, status=400)
            if isinstance(body, dict) and body.get("stream"):
                # Server-sent events: one `data:` frame per produced
                # chunk, flowing while the model still generates
                # (ref: serve streaming HTTP responses).
                try:
                    started = await loop_.run_in_executor(
                        None, stream_start, request.path, body,
                        timeout_s)
                except Exception as e:  # noqa: BLE001 — classified below
                    # _pick with every replica ejected raises typed
                    # BackPressureError: same shed contract as unary.
                    # NB: explicit None check — an unprepared
                    # web.Response is FALSY (it has __len__), so `or`
                    # would silently discard the 429.
                    resp_t = shed_response(e)
                    if resp_t is not None:
                        return resp_t
                    return web.json_response({"error": repr(e)},
                                             status=500)
                if started is None:
                    return web.json_response(
                        {"error": f"no route for {request.path}"},
                        status=404)
                sh, replica, gen = started
                # Pull the FIRST chunk before sending SSE headers: the
                # replica's admission gate / deadline check fires on
                # generator start, so a shed must surface as the
                # documented typed status — not a 200 that dies
                # mid-stream with no Retry-After.
                try:
                    chunk = await loop_.run_in_executor(
                        None, next_chunk, gen)
                except Exception as e:  # noqa: BLE001 — classified below
                    _record_result(sh._routing, replica, e)
                    resp_t = shed_response(e)
                    if resp_t is not None:
                        return resp_t
                    return web.json_response({"error": repr(e)},
                                             status=500)
                resp = web.StreamResponse(
                    headers={"Content-Type": "text/event-stream",
                             "Cache-Control": "no-cache"})
                await resp.prepare(request)
                while chunk is not None:
                    await resp.write(
                        b"data: " + _json.dumps(chunk).encode() + b"\n\n")
                    try:
                        chunk = await loop_.run_in_executor(
                            None, next_chunk, gen)
                    except Exception as e:  # noqa: BLE001 — mid-stream
                        # Headers already went out: feed the breaker
                        # and end the stream (the client sees the
                        # missing [DONE]).  resp.write failures (client
                        # gone) are NOT replica outcomes and propagate.
                        _record_result(sh._routing, replica, e)
                        await resp.write_eof()
                        return resp
                _record_result(sh._routing, replica)
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
                return resp
            return await loop_.run_in_executor(
                None, dispatch, request.path, body, timeout_s)

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", handler)
        started = threading.Event()
        port_holder = {}

        def _serve():
            asyncio.set_event_loop(loop)
            runner = web.AppRunner(app)
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", port)
            loop.run_until_complete(site.start())
            port_holder["port"] = site._server.sockets[0].getsockname()[1]
            self._runner = runner
            started.set()
            loop.run_forever()

        threading.Thread(target=_serve, daemon=True).start()
        started.wait(10)
        self._port = port_holder.get("port")
        return self._port


class GrpcProxy:
    """gRPC ingress alongside HTTP (ref: serve/_private/proxy.py:533
    ``class gRPCProxy``).

    Redesigned without per-user proto codegen: ONE generic service,
    ``antray.serve.Ingress``, speaks JSON-over-gRPC —

      rpc Call(bytes)   returns (bytes)          # unary
      rpc Stream(bytes) returns (stream bytes)   # server streaming

    Request bytes are UTF-8 JSON ``{"route": "/prefix/...", "request":
    {...}}``; the reply is the deployment's JSON response.  Clients
    need only ``grpc.Channel.unary_unary`` with identity serializers —
    no generated stubs."""

    def __init__(self, controller):
        self._controller = controller
        self._server = None
        self._handles: dict[str, DeploymentHandle] = {}
        self._handles_lock = threading.Lock()

    def _resolve_handle(self, path: str) -> "DeploymentHandle | None":
        art = _art()
        routes = art.get(self._controller.routes.remote())
        for prefix, name in routes.items():
            if path.startswith(prefix):
                with self._handles_lock:
                    handle = self._handles.get(name)
                    if handle is None:
                        info = art.get(
                            self._controller.get_handle_info.remote(name))
                        handle = DeploymentHandle(
                            name, info["replicas"],
                            controller=self._controller, _info=info)
                        self._handles[name] = handle
                return handle
        return None

    @staticmethod
    def _parse(request_bytes, context):
        import json  # noqa: PLC0415

        import grpc  # noqa: PLC0415

        try:
            payload = json.loads(request_bytes.decode("utf-8"))
            route = payload["route"]
        except Exception:  # noqa: BLE001
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          'want JSON {"route": ..., "request": {...}}')
        body = payload.get("request", {})
        if isinstance(body, dict):
            body.setdefault("__route_path__", route)
        return route, body

    @staticmethod
    def _abort_overload(context, e: BaseException) -> None:
        """abort() with the documented typed mapping — the ONE place
        the gRPC shed contract is rendered (RESOURCE_EXHAUSTED + the
        retry hint in a ``retry-after-s`` trailer / DEADLINE_EXCEEDED).
        Returns (without aborting) when ``e`` is not an overload error;
        the caller handles it."""
        import grpc  # noqa: PLC0415

        typed = _typed_cause(e)
        if isinstance(typed, BackPressureError):
            context.set_trailing_metadata(
                (("retry-after-s", f"{typed.retry_after_s:.3f}"),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(typed))
        if isinstance(typed, DeadlineExceededError):
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(typed))

    def _call(self, request_bytes, context):
        import json  # noqa: PLC0415

        import grpc  # noqa: PLC0415

        route, body = self._parse(request_bytes, context)
        handle = self._resolve_handle(route)
        if handle is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no route for {route}")
        # End-to-end deadline: the native gRPC deadline (time_remaining)
        # and/or an explicit {"timeout_s": ...} in the payload — the
        # tighter one wins; the deployment default applies when neither
        # is set.
        timeout_s = None
        if isinstance(body, dict) and body.get("timeout_s") is not None:
            try:
                timeout_s = float(body["timeout_s"])
            except (TypeError, ValueError):
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "timeout_s must be a number (seconds)")
        native = context.time_remaining()
        if native is not None:
            timeout_s = (native if timeout_s is None
                         else min(timeout_s, native))
        # Tracing ingress (gRPC unary): mint, scope, record — sheds
        # force-sample an error span carrying the trace id the client
        # can quote from the trailer-documented retry contract.
        ctx = tracing_plane.mint()
        t_wall = time.time()
        t0 = time.perf_counter()
        ok = False
        try:
            with tracing_plane.use(ctx):
                result = handle.call(body, timeout_s=timeout_s)
            ok = True
        except Exception as e:  # noqa: BLE001 — classified below
            self._abort_overload(context, e)
            context.abort(grpc.StatusCode.INTERNAL, repr(e))
        finally:
            tracing_plane.record_span(
                ctx, f"grpc:{route}", ts=t_wall,
                dur_s=time.perf_counter() - t0,
                attrs={"route": route}, error=not ok,
                span_id=ctx.span_id, parent_id="",
                service="grpc-proxy")
        return json.dumps({"result": result}).encode("utf-8")

    def _stream(self, request_bytes, context):
        import json  # noqa: PLC0415

        import grpc  # noqa: PLC0415

        art = _art()
        route, body = self._parse(request_bytes, context)
        handle = self._resolve_handle(route)
        if handle is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no route for {route}")
        # Deadline rides the native gRPC call deadline; sheds map to
        # the same typed statuses as the unary path (the replica's
        # admission gate fires on generator start, i.e. the first get).
        h = handle.options(method_name="stream", stream=True)
        h._maybe_refresh()
        ctx = tracing_plane.mint()
        with tracing_plane.use(ctx):
            try:
                replica = h._pick()
            except BackPressureError as e:
                tracing_plane.record_span(
                    ctx, f"grpc:{route}", ts=time.time(), dur_s=0.0,
                    attrs={"route": route, "stream": True}, error=True,
                    span_id=ctx.span_id, parent_id="",
                    service="grpc-proxy")
                # Every replica ejected: same shed contract as unary.
                self._abort_overload(context, e)
            gen = h._dispatch(replica, (body,), {}, h._mux_model_id,
                              h._request_meta(context.time_remaining(),
                                              trace=ctx))
        try:
            for ref in gen:
                yield json.dumps(art.get(ref)).encode("utf-8")
        except Exception as e:  # noqa: BLE001 — classified below
            _record_result(h._routing, replica, e)
            self._abort_overload(context, e)
            raise
        _record_result(h._routing, replica)

    def start(self, port: int) -> int:
        from concurrent import futures  # noqa: PLC0415

        import grpc  # noqa: PLC0415

        proxy = self

        class _Ingress(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == "/antray.serve.Ingress/Call":
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._call)
                if details.method == "/antray.serve.Ingress/Stream":
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._stream)
                return None

        server = grpc.server(futures.ThreadPoolExecutor(max_workers=16))
        server.add_generic_rpc_handlers((_Ingress(),))
        bound = server.add_insecure_port(f"127.0.0.1:{port}")
        server.start()
        self._server = server
        return bound


# ---------------------------------------------------------------- run api

def _get_or_create_controller():
    art = _art()
    try:
        return art.get_actor(CONTROLLER_NAME, namespace="_serve")
    except ValueError:
        # Generous concurrency: each handle family parks one blocking
        # listen_for_change call here (ref: LongPollHost runs on the
        # controller event loop; this threaded controller needs slots).
        controller_cls = art.remote(ServeController).options(
            name=CONTROLLER_NAME, namespace="_serve", get_if_exists=True,
            max_concurrency=64, num_cpus=0, lifetime="detached")
        return controller_cls.remote()


def run(app: Application, *, port: int | None = None,
        grpc_port: int | None = None) -> DeploymentHandle:
    """Deploy an application; returns its handle (ref: serve.run).
    ``grpc_port`` additionally starts the gRPC ingress (0 = ephemeral;
    bound port in ``run.last_grpc_port``)."""
    art = _art()
    if not art.is_initialized():
        art.init()
    controller = _get_or_create_controller()
    art.get(controller.deploy.remote(app.deployment, app.args, app.kwargs))
    if port is not None or app.deployment.route_prefix:
        actual = art.get(controller.start_http_proxy.remote(
            8000 if port is None else port))
        run.last_http_port = actual  # discoverable for tests/clients
    if grpc_port is not None:
        run.last_grpc_port = art.get(
            controller.start_grpc_proxy.remote(grpc_port))
    info = art.get(
        controller.get_handle_info.remote(app.deployment.name))
    # The controller reference lets the handle refresh its replica set
    # (autoscaling) and queue snapshot (po2 routing) on a TTL.
    return DeploymentHandle(app.deployment.name, info["replicas"],
                            controller=controller, _info=info)


run.last_http_port = None
run.last_grpc_port = None


def shutdown():
    art = _art()
    try:
        controller = art.get_actor(CONTROLLER_NAME, namespace="_serve")
    except ValueError:
        return
    try:
        art.get(controller.shutdown_all.remote())
        art.kill(controller)
    except Exception:  # noqa: BLE001
        pass
