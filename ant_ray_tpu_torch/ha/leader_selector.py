"""Leader election for head-node HA.

Capability mirror of the ant fork's Redis-lease leader election
(ref: python/ray/ha/leader_selector.py:8 HeadNodeLeaderSelector ABC,
redis_leader_selector.py:90 RedisBasedLeaderSelector): standby heads
poll a lease; the holder renews it; a holder that misses renewals is
fenced out by expiry and a standby takes over.

Two backends share one lifecycle (:class:`_LeaseSelectorBase` —
acquire / renew / fence / release):

* :class:`FileBasedLeaderSelector` — shared-filesystem lease (atomic
  O_EXCL create + mtime-based expiry), for single-host HA tests and
  NFS deployments without any external service;
* :class:`StoreBasedLeaderSelector` — compare-and-swap TTL lease on
  the RPC'd store service (store_server.py), the cross-MACHINE
  backend: the lease lives on a third party both heads reach, exactly
  the Redis variant's role.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid

logger = logging.getLogger(__name__)


class HeadNodeLeaderSelector:
    """ABC (ref: ha/leader_selector.py:8)."""

    role = "standby"

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def is_leader(self) -> bool:
        return self.role == "leader"

    def wait_until_leader(self, timeout: float | None = None) -> bool:
        raise NotImplementedError


class _LeaseSelectorBase(HeadNodeLeaderSelector):
    """Shared lease lifecycle: a poll thread tries to acquire while
    standby and renews while leader; a failed renew means the lease was
    usurped or the backend is unreachable — either way the holder can
    no longer prove leadership and steps down (fencing).  Backends
    implement ``_try_acquire`` / ``_renew`` / ``_release``."""

    def __init__(self, *, holder_id: str | None = None,
                 lease_ttl_s: float = 3.0, renew_period_s: float = 1.0):
        self._holder = holder_id or f"head-{os.getpid()}"
        self._token = uuid.uuid4().hex
        self._ttl = lease_ttl_s
        self._renew_period = renew_period_s
        self._stop = threading.Event()
        self._became_leader = threading.Event()
        self._thread: threading.Thread | None = None
        # Fencing clock: the holder may act as leader only while
        # monotonic() < lease_valid_until (set at every successful
        # acquire/renew).  Consumers check it BEFORE applying a
        # mutation, so an expired-but-not-yet-demoted holder rejects
        # late writes instead of split-braining (the "old leader's late
        # mutation is rejected" guarantee).
        self.lease_valid_until: float = 0.0
        # Optional role-transition callbacks, invoked from the poll
        # thread (consumers post to their own loop): the replicated GCS
        # hangs its promote/demote sequences here.
        self.on_promote = None
        self.on_demote = None

    # Backend hooks -----------------------------------------------------

    def _try_acquire(self) -> bool:
        raise NotImplementedError

    def _renew(self) -> bool:
        raise NotImplementedError

    def _release(self) -> None:
        raise NotImplementedError

    # Lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _guarded(self, op) -> bool:
        """A raising backend (shared-FS blip raising raw OSError from
        the file lease) must read as 'could not prove the lease', not
        kill the poll thread — a dead selector is a silent zombie that
        can neither lead nor fail over."""
        try:
            return op()
        except Exception:  # noqa: BLE001 — backend blip: stand by
            logger.exception("lease backend error (treated as failure)")
            return False

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.role == "leader":
                # Stamp the validity window BEFORE the backend round
                # trip: the lease is good for ttl from (at latest) the
                # moment the renew was issued, so the window is
                # conservative even when the renew itself is slow.
                stamp = time.monotonic() + self._ttl
                if self._guarded(self._renew):
                    self.lease_valid_until = stamp
                else:
                    # Fenced (or the backend is gone): a leader that
                    # cannot prove its lease must not act.
                    self.lease_valid_until = 0.0
                    self.role = "standby"
                    self._became_leader.clear()
                    callback = self.on_demote
                    if callback is not None:
                        callback()
            else:
                stamp = time.monotonic() + self._ttl
                if self._guarded(self._try_acquire):
                    self.lease_valid_until = stamp
                    self.role = "leader"
                    self._became_leader.set()
                    callback = self.on_promote
                    if callback is not None:
                        callback()
            self._stop.wait(self._renew_period)

    def wait_until_leader(self, timeout: float | None = None) -> bool:
        return self._became_leader.wait(timeout)

    def fencing_token(self) -> str:
        return self._token

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Release the lease if we still hold it so standbys fail over
        # immediately instead of waiting out the TTL.
        try:
            self._release()
        except Exception:  # noqa: BLE001 — best effort
            pass
        self.lease_valid_until = 0.0
        self.role = "standby"
        self._became_leader.clear()


class FileBasedLeaderSelector(_LeaseSelectorBase):
    """Lease file on a shared filesystem.

    The lease is a JSON file {holder, token, renewed_at}, held by
    renewing ``renewed_at`` and considered expired ``lease_ttl_s``
    after the last renewal.  Acquisition is serialized through an
    atomic ``mkdir`` mutex (only one contender enters the
    check-expiry-then-write critical section, so there is no
    dual-leader window); a mutex dir older than the TTL is treated as
    the debris of a crashed contender and removed.  ``fencing_token()``
    returns the holder's token so fenced writes can be rejected
    downstream (same role as the Redis key's value in the reference).
    """

    def __init__(self, lease_path: str, *, holder_id: str | None = None,
                 lease_ttl_s: float = 3.0, renew_period_s: float = 1.0):
        super().__init__(holder_id=holder_id, lease_ttl_s=lease_ttl_s,
                         renew_period_s=renew_period_s)
        self._path = lease_path

    # ---- lease file primitives

    def _read_lease(self) -> dict | None:
        try:
            with open(self._path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write_lease(self) -> None:
        tmp = f"{self._path}.tmp.{os.getpid()}.{self._token[:8]}"
        with open(tmp, "w") as f:
            json.dump({"holder": self._holder, "token": self._token,
                       "renewed_at": time.time()}, f)
        os.rename(tmp, self._path)

    def _try_acquire(self) -> bool:
        lease = self._read_lease()
        if lease is not None:
            if lease.get("token") == self._token:
                return True
            # artlint: disable=banned-apis — renewed_at is a CROSS-
            # PROCESS wire field (the lease file is read by every
            # contender); wall clock is the only clock they share.
            if time.time() - lease.get("renewed_at", 0) < self._ttl:
                return False
        # Expired (or absent) — take the acquisition mutex so exactly
        # one contender fences the old holder.
        mutex = f"{self._path}.acquiring"
        try:
            os.mkdir(mutex)
        except FileExistsError:
            try:
                # artlint: disable=banned-apis — compared against a
                # file mtime, which is wall clock by definition.
                if time.time() - os.path.getmtime(mutex) > self._ttl:
                    os.rmdir(mutex)  # crashed contender's debris
            except OSError:
                pass
            return False
        try:
            lease = self._read_lease()  # re-check under the mutex
            # artlint: disable=banned-apis — renewed_at: cross-process
            # lease-file field, wall clock by design (see above).
            if lease is not None and lease.get("token") != self._token \
                    and time.time() - lease.get("renewed_at", 0) < \
                    self._ttl:
                return False
            self._write_lease()
            return True
        finally:
            try:
                os.rmdir(mutex)
            except OSError:
                pass

    def _renew(self) -> bool:
        lease = self._read_lease()
        if lease is None or lease.get("token") != self._token:
            return False     # usurped while we slept: fenced
        self._write_lease()
        return True

    def _release(self) -> None:
        lease = self._read_lease()
        if lease is not None and lease.get("token") == self._token:
            try:
                os.unlink(self._path)
            except FileNotFoundError:
                pass


class StoreBasedLeaderSelector(_LeaseSelectorBase):
    """Lease against the RPC'd store service (store_server.py) — the
    cross-MACHINE election backend (capability mirror of the ant fork's
    RedisBasedLeaderSelector, ha/redis_leader_selector.py:90: the lease
    lives on a third party both heads can reach, so a standby on
    another machine takes over when the primary stops renewing).

    The store's LeaseAcquire/LeaseRenew are compare-and-swap on the
    holder token, so a fenced ex-leader's renewals are rejected and it
    steps down."""

    _LEASE_NAME = "head-leader"

    def __init__(self, store_address: str, *,
                 holder_id: str | None = None,
                 lease_ttl_s: float = 3.0, renew_period_s: float = 1.0):
        from ant_ray_tpu_torch._private.protocol import ClientPool

        super().__init__(holder_id=holder_id, lease_ttl_s=lease_ttl_s,
                         renew_period_s=renew_period_s)
        self._client = ClientPool().get(
            store_address.removeprefix("art-store://"))

    def _try_acquire(self) -> bool:
        try:
            reply = self._client.call(
                "LeaseAcquire",
                {"name": self._LEASE_NAME, "holder": self._holder,
                 "token": self._token, "ttl": self._ttl}, timeout=5)
            return bool(reply.get("acquired"))
        except Exception:  # noqa: BLE001 — store unreachable: stand by
            return False

    def _renew(self) -> bool:
        try:
            reply = self._client.call(
                "LeaseRenew",
                {"name": self._LEASE_NAME, "token": self._token,
                 "ttl": self._ttl}, timeout=5)
            return bool(reply.get("renewed"))
        except Exception:  # noqa: BLE001
            return False

    def _release(self) -> None:
        self._client.call("LeaseRelease",
                          {"name": self._LEASE_NAME,
                           "token": self._token}, timeout=5)
