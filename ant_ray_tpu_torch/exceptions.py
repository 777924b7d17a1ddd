"""Exception types the port raises (copied from ant_ray_tpu.exceptions,
which the port does not import)."""

from __future__ import annotations


class ArtError(Exception):
    """Base class for all framework errors."""


class BackPressureError(ArtError):
    """A bounded queue refused new work (admission control).

    Raised by the LLM engine when its KV slots and waiting queue are
    full.  ``retry_after_s`` is the server's hint for when capacity is
    likely to free up."""

    def __init__(self, message: str = "queue at capacity",
                 retry_after_s: float = 1.0):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message)

    def __reduce__(self):
        return (BackPressureError, (str(self.args[0]) if self.args
                                    else "queue at capacity",
                                    self.retry_after_s))


class KVRestoreError(ArtError):
    """An offloaded LLM session's KV slab could not be restored.

    Raised per-session (the engine loop keeps serving every other
    session) when the fetch of an evicted slab fails.  Carries the
    session id so callers can retry with a fresh session (the token
    history is gone with the slab)."""

    def __init__(self, message: str = "KV restore failed",
                 session_id: str = ""):
        self.session_id = session_id
        super().__init__(message)

    def __reduce__(self):
        return (KVRestoreError, (str(self.args[0]) if self.args
                                 else "KV restore failed",
                                 self.session_id))


class DeadlineExceededError(ArtError, TimeoutError):
    """The request's end-to-end deadline expired.

    Expired work is SHED, never executed: the server checks the stamped
    deadline (serve/api.py ``get_request_deadline``) before it submits a
    request, and a wait that outlives the deadline raises this."""
