"""Exception types the port raises (a copy of ant_ray_tpu.exceptions,
which the port does not import; ref: python/ray/exceptions.py
semantics)."""

from __future__ import annotations

import traceback


class ArtError(Exception):
    """Base class for all framework errors."""


class TaskError(ArtError):
    """A task raised an exception during execution.

    Wraps the remote traceback; re-raised at every `get` on the task's
    return objects and propagated through dependent tasks
    (exception lineage, ref: RayTaskError semantics).
    """

    def __init__(self, function_name: str, cause: BaseException | None = None,
                 remote_traceback: str = ""):
        self.function_name = function_name
        self.cause = cause
        self.remote_traceback = remote_traceback
        super().__init__(
            f"Task {function_name} failed:\n{remote_traceback or cause}"
        )

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, exc, tb)


class ActorError(TaskError):
    """An actor task failed (actor method raised or actor died)."""


class ActorDiedError(ArtError):
    def __init__(self, actor_id, reason: str = ""):
        self.actor_id = actor_id
        super().__init__(f"Actor {actor_id} died: {reason}")


class ActorUnavailableError(ArtError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class WorkerCrashedError(ArtError):
    """The worker executing the task exited unexpectedly."""


class ObjectLostError(ArtError):
    """An object was evicted/lost and could not be reconstructed."""

    def __init__(self, object_id, reason: str = ""):
        self.object_id = object_id
        super().__init__(f"Object {object_id} lost: {reason}")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class GetTimeoutError(ArtError, TimeoutError):
    """`get(timeout=...)` expired before the object was ready."""


class TaskCancelledError(ArtError):
    """The task was cancelled (``art.cancel``) before it executed."""

    def __init__(self, task_id=None, reason: str = ""):
        self.task_id = task_id
        self.reason = reason
        shown = task_id.hex() if hasattr(task_id, "hex") else (
            task_id or "<unknown>")
        super().__init__(
            f"Task {shown} cancelled{': ' + reason if reason else ''}")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id, self.reason))


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


class RuntimeEnvSetupError(ArtError):
    pass


class NodeDiedError(ArtError):
    pass


class PendingCallsLimitExceeded(ArtError):
    pass
