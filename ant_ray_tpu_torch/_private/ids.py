"""Binary IDs for every first-class entity in the system.

Design: compact fixed-width binary identifiers, mirroring the semantics of the
reference's id layer (ref: src/ray/common/id.h) without its layout.  IDs embed
lineage where it is useful (an ObjectID embeds the TaskID that creates it, a
TaskID embeds the ActorID/JobID it belongs to) so ownership and lineage walks
never need a table lookup.

Layout (bytes):
    JobID     4   random per driver
    ActorID  12   = JobID(4) + random(8)
    TaskID   20   = ActorID(12) + random(8)       (normal tasks: ActorID = nil-actor of job)
    ObjectID 24   = TaskID(20) + index(4, big-endian)
    NodeID   16   random
    WorkerID 16   random
    PlacementGroupID 16 = JobID(4) + random(12)
"""

from __future__ import annotations

import os
import random
import threading

# Hot-path randomness: ids are minted per task/object on the submission
# path, where os.urandom's syscall (~8µs) dominates.  A process-local
# Mersenne generator seeded from the OS pool keeps ids unique across
# processes (64+ random bits per id) at ~0.5µs a draw.  Workers are
# spawned (never forked), so the state is not duplicated.
_rng = random.Random(os.urandom(16))


def _fast_random_bytes(n: int) -> bytes:
    return _rng.getrandbits(n * 8).to_bytes(n, "big")

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 12
_TASK_ID_SIZE = 20
_OBJECT_ID_SIZE = 24
_NODE_ID_SIZE = 16
_WORKER_ID_SIZE = 16
_PLACEMENT_GROUP_ID_SIZE = 16


class BaseID:
    """Immutable fixed-width binary id, hashable, hex-printable."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash(self._bytes)

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE


class NodeID(BaseID):
    SIZE = _NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = _WORKER_ID_SIZE


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + _fast_random_bytes(cls.SIZE - JobID.SIZE))

    @classmethod
    def nil_of_job(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + b"\xff" * (cls.SIZE - JobID.SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JobID.SIZE])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls.for_actor_task(ActorID.nil_of_job(job_id))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary()
                   + _fast_random_bytes(cls.SIZE - ActorID.SIZE))

    @classmethod
    def for_driver_task(cls, job_id: JobID) -> "TaskID":
        return cls.for_normal_task(job_id)

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:ActorID.SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JobID.SIZE])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def from_random(cls) -> "ObjectID":
        # Random put: embed a random "task" so the owner prefix is unique.
        return cls(os.urandom(cls.SIZE))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE:], "big")

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JobID.SIZE])


class PlacementGroupID(BaseID):
    SIZE = _PLACEMENT_GROUP_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + os.urandom(cls.SIZE - JobID.SIZE))


class _PutIndexCounter:
    """Monotonic per-task put index so `put` object ids are deterministic
    within a task (ref semantics: ObjectID::FromIndex)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[TaskID, int] = {}

    def next(self, task_id: TaskID) -> int:
        with self._lock:
            n = self._counts.get(task_id, 0) + 1
            self._counts[task_id] = n
            # Put indices live above the return-object index space.
            return 0x8000_0000 + n
