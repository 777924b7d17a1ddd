"""Shared-memory mutable-object channels.

The substrate of compiled DAGs (ref:
src/ray/core_worker/experimental_mutable_object_manager.h:44 — mutable
plasma objects with writer/reader semaphores; python surface
python/ray/experimental/channel/shared_memory_channel.py).  Each channel
is its own small mmap file with a version counter and a readers-done
counter; synchronization is acquire/release atomics with GIL-released
spin-waits in C++ (``native/store_core.cpp`` ``Channel`` over
``native/channel_core.h``, the same protocol as the JAX package's).

Protocol: single writer, ``num_readers`` readers.  Every published
version must be read (acquire) and released by every reader before the
next write can begin — the backpressure contract of the reference's
mutable objects, which makes a pipeline of channel-connected actors
self-throttling.

Values go through the port's serializer: a CUDA tensor crosses as the
bytes of its elements (the writer's ``.cpu()`` waits for the card) and
is rebuilt on ``cuda`` in the reader, on the reading thread's current
device and stream.  A process with no card raises there; the tensor is
never moved to the CPU.  A payload over the channel's capacity raises
the native ``MemoryError`` naming both sizes.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

from ant_ray_tpu_torch._private.native import load_native
from ant_ray_tpu_torch._private.serialization import (
    SerializedObject,
    deserialize,
    serialize,
)

_TAG_VALUE = 0
_TAG_ERROR = 1


class ChannelClosedError(Exception):
    """The channel was torn down (writer or driver called close())."""


class ChannelTimeoutError(Exception):
    pass


class ShmChannel:
    """One mutable shm buffer: ``write(obj)`` / ``begin_read()`` /
    ``end_read()``.  Values are pickled with out-of-band buffers (numpy
    arrays' and tensors' bytes are written into the buffer once)."""

    def __init__(self, path: str, capacity: int = 0, num_readers: int = 1,
                 create: bool = False):
        native = load_native()
        if native is None:
            raise RuntimeError(
                "art_torch_native is unavailable — shm channels need the "
                "C++ extension (no compiler on this host?)")
        self.path = path
        self._ch = native.Channel(path, capacity=capacity,
                                  num_readers=num_readers, create=create)
        self._last_version = 0
        self._reading = False

    # ------------------------------------------------------------ writer

    def write(self, value: Any, timeout: float | None = None) -> None:
        self._write_tagged(_TAG_VALUE, serialize(value).to_payload(),
                           timeout)

    def write_error(self, err: Exception,
                    timeout: float | None = None) -> None:
        self._write_tagged(_TAG_ERROR, pickle.dumps(err), timeout)

    def _write_tagged(self, tag: int, payload: bytes,
                      timeout: float | None) -> None:
        nbytes = len(payload) + 1
        try:
            view = self._ch.write_begin(
                nbytes, -1.0 if timeout is None else timeout)
        except ValueError as e:
            raise ChannelClosedError(str(e)) from None
        except TimeoutError as e:
            raise ChannelTimeoutError(str(e)) from None
        view[0] = tag
        view[1:nbytes] = payload
        self._ch.write_commit(nbytes)

    # ------------------------------------------------------------ reader

    def begin_read(self, timeout: float | None = None) -> Any:
        """Block until a version newer than the last one read arrives;
        returns the deserialized value (raises the payload's error if the
        producer wrote one).  Call :meth:`end_read` when done with it —
        the writer cannot publish the next version until every reader
        has."""
        tag, value = self.begin_read_tagged(timeout)
        if tag == "error":
            self.end_read()
            raise value
        return value

    def begin_read_tagged(
            self, timeout: float | None = None) -> tuple[str, Any]:
        """Like :meth:`begin_read` but returns ("value", v) or
        ("error", exc) without raising — the exec-loop path, where errors
        are propagated values, not control flow."""
        try:
            out = self._ch.read_acquire(
                self._last_version, -1.0 if timeout is None else timeout)
        except ValueError as e:
            raise ChannelClosedError(str(e)) from None
        if out is None:
            raise ChannelTimeoutError(
                f"no new value within {timeout}s on {self.path}")
        version, view = out
        self._last_version = version
        self._reading = True
        tag = view[0]
        # A copy out of the shm view before anything is built from it:
        # once end_read() releases this version, the writer overwrites
        # the buffer, and a tensor's copy must not still be reading it.
        body = bytes(view[1:])
        if tag == _TAG_ERROR:
            return ("error", pickle.loads(body))
        return ("value", deserialize(SerializedObject.from_payload(body)))

    def end_read(self) -> None:
        if self._reading:
            self._reading = False
            self._ch.read_release()

    def remove_reader(self) -> int:
        """Reader-death recovery: a registered reader died without
        releasing, so stop requiring its releases forever — the writer
        side unwedges on the next publish attempt (ref: reader-failure
        handling, experimental_mutable_object_manager.h:44).  Call once
        per dead reader from whoever observed the death (the DAG driver
        sees exec-loop actor deaths).  Returns the remaining reader
        count."""
        try:
            return self._ch.remove_reader()
        except ValueError as e:
            raise ChannelClosedError(str(e)) from None

    # ------------------------------------------------------------ misc

    @property
    def version(self) -> int:
        return self._ch.version

    def close(self, unlink: bool = False) -> None:
        try:
            self._ch.close()
        finally:
            if unlink:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass


def channel_dir() -> str:
    """Where channel files live: ``/dev/shm/art_channels`` (``/tmp`` on a
    host without ``/dev/shm``)."""
    base = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    d = os.path.join(base, "art_channels")
    os.makedirs(d, exist_ok=True)
    return d
