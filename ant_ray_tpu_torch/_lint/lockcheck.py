"""Lock factories for the runtime's planes.

:func:`make_lock` / :func:`make_rlock` are the factories the object
store and the worker take their locks from, as in the JAX package's
``_lint/lockcheck.py``.  There, ``ART_LOCKCHECK=1`` makes them return
instrumented wrappers that record the lock-acquisition graph of the
daemon planes and report lock-order cycles and long holds during chaos
soaks.  The port's daemons run no soak yet, so the factories return
plain ``threading`` locks and :func:`note_blocking` is a no-op; the
instrumented path comes with the first soak that turns it on (ROADMAP
queue A item 6.6).
"""

from __future__ import annotations

import threading


def make_lock(name: str | None = None):
    """A ``threading.Lock``; ``name`` labels it for the instrumented
    path to come."""
    return threading.Lock()


def make_rlock(name: str | None = None):
    """A ``threading.RLock``; ``name`` as for :func:`make_lock`."""
    return threading.RLock()


def note_blocking(what: str) -> None:
    """Mark the calling thread's held locks as having run a blocking
    call (sync RPC, socket I/O, subprocess) named ``what``.  A no-op
    until the instrumented path is ported (ROADMAP queue A item 6.6);
    the RPC, GCS-client and transfer paths call it with the JAX
    package's signature."""
