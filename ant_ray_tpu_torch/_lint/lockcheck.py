"""Lock factories for the runtime's planes.

:func:`make_lock` / :func:`make_rlock` are the factories the object
store and the worker take their locks from, as in the JAX package's
``_lint/lockcheck.py``.  There, ``ART_LOCKCHECK=1`` makes them return
instrumented wrappers that record the lock-acquisition graph of the
daemon planes and report lock-order cycles and long holds during chaos
soaks.  The port has no daemons and no soak yet, so the factories
return plain ``threading`` locks; the instrumented path comes with the
processes of cluster mode (ROADMAP queue A item 6.1b) and the first
test that turns it on.
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
