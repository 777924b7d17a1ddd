"""The request-deadline context of Serve (a copy of the ContextVar and
its getter in ant_ray_tpu/serve/api.py, which the port does not
import).

In the reference a replica sets ``_request_deadline`` around the user
code it invokes, from the deadline the ingress or handle stamped.  The
port has no replica yet, so a caller in one process sets it itself::

    token = _request_deadline.set(time.time() + 2.0)
    try:
        server(request)
    finally:
        _request_deadline.reset(token)

A ContextVar is per thread (and per asyncio task): a deadline set in one
thread is not seen by another.
"""

from __future__ import annotations

import contextvars

# Absolute (time.time) end-to-end deadline of the in-flight request,
# stamped by the ingress/handle and set by the replica around user-code
# invocation so nested machinery (the LLM server) can shed expired work
# instead of executing it.
_request_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "serve_request_deadline", default=None)


def get_request_deadline() -> float | None:
    """Absolute ``time.time()`` deadline of the in-flight request (None
    when the caller set no deadline)."""
    return _request_deadline.get()
