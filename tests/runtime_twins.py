"""Shared pieces of the runtime twins (``tests/test_torch_<name>.py``
beside the JAX package's ``tests/test_<name>.py``): a scenario runs in a
cluster of each package with the same seeded inputs and keeps the
reference's assertions; the two outcomes are then compared, with the
package's own name and random ids masked in messages, and node ids
mapped to a tag of each node (its resources or labels)."""

import importlib
import re
import time

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)
IDS = ("jax", "torch")


def mod(art, name: str):
    """The submodule ``name`` of the package ``art``."""
    return importlib.import_module(f"{art.__name__}.{name}")


def mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", message)


def error(e: BaseException):
    """An exception in a form both packages can be compared by; a task
    error's cause likewise."""
    cause = getattr(e, "cause", None)
    if hasattr(e, "function_name") and hasattr(e, "remote_traceback"):
        return (type(e).__name__, e.function_name,
                error(cause) if cause is not None else None,
                mask(e.remote_traceback.strip().splitlines()[-1]))
    return (type(e).__name__, mask(str(e)))


def outcome(fn):
    """("ok", value) or ("raise", the exception's comparable form)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", error(e))


def both(scenario, *args):
    """``scenario(art, *args)`` in the JAX package, then in the port."""
    return tuple(scenario(art, *args) for art in PACKAGES)


def runtime(art):
    """The connected driver's core runtime of ``art``."""
    return mod(art, "_private.worker").global_worker.runtime


def free_all_copies(art, ref):
    """Every copy of ``ref`` destroyed cluster-wide through the GCS's
    ``FreeObject`` (eviction or node loss, as tests/test_lineage.py:22
    makes it)."""
    runtime(art)._gcs.call("FreeObject", {"object_id": ref.id}, retries=3)
    time.sleep(0.2)


def node_tags(art, tag_of) -> dict:
    """{node id: tag} of the alive nodes, ``tag_of(node)`` naming each
    by what it carries (resources, labels) rather than its random id."""
    return {n["NodeID"]: tag_of(n) for n in art.nodes() if n["Alive"]}


def wait_for(predicate, timeout: float, interval: float = 0.1):
    """``predicate()``'s first truthy value within ``timeout`` seconds,
    else its last value."""
    deadline = time.monotonic() + timeout
    while True:
        value = predicate()
        if value or time.monotonic() > deadline:
            return value
        time.sleep(interval)
