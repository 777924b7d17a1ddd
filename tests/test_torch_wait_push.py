"""Batched and push-based waits in the port against the JAX package: the
twins of tests/test_wait_push.py — owned waits resolved from the memory
store, borrowed waits parked on the owner's ``WaitObjects`` long-poll,
``GetObjectStatusBatch`` — each in an ``init(num_cpus=8)`` cluster of
each package.  Ready/not-ready splits and statuses must be equal; the
reference's timing bounds (a fast owned wait, a ``timeout=0`` poll, a
parked reply) are asserted for each package."""

import functools
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from runtime_twins import both, mod, runtime


@pytest.fixture(scope="module")
def clusters():
    # Logical CPU slots only (sleeping stand-in tasks): generous so
    # long-sleeping refs from earlier tests never starve later leases.
    jart.init(num_cpus=8, num_tpus=0)
    try:
        tart.init(num_cpus=8, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


@functools.cache
def _remotes(art):
    """(_slow, _wait_in_worker) of ``art``, as the reference's module
    defines them."""
    @art.remote
    def _slow(x, delay=1.0):
        time.sleep(delay)
        return x

    # num_cpus=2: another scheduling key than the _slow producers, so the
    # waiter never queues behind a sleeping producer on one worker.
    @art.remote(num_cpus=2)
    def _wait_in_worker(refs, num_returns, timeout):
        t0 = time.perf_counter()
        ready, not_ready = art.wait(list(refs), num_returns=num_returns,
                                    timeout=timeout)
        return len(ready), len(not_ready), time.perf_counter() - t0

    return _slow, _wait_in_worker


def test_wait_owned_all_ready_is_sync_fast_path(clusters):
    def scenario(art):
        refs = [art.put(i) for i in range(500)]
        ready, not_ready = art.wait(refs, num_returns=len(refs), timeout=60)
        assert len(ready) == 500 and not not_ready
        t0 = time.perf_counter()
        for _ in range(10):
            ready, _ = art.wait(refs, num_returns=len(refs), timeout=60)
        assert (time.perf_counter() - t0) / 10 < 0.05, art.__name__
        return len(ready), art.get(ready[:5])

    want, got = both(scenario)
    assert got == want == (500, [0, 1, 2, 3, 4])


def test_wait_num_returns_surplus_stays_not_ready(clusters):
    def scenario(art):
        refs = [art.put(i) for i in range(5)]
        ready, not_ready = art.wait(refs, num_returns=2, timeout=10)
        # Every ref comes back exactly once.
        assert {r.id for r in ready} | {r.id for r in not_ready} == \
            {r.id for r in refs}
        return len(ready), len(not_ready)

    want, got = both(scenario)
    assert got == want == (2, 3)


def test_wait_borrowed_blocks_until_push_wakeup(clusters):
    def scenario(art):
        slow, wait_in_worker = _remotes(art)
        refs = [slow.remote(i, 1.0) for i in range(2)]
        n_ready, n_not, _dt = art.get(
            wait_in_worker.remote(refs, 2, 30), timeout=90)
        return n_ready, n_not

    want, got = both(scenario)
    assert got == want == (2, 0)


def test_wait_borrowed_timeout_zero_polls_once(clusters):
    def scenario(art):
        slow, wait_in_worker = _remotes(art)
        pending = [slow.remote(1, 12.0)]
        n_ready, n_not, dt = art.get(
            wait_in_worker.remote(pending, 1, 0), timeout=90)
        assert dt < 1.0, f"{art.__name__}: timeout=0 must poll, not wait"
        ready = art.get(wait_in_worker.remote([art.put(42)], 1, 0),
                        timeout=90)
        return (n_ready, n_not), ready[:2]

    want, got = both(scenario)
    assert got == want == ((0, 1), (1, 0))


def test_wait_borrowed_respects_num_returns_and_timeout(clusters):
    def scenario(art):
        slow, wait_in_worker = _remotes(art)
        fast = art.put("done")
        slow_refs = [slow.remote(i, 30.0) for i in range(2)]
        first = art.get(wait_in_worker.remote([fast] + slow_refs, 1, 20),
                        timeout=90)
        assert first[2] < 10, \
            f"{art.__name__}: wait kept blocking past num_returns"
        second = art.get(wait_in_worker.remote(slow_refs, 1, 0.5),
                         timeout=90)
        assert 0.3 < second[2] < 10, (art.__name__, second)
        return first[:2], second[:2]

    want, got = both(scenario)
    assert got == want == ((1, 2), (0, 2))


def test_get_object_status_batch_rpc(clusters):
    def scenario(art):
        slow, _ = _remotes(art)
        rt = runtime(art)
        ready = art.put(1)
        pending = slow.remote(1, 3.0)
        unknown_oid = ready.id.from_random()
        cli = mod(art, "_private.protocol").RpcClient(rt.address)
        statuses = cli.call(
            "GetObjectStatusBatch",
            {"object_ids": [ready.id, pending.id, unknown_oid]}, timeout=10)
        return [statuses[o] for o in (ready.id, pending.id, unknown_oid)]

    want, got = both(scenario)
    assert got == want == ["ready", "pending", "unknown"]


def test_wait_objects_rpc_parks_until_terminal(clusters):
    """The owner's long-poll does not reply until the ref turns terminal
    (asserted for each package), or its deadline fires."""
    def scenario(art):
        slow, _ = _remotes(art)
        cli = mod(art, "_private.protocol").RpcClient(runtime(art).address)
        pending = slow.remote(7, 1.0)
        t0 = time.perf_counter()
        parked = cli.call(
            "WaitObjects", {"object_ids": [pending.id], "num_ready": 1,
                            "timeout": 10.0}, timeout=30)[pending.id]
        waited = time.perf_counter() - t0
        assert waited >= 0.3, \
            f"{art.__name__}: owner replied before the ref was terminal"
        stuck = slow.remote(8, 20.0)
        t0 = time.perf_counter()
        deadline = cli.call(
            "WaitObjects", {"object_ids": [stuck.id], "num_ready": 1,
                            "timeout": 0.5}, timeout=30)[stuck.id]
        assert time.perf_counter() - t0 < 5, art.__name__
        return parked, deadline

    want, got = both(scenario)
    assert got == want == ("ready", "pending")
