"""Zero-copy pins in the port against the JAX package: the twins of
tests/test_zero_copy_pins.py — a delete under a pin tombstones and keeps
the bytes; an unpin after a re-create releases the doomed generation; a
token-matched ``ReadDone``; pin leases that expire, renew and are capped
(``ART_ZERO_COPY_PIN_TTL_S``, ``ART_READ_PIN_TTL_S``); zero-copy values
that outlive their lease and their owner's delete under arena churn.
Store- and daemon-level scenarios run on each package's ``ObjectStore``
and a ``NodeManager`` shell with the same payloads (seeded); the cluster
ones in an ``init(num_cpus=2)`` cluster of each package in turn (the
pin TTLs reach its processes as ``ART_*`` variables, which both
packages read).  Outcomes must be equal."""

import asyncio
import gc
import time

import numpy as np
import pytest

from runtime_twins import PACKAGES, both, mod


def _payload(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _store(art, path):
    return mod(art, "_private.object_store").ObjectStore(
        str(path), capacity_bytes=1 << 20)


def _oid(art):
    return mod(art, "_private.ids").ObjectID.from_random()


# --------------------------------------------------------------- store level


def test_delete_under_pin_tombstones(tmp_path):
    def scenario(art):
        store = _store(art, tmp_path / art.__name__)
        oid = _oid(art)
        payload = _payload(4096)
        store.create(oid, payload)
        info = store.locate(oid)
        store.pin(oid, token=1)
        used_before = store.used
        store.delete(oid)
        # Gone for lookups, but the bytes stay allocated while pinned.
        out = [store.contains(oid), store.locate(oid) is None,
               store.is_doomed(oid), store.used == used_before,
               store.uses_arena]
        if store.uses_arena:
            view = mod(art, "_private.object_store").ArenaClient().view(
                info["path"], info["offset"], 4096)
            for i in range(32):   # heavy churn must not recycle the range
                store.create(_oid(art), _payload(4096, i + 1))
            out.append(bytes(view) == payload)
        used_before_unpin = store.used
        store.unpin(oid, token=1)
        out += [store.is_doomed(oid), store.used == used_before_unpin - 4096]
        store.destroy()
        return out

    want, got = both(scenario)
    assert got == want
    assert got == [False, True, True, True, True, True, False, True]


def test_unpin_after_recreate_hits_doomed_generation(tmp_path):
    """A reader's unpin after its object was deleted and re-created
    under the same id releases the doomed generation it pinned."""
    def scenario(art):
        store = _store(art, tmp_path / art.__name__)
        oid = _oid(art)
        store.create(oid, b"old" * 100)
        store.pin(oid, token=1)          # reader A pins generation 1
        store.delete(oid)                # tombstoned (A still reading)
        store.create(oid, b"new" * 100)  # reconstruction re-stores the id
        store.pin(oid, token=2)          # reader B pins generation 2
        out = [store.is_doomed(oid)]
        store.unpin(oid, token=1)        # A finishes
        out += [store.is_doomed(oid), set(store._entries[oid].pin_tokens)]
        store.unpin(oid, token=2)
        out.append(set(store._entries[oid].pin_tokens))
        store.destroy()
        return out

    want, got = both(scenario)
    assert got == want == [True, False, {2}, set()]


def test_delete_unpinned_frees_immediately(tmp_path):
    def scenario(art):
        store = _store(art, tmp_path / art.__name__)
        oid = _oid(art)
        store.create(oid, b"x" * 1024)
        used_before = store.used
        store.delete(oid)
        out = (store.used < used_before, store.is_doomed(oid))
        store.destroy()
        return out

    want, got = both(scenario)
    assert got == want == (True, False)


# -------------------------------------------------------------- daemon level


@pytest.fixture
def pin_config(monkeypatch):
    """Tiny pin TTLs (env-overridable config, rebuilt around the test)."""
    monkeypatch.setenv("ART_READ_PIN_TTL_S", "0.3")
    monkeypatch.setenv("ART_ZERO_COPY_PIN_TTL_S", "0.3")
    for art in PACKAGES:
        mod(art, "_private.config")._global_config = None
    yield None
    for art in PACKAGES:
        mod(art, "_private.config")._global_config = None


def _mini_daemon(art, tmp_path):
    """A NodeManager shell with just the pin-lease machinery wired up."""
    d = object.__new__(mod(art, "_private.node_daemon").NodeManager)
    d._pin_leases = {}
    d._next_pin_token = 1
    d.store = _store(art, tmp_path / art.__name__)
    assert d.store.uses_arena, "the pin machinery is arena-only"
    return d


def test_read_done_is_token_matched(tmp_path):
    def scenario(art):
        d = _mini_daemon(art, tmp_path)
        oid = _oid(art)
        d.store.create(oid, b"y" * 512)
        long_loc = d._locate_pinned(oid, ttl=500.0)
        short_loc = d._locate_pinned(oid, ttl=None)   # default short lease
        out = [long_loc["pin_token"] != short_loc["pin_token"]]
        # The short reader finishing releases its lease, not the
        # earliest-queued one.
        asyncio.run(d._read_done(
            {"object_id": oid, "pin_token": short_loc["pin_token"]}))
        out.append(set(d._pin_leases[oid]) == {long_loc["pin_token"]})
        d._reap_expired_pins()
        out.append(oid in d._pin_leases)          # long lease survives
        asyncio.run(d._read_done(
            {"object_id": oid, "pin_token": long_loc["pin_token"]}))
        out.append(oid not in d._pin_leases)
        d.store.destroy()
        return out

    want, got = both(scenario)
    assert got == want == [True] * 4


def test_pin_lease_expiry_and_renewal(tmp_path, pin_config):
    def scenario(art):
        d = _mini_daemon(art, tmp_path)
        oid = _oid(art)
        d.store.create(oid, b"z" * 512)
        # Expiry: an unrenewed pin is reaped after its TTL.
        loc = d._locate_pinned(oid, ttl=0.2)
        time.sleep(0.45)
        d._reap_expired_pins()
        out = [oid not in d._pin_leases]
        reply = asyncio.run(d._renew_pins(
            {"pins": [(oid, loc["pin_token"])], "ttl": 0.3}))
        out.append(reply == {"gone": [(oid, loc["pin_token"])]})
        # Renewal: heartbeats keep the lease alive past the first TTL.
        loc = d._locate_pinned(oid, ttl=0.3)
        for _ in range(3):
            time.sleep(0.2)
            reply = asyncio.run(d._renew_pins(
                {"pins": [(oid, loc["pin_token"])], "ttl": 0.3}))
            d._reap_expired_pins()
            out += [reply == {"gone": []}, oid in d._pin_leases]
        d.store.destroy()
        return out

    want, got = both(scenario)
    assert got == want == [True] * 8


def test_pin_lease_is_capped(tmp_path):
    """A bogus client TTL can't wedge a slot past the daemon-side cap."""
    def scenario(art):
        d = _mini_daemon(art, tmp_path)
        oid = _oid(art)
        d.store.create(oid, b"w" * 64)
        loc = d._locate_pinned(oid, ttl=1e12)
        expiry = d._pin_leases[oid][loc["pin_token"]]
        cap = type(d)._MAX_PIN_LEASE_S
        d.store.destroy()
        return cap, expiry - time.monotonic() <= cap + 1

    want, got = both(scenario)
    assert got == want
    assert got[1]


# ------------------------------------------------------------- cluster level


def _churn(art, rng, n=12, size=1 << 20):
    """Arena allocation traffic, so that a wrongly freed range would be
    recycled (and the corruption observable)."""
    refs = [art.put(rng.integers(0, 256, size, dtype=np.uint8))
            for _ in range(n)]
    for r in refs:
        art.get(r)


def _in_pin_cluster(monkeypatch, scenario):
    """``scenario(art, rng)`` in a cluster of each package in turn whose
    zero-copy pin leases expire fast (2.4 s; reads 2.0 s): with client
    renewal at TTL/3 the held values must still stay intact."""
    monkeypatch.setenv("ART_ZERO_COPY_PIN_TTL_S", "2.4")
    monkeypatch.setenv("ART_READ_PIN_TTL_S", "2.0")
    outs = []
    for art in PACKAGES:
        config = mod(art, "_private.config")
        config._global_config = None
        art.init(num_cpus=2)
        try:
            outs.append(scenario(art, np.random.default_rng(0)))
        finally:
            art.shutdown()
            config._global_config = None
    return outs


def test_zero_copy_value_survives_ttl_expiry(monkeypatch):
    def scenario(art, rng):
        arr = art.get(art.put(np.arange(300_000, dtype=np.int64)))
        expected = arr.copy()
        # Hold well past the 2.4 s lease (> 2 TTLs) under arena churn.
        deadline = time.monotonic() + 5.5
        while time.monotonic() < deadline:
            _churn(art, rng, n=4)
            time.sleep(0.3)
        assert np.array_equal(arr, expected), art.__name__
        return int(arr.sum())

    want, got = _in_pin_cluster(monkeypatch, scenario)
    assert got == want


def test_zero_copy_value_survives_owner_delete(monkeypatch):
    def scenario(art, rng):
        ref = art.put(np.arange(262_144, dtype=np.int64))
        arr = art.get(ref)
        expected = arr.copy()
        del ref                   # the owner frees the object cluster-wide
        gc.collect()
        time.sleep(0.6)           # let the free reach the daemon
        _churn(art, rng)
        assert np.array_equal(arr, expected), art.__name__
        return int(arr.sum())

    want, got = _in_pin_cluster(monkeypatch, scenario)
    assert got == want
