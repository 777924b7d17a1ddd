"""The port's wire (``protocol``, ``hotframe``, ``wire_schema``) against
the JAX package's: the counterparts of tests/test_wire_schema.py and
tests/test_hot_wire.py, each run through both packages, plus what ties
the two wires together — equal schema tables, byte-equal hot frames for
the same ``TaskSpec`` made from the same id bytes, a frame made by one
package read by the other where it names no package class, and the
version fence between them."""

import asyncio
import dataclasses
import importlib
import os
import pickle
import re
import time
from types import SimpleNamespace

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _namespace(art):
    def mod(name):
        return importlib.import_module(f"{art.__name__}._private.{name}")

    return SimpleNamespace(
        art=art, hotframe=mod("hotframe"), protocol=mod("protocol"),
        wire_schema=mod("wire_schema"), ids=mod("ids"), specs=mod("specs"),
        config=mod("config"), gcs_client=mod("gcs_client"),
        tracing=importlib.import_module(
            f"{art.__name__}.observability.tracing_plane"))


J, T = _namespace(jart), _namespace(tart)


@pytest.fixture(params=[J, T], ids=["jax", "torch"])
def P(request):
    return request.param


def _actor_spec(P, seq: int = 0, payload: bytes = b"x" * 64, trace=None,
                **overrides):
    aid = overrides.pop("actor_id", None) or P.ids.ActorID.of(
        P.ids.JobID.from_random())
    fields = dict(
        task_id=P.ids.TaskID.for_actor_task(aid), function_id="",
        function_name="Echo.ping", args_payload=payload, num_returns=1,
        owner_address="127.0.0.1:7777", resources={}, actor_id=aid,
        method_name="ping", sequence_no=seq, trace_ctx=trace)
    fields.update(overrides)
    return P.specs.TaskSpec(**fields)


def _task_spec(P, task_id: bytes, payload: bytes, trace=None):
    """A plain task's spec from given id bytes: nothing in it names a
    class of either package."""
    return P.specs.TaskSpec(
        task_id=P.ids.TaskID(task_id), function_id="fn:abc",
        function_name="mod.add", args_payload=payload, num_returns=1,
        owner_address="127.0.0.1:7777", resources={"CPU": 1.0},
        max_retries=3, sequence_no=5, trace_ctx=trace, attempt=1)


# ------------------------------------------------- tests/test_wire_schema

_SERVICE_SOURCES = ("_private/gcs.py", "_private/node_daemon.py",
                    "_private/core.py", "_private/worker_main.py")


def _registered_methods(package: str) -> set:
    """Route names from the services' registration blocks."""
    methods = set()
    for rel in _SERVICE_SOURCES:
        src = open(os.path.join(REPO, package, rel)).read()
        methods |= set(re.findall(r'"([A-Z][A-Za-z]+)":\s*(?:self\.)?'
                                  r'(?:handle_)?_?[a-z_]+,', src))
        methods |= set(re.findall(r'fast_route\("([A-Za-z]+)"', src))
        methods |= set(re.findall(r'"([A-Z][A-Za-z]+)":\s*handle_[a-z_]+',
                                  src))
    return methods


def test_schema_tables_equal():
    """One wire: the same protocol and hot-wire versions, the same
    method registry and the same tracing plane for every method."""
    assert T.protocol.PROTOCOL_VERSION == J.protocol.PROTOCOL_VERSION
    assert T.hotframe.HOT_WIRE_VERSION == J.hotframe.HOT_WIRE_VERSION
    assert T.wire_schema.METHODS == J.wire_schema.METHODS
    assert T.tracing.RPC_METHOD_PLANES == J.tracing.RPC_METHOD_PLANES
    assert T.hotframe.TEMPLATE_FIELDS == J.hotframe.TEMPLATE_FIELDS


def test_every_route_has_a_schema_entry():
    registered = _registered_methods("ant_ray_tpu_torch")
    assert len(registered) > 70, f"extractor broke: {sorted(registered)}"
    assert registered <= _registered_methods("ant_ray_tpu")
    missing = registered - set(T.wire_schema.METHODS)
    assert not missing, sorted(missing)


def test_schema_entries_are_well_formed():
    for name, entry in T.wire_schema.METHODS.items():
        assert entry["since"] <= T.protocol.PROTOCOL_VERSION, name
        assert entry["service"], name
        assert entry["payload"] and entry["reply"], name


def test_every_method_has_an_rpc_latency_plane():
    missing = set(T.wire_schema.METHODS) - set(T.tracing.RPC_METHOD_PLANES)
    assert not missing, sorted(missing)


def _fence(P_server, proto):
    """Drive a HELLO naming ``proto`` at a ``P_server`` RpcServer with a
    raw socket; return the reply frame and what followed it."""
    server = P_server.protocol.RpcServer()

    async def echo(payload):
        return payload

    server.route("Echo", echo)
    address = server.start()

    async def _drive():
        host, port = address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(P_server.protocol._encode_frame(
            (P_server.protocol._HELLO, 0, "__hello__", {"proto": proto})))
        await writer.drain()
        header = await asyncio.wait_for(reader.readexactly(8), 10)
        frame = pickle.loads(await reader.readexactly(
            int.from_bytes(header, "big")))
        leftovers = await asyncio.wait_for(reader.read(), 10)
        writer.close()
        return frame, leftovers

    try:
        return P_server.protocol.IoThread.get().run_coro(_drive(),
                                                         timeout=30)
    finally:
        server.stop()


def test_version_fence_rejects_mismatched_client(P):
    frame, leftovers = _fence(P, 9999)
    assert frame[0] == P.protocol._GOODBYE, frame
    assert "v9999" in frame[3]["reason"], frame
    assert frame[3]["proto"] == P.protocol.PROTOCOL_VERSION
    assert leftovers == b""                      # the server hung up


def test_version_fence_agrees_across_packages():
    """Both servers answer the same mismatched HELLO with the same
    GOODBYE frame."""
    assert _fence(J, 9999) == _fence(T, 9999)


@pytest.mark.parametrize("server_side,client_side", [(J, T), (T, J), (T, T)],
                         ids=["jax-server", "torch-server", "torch-both"])
def test_matching_versions_talk_normally(server_side, client_side):
    """A client of either package talks to a server of either: the
    handshake and plain frames name no package class."""
    server = server_side.protocol.RpcServer()

    async def echo(payload):
        return payload

    server.route("Echo", echo)
    address = server.start()
    pool = client_side.protocol.ClientPool()
    try:
        assert pool.get(address).call("Echo", {"x": [1, "a"]},
                                      timeout=10) == {"x": [1, "a"]}
    finally:
        pool.close_all()
        server.stop()


# ------------------------------------------ hot frames between packages


def test_hot_call_frames_byte_equal_and_cross_decodable():
    task_id = bytes(range(24))[:len(J.ids.TaskID.for_driver_task(
        J.ids.JobID.from_random())._bytes)]
    for trace in (None, ("t" * 32, "s" * 16, True)):
        jspec = _task_spec(J, task_id, b"payload" * 9, trace)
        tspec = _task_spec(T, task_id, b"payload" * 9, trace)
        jkey, tkey = (J.hotframe.template_key(jspec),
                      T.hotframe.template_key(tspec))
        assert jkey == tkey is not None
        jtmpl = J.hotframe.encode_template(7, jspec)
        ttmpl = T.hotframe.encode_template(7, tspec)
        assert jtmpl == ttmpl
        jcall = J.hotframe.encode_call(7, jspec, 4242)
        tcall = T.hotframe.encode_call(7, tspec, 4242)
        assert jcall == tcall
        # Read by the other package.
        table = dict([T.hotframe.decode_template(jtmpl)])
        msg_id, out = T.hotframe.decode_call(jcall, table)
        assert msg_id == 4242 and isinstance(out, T.specs.TaskSpec)
        for f in dataclasses.fields(T.specs.TaskSpec):
            got, want = getattr(out, f.name), getattr(tspec, f.name)
            if f.name == "task_id":
                assert got._bytes == want._bytes
            else:
                assert got == want, f.name
        table = dict([J.hotframe.decode_template(ttmpl)])
        _msg, back = J.hotframe.decode_call(tcall, table)
        assert back.task_id._bytes == task_id


def test_actor_template_names_its_package_and_calls_still_match():
    """An actor call's template pickles its ActorID, a class of one
    package, so templates differ by that name; the call frames (ids as
    bytes) stay byte-equal."""
    raw = os.urandom(len(J.ids.ActorID.of(J.ids.JobID.from_random())._bytes))
    jaid, taid = J.ids.ActorID(raw), T.ids.ActorID(raw)
    jspec = _actor_spec(J, seq=3, actor_id=jaid,
                        task_id=J.ids.TaskID(b"\x01" * len(
                            J.ids.TaskID.for_actor_task(jaid)._bytes)))
    tspec = _actor_spec(T, seq=3, actor_id=taid,
                        task_id=T.ids.TaskID(jspec.task_id._bytes))
    assert b"ant_ray_tpu_torch" in T.hotframe.encode_template(1, tspec)
    assert b"ant_ray_tpu_torch" not in J.hotframe.encode_template(1, jspec)
    assert J.hotframe.encode_call(1, jspec, 9) == \
        T.hotframe.encode_call(1, tspec, 9)


def test_ack_frames_byte_equal_and_cross_decodable():
    reply = {"returns": [("inline", b"abc"), ("plasma", 1 << 33),
                         ("error", b"errpayload"),
                         ("stream_end", (7, None)),
                         ("stream_end", (2, b"late-error"))]}
    jframe = J.hotframe.frame_acks([J.hotframe.encode_ack(5, reply)])
    tframe = T.hotframe.frame_acks([T.hotframe.encode_ack(5, reply)])
    assert jframe == tframe
    assert T.hotframe.decode_acks(jframe) == J.hotframe.decode_acks(tframe) \
        == [(5, reply, False)]


# ------------------------------------------------- tests/test_hot_wire


def test_template_key_eligibility(P):
    spec = _actor_spec(P)
    key = P.hotframe.template_key(spec)
    assert key is not None
    assert P.hotframe.template_key(_actor_spec(
        P, seq=99, payload=b"other", actor_id=spec.actor_id,
        task_id=P.ids.TaskID.for_actor_task(spec.actor_id))) == key
    assert P.hotframe.template_key(_actor_spec(
        P, runtime_env={"env_vars": {"A": "1"}})) is None
    assert P.hotframe.template_key(_actor_spec(
        P, label_selector={"zone": "a"})) is None
    assert P.hotframe.template_key(_actor_spec(
        P, scheduling_strategy="SPREAD")) is None
    assert P.hotframe.template_key(_actor_spec(
        P, placement_group_id=object())) is None


def test_call_roundtrip_preserves_every_field(P):
    spec = _actor_spec(P, seq=41, payload=b"p" * 257,
                       trace=("t" * 32, "s" * 16, True))
    spec.attempt = 3
    cache = P.hotframe.TemplateCache()
    tid, is_new = cache.intern(P.hotframe.template_key(spec))
    assert is_new
    tid2, fields = P.hotframe.decode_template(
        P.hotframe.encode_template(tid, spec))
    assert tid2 == tid
    msg_id, out = P.hotframe.decode_call(
        P.hotframe.encode_call(tid, spec, 12345), {tid2: fields})
    assert msg_id == 12345
    for f in dataclasses.fields(P.specs.TaskSpec):
        assert getattr(out, f.name) == getattr(spec, f.name), f.name
    assert cache.intern(P.hotframe.template_key(spec)) == (tid, False)


def test_ack_roundtrip_all_return_kinds(P):
    reply = {"returns": [("inline", b"abc"), ("plasma", 1 << 33),
                         ("error", b"errpayload"),
                         ("stream_end", (7, None)),
                         ("stream_end", (2, b"late-error"))]}
    records = [P.hotframe.encode_ack(5, reply),
               P.hotframe.encode_ack_exc(6, ValueError("boom"))]
    acks = P.hotframe.decode_acks(P.hotframe.frame_acks(records))
    assert acks[0] == (5, reply, False)
    msg_id, exc, is_err = acks[1]
    assert msg_id == 6 and is_err and isinstance(exc, ValueError)
    assert str(exc) == "boom"


def test_ack_encode_declines_unknown_shapes(P):
    assert P.hotframe.encode_ack(1, {"other": 1}) is None
    assert P.hotframe.encode_ack(1, "pong") is None
    assert P.hotframe.encode_ack(1, {"returns": [("weird", b"")]}) is None
    assert P.hotframe.encode_ack(1, {"returns": [("plasma", -5)]}) is None
    assert P.hotframe.encode_ack(1, {"returns": [("inline", 123)]}) is None


def test_template_cache_bound_falls_back(P):
    cache = P.hotframe.TemplateCache()
    for i in range(P.hotframe.TemplateCache.MAX_TEMPLATES):
        assert cache.intern(("k", i))[0] is not None
    assert cache.intern(("k", "overflow")) == (None, False)
    assert cache.intern(("k", 0)) == (0, False)


def test_decode_call_unknown_template_carries_msg_id(P):
    body = P.hotframe.encode_call(424242, _actor_spec(P), 77)
    with pytest.raises(P.hotframe.HotFrameError) as ei:
        P.hotframe.decode_call(body, {})
    assert ei.value.msg_id == 77
    assert "template" in str(ei.value)


def test_decode_call_truncated_body(P):
    spec = _actor_spec(P)
    cache = P.hotframe.TemplateCache()
    tid, _ = cache.intern(P.hotframe.template_key(spec))
    table = dict([P.hotframe.decode_template(
        P.hotframe.encode_template(tid, spec))])
    body = P.hotframe.encode_call(tid, spec, 9)
    with pytest.raises(P.hotframe.HotFrameError):
        P.hotframe.decode_call(body[:8], table)
    with pytest.raises(P.hotframe.HotFrameError) as ei:
        P.hotframe.decode_call(body[:20], table)
    assert ei.value.msg_id == 9


def test_decode_acks_truncated_raises(P):
    rec = P.hotframe.encode_ack(3, {"returns": [("inline", b"abcdef")]})
    frame = P.hotframe.frame_acks([rec])
    with pytest.raises(P.hotframe.HotFrameError):
        P.hotframe.decode_acks(frame[:len(frame) - 3])


def _echo_server(P, hot: bool = True):
    server = P.protocol.RpcServer()
    server._hot_enabled = hot

    def push(spec):
        fut = asyncio.get_event_loop().create_future()
        if spec.method_name == "boom":
            fut.set_exception(ValueError("handler exploded"))
        else:
            fut.set_result({"returns": [("inline", spec.args_payload)]})
        return fut

    server.fast_route("PushTask", push)
    server.start()
    return server


def _wait_hot(client, timeout: float = 5) -> None:
    deadline = time.monotonic() + timeout
    while client._hot is None:
        if time.monotonic() > deadline:
            raise AssertionError("hot wire never negotiated")
        time.sleep(0.01)


def test_hot_negotiation_and_batched_acks(P):
    server = _echo_server(P)
    client = P.protocol.RpcClient(server.address)
    try:
        before = dict(P.hotframe.counters)
        assert client.call("PushTask", _actor_spec(P, payload=b"first"),
                           timeout=10) == {"returns": [("inline", b"first")]}
        _wait_hot(client)
        aid = P.ids.ActorID.of(P.ids.JobID.from_random())

        async def burst(n):
            futs = [await client.send_request(
                "PushTask", _actor_spec(P, seq=i, payload=b"%d" % i,
                                        actor_id=aid), defer=True)
                for i in range(n)]
            await client.flush_deferred()
            return [await f for f in futs]

        replies = P.protocol.IoThread.get().run_coro(burst(50))
        assert [r["returns"][0][1] for r in replies] == \
            [b"%d" % i for i in range(50)]
        after = P.hotframe.counters
        assert after["calls_encoded"] - before["calls_encoded"] >= 50
        assert after["acks_decoded"] - before["acks_decoded"] >= 50
        assert after["templates_encoded"] - before["templates_encoded"] <= 2
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("server_side,client_side", [(J, T), (T, J)],
                         ids=["jax-server", "torch-server"])
def test_hot_wire_across_packages(server_side, client_side):
    """A client of one package negotiates the hot wire with a server of
    the other and gets the same replies: the call frames name no class,
    and a plain task's template neither."""
    server = _echo_server(server_side)
    client = client_side.protocol.RpcClient(server.address)
    try:
        raw = os.urandom(len(client_side.ids.TaskID.for_driver_task(
            client_side.ids.JobID.from_random())._bytes))
        first = _task_spec(client_side, raw, b"first")
        assert client.call("PushTask", first, timeout=10) == \
            {"returns": [("inline", b"first")]}
        _wait_hot(client)
        got = [client.call("PushTask", _task_spec(client_side, raw, b"%d" % i),
                           timeout=10)["returns"][0][1] for i in range(8)]
        assert got == [b"%d" % i for i in range(8)]
    finally:
        client.close()
        server.stop()


def test_old_server_negotiates_down_byte_identical(P):
    old = _echo_server(P, hot=False)
    new = _echo_server(P, hot=True)
    c_old = P.protocol.RpcClient(old.address)
    c_new = P.protocol.RpcClient(new.address)
    try:
        before = dict(P.hotframe.counters)
        specs = [_actor_spec(P, seq=i, payload=b"p%d" % i) for i in range(8)]
        got_old = [c_old.call("PushTask", s, timeout=10) for s in specs]
        assert c_old._hot is None
        assert P.hotframe.counters["calls_encoded"] == \
            before["calls_encoded"]
        c_new.call("PushTask", _actor_spec(P), timeout=10)
        _wait_hot(c_new)
        got_new = [c_new.call("PushTask", s, timeout=10) for s in specs]
        assert got_old == got_new
        for client in (c_old, c_new):
            with pytest.raises(ValueError, match="handler exploded"):
                client.call("PushTask", _actor_spec(P, method_name="boom"),
                            timeout=10)
    finally:
        c_old.close()
        c_new.close()
        old.stop()
        new.stop()


def test_old_client_against_new_server(P, monkeypatch):
    server = _echo_server(P, hot=True)
    monkeypatch.setattr(P.config.global_config(), "hot_wire_enabled", False)
    client = P.protocol.RpcClient(server.address)
    try:
        assert client.call("PushTask", _actor_spec(P, payload=b"plain"),
                           timeout=10) == {"returns": [("inline", b"plain")]}
        time.sleep(0.1)
        assert client._hot is None
    finally:
        client.close()
        server.stop()


def test_ineligible_spec_falls_back_per_call(P):
    server = _echo_server(P)
    client = P.protocol.RpcClient(server.address)
    try:
        client.call("PushTask", _actor_spec(P), timeout=10)
        _wait_hot(client)
        before = dict(P.hotframe.counters)
        cold = _actor_spec(P, runtime_env={"env_vars": {"A": "1"}},
                           payload=b"cold")
        assert client.call("PushTask", cold,
                           timeout=10)["returns"][0][1] == b"cold"
        assert P.hotframe.counters["calls_encoded"] == \
            before["calls_encoded"]
        assert P.hotframe.counters["fallback_ineligible"] > \
            before["fallback_ineligible"]
    finally:
        client.close()
        server.stop()


def test_oversized_template_id_gets_error_ack_and_connection_survives(P):
    server = _echo_server(P)
    client = P.protocol.RpcClient(server.address)
    try:
        client.call("PushTask", _actor_spec(P), timeout=10)
        _wait_hot(client)

        async def forged():
            msg_id = next(P.protocol.RpcClient._counter)
            fut = asyncio.get_running_loop().create_future()
            client._pending[msg_id] = fut
            body = P.hotframe.encode_call(40000, _actor_spec(P), msg_id)
            await client._write_frame(P.protocol._encode_hot_frame(body))
            return await asyncio.wait_for(fut, 10)

        with pytest.raises(P.protocol.RpcError, match="template"):
            P.protocol.IoThread.get().run_coro(forged())
        assert client.call("PushTask", _actor_spec(P, payload=b"after"),
                           timeout=10) == {"returns": [("inline", b"after")]}
    finally:
        client.close()
        server.stop()


def test_truncated_hot_frame_is_dropped_not_fatal(P):
    server = _echo_server(P)
    client = P.protocol.RpcClient(server.address)
    try:
        client.call("PushTask", _actor_spec(P), timeout=10)
        _wait_hot(client)

        async def garbage():
            await client._write_frame(P.protocol._encode_hot_frame(
                bytes([P.hotframe.HOT_CALL]) + b"\x01"))
            await client._write_frame(
                P.protocol._encode_hot_frame(b"\xee junk"))

        P.protocol.IoThread.get().run_coro(garbage())
        assert client.call("PushTask", _actor_spec(P, payload=b"alive"),
                           timeout=10) == {"returns": [("inline", b"alive")]}
    finally:
        client.close()
        server.stop()


def test_corrupt_ack_frame_fails_pending_calls_not_hangs(P, monkeypatch):
    server = _echo_server(P)
    client = P.protocol.RpcClient(server.address)
    try:
        client.call("PushTask", _actor_spec(P, payload=b"warm"), timeout=10)
        _wait_hot(client)
        real = P.hotframe.frame_acks
        monkeypatch.setattr(P.hotframe, "frame_acks",
                            lambda records: real(records)[:-2])
        t0 = time.monotonic()
        with pytest.raises(P.protocol.RpcError, match="undecodable hot ack"):
            client.call("PushTask", _actor_spec(P, seq=1, payload=b"torn"),
                        timeout=10)
        assert time.monotonic() - t0 < 5
        monkeypatch.setattr(P.hotframe, "frame_acks", real)
        assert client.call("PushTask", _actor_spec(P, seq=2, payload=b"back"),
                           timeout=10) == {"returns": [("inline", b"back")]}
    finally:
        client.close()
        server.stop()


def test_reconnect_invalidates_template_cache(P):
    server = _echo_server(P)
    client = P.protocol.RpcClient(server.address)
    try:
        client.call("PushTask", _actor_spec(P, payload=b"one"), timeout=10)
        _wait_hot(client)
        first_hot = client._hot
        client.call("PushTask", _actor_spec(P, payload=b"two"), timeout=10)
        before = dict(P.hotframe.counters)
        client.close()
        client._closed = False
        assert client.call("PushTask", _actor_spec(P, payload=b"three"),
                           timeout=10) == {"returns": [("inline", b"three")]}
        _wait_hot(client)
        deadline = time.monotonic() + 5
        while client._hot is first_hot and time.monotonic() < deadline:
            time.sleep(0.01)
        assert client._hot is not first_hot
        client.call("PushTask", _actor_spec(P, payload=b"four"), timeout=10)
        assert P.hotframe.counters["templates_encoded"] > \
            before["templates_encoded"]
    finally:
        client.close()
        server.stop()


def _exercise_cluster(art):
    @art.remote
    class Echo:
        def ping(self, x=None):
            return x

        def gen(self, n):
            for i in range(n):
                yield i * 10

        def boom(self):
            raise ValueError("kaboom")

    @art.remote
    def add(a, b):
        return a + b

    a = Echo.remote()
    out = {
        "sync": [art.get(a.ping.remote(i)) for i in range(3)],
        "async": art.get([a.ping.remote(i) for i in range(40)]),
        "tasks": art.get([add.remote(i, 1) for i in range(20)]),
        "stream": [art.get(r) for r in
                   a.gen.options(num_returns="streaming").remote(4)],
    }
    try:
        art.get(a.boom.remote())
        out["error"] = None
    except Exception as e:  # noqa: BLE001
        out["error"] = (type(e).__name__, "kaboom" in str(e))
    return out


@pytest.mark.parametrize("hot", [True, False], ids=["hot", "pickled"])
def test_cluster_end_to_end_identical_across_wire_modes(P, hot):
    """The same workload over the hot wire and over the pickled wire
    gives the same results in either package (one package's cluster at
    a time: ``_system_config`` reaches the processes as ART_* variables
    both read)."""
    P.art.init(num_cpus=2, _system_config={"hot_wire_enabled": hot})
    try:
        got = _exercise_cluster(P.art)
    finally:
        P.art.shutdown()
    assert "ART_HOT_WIRE_ENABLED" not in os.environ
    assert got == {
        "sync": [0, 1, 2],
        "async": list(range(40)),
        "tasks": [i + 1 for i in range(20)],
        "stream": [0, 10, 20, 30],
        "error": ("ActorError", True),
    }


def test_cancel_queued_actor_call_over_hot_wire(P):
    art = P.art
    art.init(num_cpus=1)
    try:
        @art.remote
        class Slow:
            def block(self, s):
                time.sleep(s)
                return "done"

            def quick(self):
                return "q"

        a = Slow.remote()
        art.get(a.quick.remote())
        blocker = a.block.remote(2.0)
        victim = a.block.remote(0.0)
        art.cancel(victim)
        with pytest.raises(art.exceptions.TaskCancelledError):
            art.get(victim, timeout=30)
        assert art.get(blocker, timeout=30) == "done"
    finally:
        art.shutdown()


def test_lease_worker_count_grants_extras_from_idle_pool(P):
    art = P.art
    art.init(num_cpus=2)
    try:
        @art.remote
        def warm():
            time.sleep(0.2)
            return True

        assert art.get([warm.remote(), warm.remote()]) == [True, True]
        rt = importlib.import_module(
            f"{art.__name__}._private.worker").global_worker.runtime
        deadline = time.monotonic() + 10
        reply = None
        while time.monotonic() < deadline:
            reply = rt._node.call(
                "LeaseWorker",
                {"resources": {"CPU": 1}, "job_id": rt.job_id,
                 "owner": rt.address, "count": 2}, timeout=30)
            if reply.get("extra"):
                break
            if "granted" in reply:
                rt._node.call("ReturnWorker",
                              {"worker_id": reply["worker_id"]}, timeout=10)
            time.sleep(0.1)
        assert reply and reply.get("granted") and reply.get("extra"), reply
        assert len(reply["extra"]) == 1
        for grant in (reply, *reply["extra"]):
            rt._node.call("ReturnWorker",
                          {"worker_id": grant["worker_id"]}, timeout=10)
        classic = rt._node.call(
            "LeaseWorker", {"resources": {"CPU": 1}, "job_id": rt.job_id,
                            "owner": rt.address}, timeout=30)
        assert "extra" not in classic
        rt._node.call("ReturnWorker",
                      {"worker_id": classic["worker_id"]}, timeout=10)
    finally:
        art.shutdown()


def test_burst_through_batched_leases_completes(P):
    art = P.art
    art.init(num_cpus=2)
    try:
        @art.remote
        def sq(x):
            return x * x

        for _round in range(3):
            assert art.get([sq.remote(i) for i in range(60)]) == \
                [i * i for i in range(60)]
    finally:
        art.shutdown()


def test_gcs_router_single_replica_fast_path(P):
    server = P.protocol.RpcServer()

    async def kv(payload):
        return b"value"

    server.route("KVGet", kv)
    addr = server.start()
    pool = P.protocol.ClientPool()
    try:
        solo = P.gcs_client.GcsRouter(addr, pool)
        assert solo._solo == addr
        assert solo.call("KVGet", {"key": "k"}, timeout=10) == b"value"
        assert solo._solo_client is pool.get(addr)
        multi = P.gcs_client.GcsRouter(addr + "," + addr.replace(
            addr.rsplit(":", 1)[1], "1"), pool)
        assert multi._solo is None
    finally:
        pool.close_all()
        server.stop()
