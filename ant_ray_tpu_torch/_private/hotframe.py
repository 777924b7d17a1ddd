"""Hot-frame codec: the zero-pickle wire format for the PushTask path.

The pickled tuple frames in protocol.py are a fine general transport,
but at 10k+ actor calls/s the per-call cost is dominated by framing,
not compute: every ``pickle.dumps(TaskSpec)`` re-encodes ~15 invariant
fields (function name, owner address, retry policy, ...) and copies
``args_payload`` through the pickle buffer, and every reply is its own
pickled frame.  The reference system pays for its direct actor-call
plane with compact protobuf frames (ref: PushTaskRequest,
src/ray/protobuf/core_worker.proto) — this module is that idea for the
pickle transport:

* **templates** — the invariant ``TaskSpec`` fields per (actor, method)
  / (function, options) are interned ONCE per connection into a small
  header-template cache (:class:`TemplateCache` sender-side, a plain
  ``dict`` receiver-side) and referenced by a u32 id afterwards;
* **calls** — each call ships only the varying fields (task-id,
  sequence number, attempt, optional trace context) as a fixed struct
  pack, with ``args_payload`` riding as the raw frame tail — the bytes
  never round-trip through pickle;
* **acks** — replies are fixed-layout records that BATCH: one hot-ack
  frame carries every reply that completed in the same io-loop tick
  (see RpcServer's coalesced ack flush).

Negotiation is additive within ``protocol.PROTOCOL_VERSION``: the
client's HELLO advertises ``hot=HOT_WIRE_VERSION``; a server that
understands it replies a HELLO-ack and only then does the client emit
hot frames.  An old peer on either side never advertises / never acks,
so traffic transparently stays on the pickled path — no flag-day (the
mixed-version interop tests in tests/test_hot_wire.py pin this).

Evolution policy (enforced by artlint's frame-schema drift checker
against the committed ``_lint/wire_frames.json`` snapshot): frame-kind
values and flag bits are FROZEN, and the two field tables below are
append-only — renaming, removing, or reordering an entry breaks peers
that negotiated the same hot version, so it fails lint loudly.

Pickle appears here only in the blessed helpers (template bodies, the
rare sampled trace context, exception acks) — never on the per-call
byte path; artlint's ``pickle-in-hot-path`` rule keeps it that way.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any

from ant_ray_tpu_torch._private.ids import TaskID
from ant_ray_tpu_torch._private.specs import TaskSpec

#: Hot-wire feature version advertised in the HELLO handshake.  Bump on
#: any non-additive change to the layouts below; peers negotiate
#: ``min(theirs, ours)`` and a version-0 peer simply stays pickled.
HOT_WIRE_VERSION = 1

# Hot-frame body kinds (first byte of a _HOT_FLAG frame body).  Values
# are wire contract — frozen by the frame-schema snapshot.
HOT_TEMPLATE = 1          # u32 template id + pickled invariant fields
HOT_CALL = 2              # one PushTask: varying fields + raw payload
HOT_ACKS = 3              # 1..N concatenated reply records

#: Invariant TaskSpec fields carried by a template, in wire order
#: (append-only; the artlint snapshot pins order AND membership).
TEMPLATE_FIELDS = (
    "function_id", "function_name", "num_returns", "owner_address",
    "resources", "max_retries", "retry_exceptions", "actor_id",
    "method_name", "concurrency_group",
)

#: Varying fields each HOT_CALL carries, in wire order (append-only).
CALL_FIELDS = ("task_id", "sequence_no", "attempt", "trace_ctx",
               "args_payload")

# Struct layouts for the fixed parts of a call / ack record.
_CALL_HEAD = struct.Struct("!QIB")      # msg_id, template_id, id_len
_CALL_VARY = struct.Struct("!qIB")      # sequence_no, attempt, flags
_ACK_HEAD = struct.Struct("!QB")        # msg_id, status
_U16 = struct.Struct("!H")
_U32 = struct.Struct("!I")
_U64 = struct.Struct("!Q")

_FLAG_TRACE = 1

# Reply return-kind codes (wire contract, frozen like the frame kinds).
_RET_INLINE, _RET_PLASMA, _RET_ERROR, _RET_STREAM_END = 0, 1, 2, 3
_RET_CODES = {"inline": _RET_INLINE, "plasma": _RET_PLASMA,
              "error": _RET_ERROR, "stream_end": _RET_STREAM_END}
_RET_NAMES = {v: k for k, v in _RET_CODES.items()}

_ACK_OK, _ACK_EXC = 0, 1

#: Live codec counters (GIL-atomic int bumps): cheap observability for
#: tests and the node transfer-stats surface — proving a path really
#: ran hot beats inferring it from throughput.
counters = {"templates_encoded": 0, "calls_encoded": 0,
            "calls_decoded": 0, "acks_encoded": 0, "acks_decoded": 0,
            "fallback_ineligible": 0, "fallback_cache_full": 0}


class HotFrameError(Exception):
    """A hot frame could not be decoded (truncated body, unknown or
    oversized template id, bad kind byte).  Carries ``msg_id`` when the
    header parsed far enough to know which call to fail — the server
    then acks that call with the error instead of dropping it."""

    def __init__(self, message: str, msg_id: int | None = None):
        super().__init__(message)
        self.msg_id = msg_id


# ------------------------------------------------------------- templates

def template_key(spec: TaskSpec) -> tuple | None:
    """Hashable interning key over the invariant fields, or None when
    the spec is not hot-eligible.  Eligibility is deliberately the
    plain-call shape (no placement group, runtime env, label selector,
    or scheduling strategy): those specs are rare, cold, and carry
    arbitrary nested dicts — they stay on the pickled path."""
    if (spec.placement_group_id is not None or spec.runtime_env
            or spec.label_selector or spec.scheduling_strategy
            or not isinstance(spec.args_payload, (bytes, bytearray,
                                                  memoryview))):
        return None
    try:
        return (spec.function_id, spec.function_name, spec.num_returns,
                spec.owner_address,
                tuple(sorted(spec.resources.items())),
                spec.max_retries, spec.retry_exceptions, spec.actor_id,
                spec.method_name, spec.concurrency_group)
    except TypeError:       # unhashable oddball (custom resources etc.)
        return None


class TemplateCache:
    """Sender-side template interner, one per CONNECTION — the ids are
    meaningless to any other peer, so the owner (RpcClient) discards
    the cache whenever the connection turns over and re-interns against
    the fresh one (the receiver's table died with the old socket)."""

    # Bound: past this the sender stops interning NEW templates (calls
    # fall back to pickled frames) instead of growing without limit or
    # evicting ids the receiver still remembers.
    MAX_TEMPLATES = 1024

    __slots__ = ("_ids",)

    def __init__(self):
        self._ids: dict[tuple, int] = {}

    def intern(self, key: tuple) -> tuple[int | None, bool]:
        """-> (template_id | None when full, is_new)."""
        tid = self._ids.get(key)
        if tid is not None:
            return tid, False
        if len(self._ids) >= self.MAX_TEMPLATES:
            return None, False
        tid = len(self._ids)
        self._ids[key] = tid
        return tid, True


def encode_template(tid: int, spec: TaskSpec) -> bytes:
    """HOT_TEMPLATE body: the invariant fields travel pickled — a
    template is sent once per (connection, call shape), so its encoding
    cost is irrelevant and pickle handles the dict-valued fields."""
    fields = pickle.dumps(
        (spec.function_id, spec.function_name, spec.num_returns,
         spec.owner_address, spec.resources, spec.max_retries,
         spec.retry_exceptions, spec.actor_id, spec.method_name,
         spec.concurrency_group), protocol=5)
    counters["templates_encoded"] += 1
    return b"%c%s%s" % (HOT_TEMPLATE, _U32.pack(tid), fields)


def decode_template(body) -> tuple[int, tuple]:
    """-> (template_id, invariant-field tuple) from a HOT_TEMPLATE body
    (kind byte included)."""
    try:
        tid, = _U32.unpack_from(body, 1)
        fields = pickle.loads(bytes(body[5:]))
    except (struct.error, pickle.UnpicklingError, EOFError,
            ValueError) as e:
        raise HotFrameError(f"bad template frame: {e!r}") from e
    if not isinstance(fields, tuple) or len(fields) < len(TEMPLATE_FIELDS):
        raise HotFrameError("template field tuple malformed")
    return tid, fields


# ------------------------------------------------------------------ calls

def encode_call(tid: int, spec: TaskSpec, msg_id: int) -> bytes:
    """HOT_CALL body: fixed struct head + varying fields, with
    ``args_payload`` as the raw tail (never pickled, single copy into
    the frame join)."""
    task_id = spec.task_id._bytes
    trace = spec.trace_ctx
    if trace is not None:
        tbytes = pickle.dumps(trace, protocol=5)
        vary = _CALL_VARY.pack(spec.sequence_no, spec.attempt,
                               _FLAG_TRACE) + _U16.pack(len(tbytes)) \
            + tbytes
    else:
        vary = _CALL_VARY.pack(spec.sequence_no, spec.attempt, 0)
    counters["calls_encoded"] += 1
    return b"%c%s%s%s%s" % (
        HOT_CALL, _CALL_HEAD.pack(msg_id, tid, len(task_id)), task_id,
        vary, spec.args_payload)


def decode_call(body, templates: dict) -> tuple[int, TaskSpec]:
    """-> (msg_id, TaskSpec) from a HOT_CALL body (kind byte included),
    resolving the template against the receiver's per-connection table.
    Raises :class:`HotFrameError` (with msg_id when parseable) on a
    truncated body or a template id the table does not know — a
    reconnected peer re-sends templates, so an unknown id means a
    protocol bug or a forged frame, never a wait-and-see."""
    try:
        msg_id, tid, id_len = _CALL_HEAD.unpack_from(body, 1)
    except struct.error as e:
        raise HotFrameError(f"truncated call head: {e!r}") from e
    tmpl = templates.get(tid)
    if tmpl is None:
        raise HotFrameError(
            f"unknown hot template id {tid} (have "
            f"{len(templates)}) — stale or oversized template ref",
            msg_id=msg_id)
    off = 1 + _CALL_HEAD.size
    try:
        task_id = bytes(body[off:off + id_len])
        if len(task_id) != id_len:
            raise HotFrameError("truncated task id", msg_id=msg_id)
        off += id_len
        sequence_no, attempt, flags = _CALL_VARY.unpack_from(body, off)
        off += _CALL_VARY.size
        trace_ctx = None
        if flags & _FLAG_TRACE:
            tlen, = _U16.unpack_from(body, off)
            off += _U16.size
            trace_ctx = pickle.loads(bytes(body[off:off + tlen]))
            off += tlen
    except (struct.error, pickle.UnpicklingError, EOFError,
            ValueError) as e:
        raise HotFrameError(f"truncated call body: {e!r}",
                            msg_id=msg_id) from e
    counters["calls_decoded"] += 1
    # bytes(), not a view: the spec outlives the read buffer (executor
    # queue) and must survive a pickled re-push on the retry path.
    payload = bytes(body[off:])
    return msg_id, TaskSpec(
        task_id=TaskID(task_id),
        function_id=tmpl[0], function_name=tmpl[1],
        args_payload=payload, num_returns=tmpl[2],
        owner_address=tmpl[3], resources=dict(tmpl[4]),
        max_retries=tmpl[5], retry_exceptions=tmpl[6],
        actor_id=tmpl[7], method_name=tmpl[8],
        sequence_no=sequence_no, concurrency_group=tmpl[9],
        trace_ctx=trace_ctx, attempt=attempt)


# ------------------------------------------------------------------- acks

def _pack_blob(out: list, data) -> bool:
    if isinstance(data, (bytes, bytearray, memoryview)):
        out.append(_U32.pack(len(data)))
        out.append(bytes(data) if not isinstance(data, bytes) else data)
        return True
    return False


def encode_ack(msg_id: int, reply: Any) -> bytes | None:
    """One reply record for the batched ack frame, or None when the
    reply is not the known PushTask shape (the caller then falls back
    to a pickled reply frame for just that call — mixing is fine, the
    client resolves futures by msg_id either way)."""
    returns = reply.get("returns") if isinstance(reply, dict) else None
    if not isinstance(returns, list) or len(reply) != 1 \
            or len(returns) > 0xFFFF:
        return None
    out = [_ACK_HEAD.pack(msg_id, _ACK_OK), _U16.pack(len(returns))]
    for entry in returns:
        kind, data = entry
        code = _RET_CODES.get(kind)
        if code is None:
            return None
        out.append(b"%c" % code)
        if code in (_RET_INLINE, _RET_ERROR):
            if not _pack_blob(out, data):
                return None
        elif code == _RET_PLASMA:
            if not isinstance(data, int) or data < 0:
                return None
            out.append(_U64.pack(data))
        else:                                    # stream_end
            count, err_payload = data
            out.append(_U32.pack(count))
            if err_payload is None:
                out.append(b"\x00")
            else:
                out.append(b"\x01")
                if not _pack_blob(out, err_payload):
                    return None
    counters["acks_encoded"] += 1
    return b"".join(out)


def encode_ack_exc(msg_id: int, exc: BaseException) -> bytes:
    """Exception reply record (handler raised instead of returning)."""
    try:
        blob = pickle.dumps(exc, protocol=5)
    except Exception:  # noqa: BLE001 — unpicklable error payload
        from ant_ray_tpu_torch._private.protocol import RpcError  # noqa: PLC0415

        blob = pickle.dumps(RpcError(repr(exc)), protocol=5)
    counters["acks_encoded"] += 1
    return _ACK_HEAD.pack(msg_id, _ACK_EXC) + _U32.pack(len(blob)) + blob


def frame_acks(records: list[bytes]) -> bytes:
    """HOT_ACKS body: the coalesced flush — one frame, N acks."""
    return b"%c%s" % (HOT_ACKS, b"".join(records))


def decode_acks(body) -> list[tuple[int, Any, bool]]:
    """-> [(msg_id, reply-or-exception, is_exception)] from a HOT_ACKS
    body (kind byte included).  Raises HotFrameError on truncation —
    an undecodable ack frame is a dead connection, not a skippable
    record (later records' boundaries are unknown)."""
    out: list[tuple[int, Any, bool]] = []
    view = memoryview(body) if not isinstance(body, memoryview) else body
    off = 1
    end = len(view)
    try:
        while off < end:
            msg_id, status = _ACK_HEAD.unpack_from(view, off)
            off += _ACK_HEAD.size
            if status == _ACK_EXC:
                blen, = _U32.unpack_from(view, off)
                off += _U32.size
                exc = pickle.loads(bytes(view[off:off + blen]))
                off += blen
                out.append((msg_id, exc, True))
                continue
            n_returns, = _U16.unpack_from(view, off)
            off += _U16.size
            returns = []
            for _ in range(n_returns):
                code = view[off]
                off += 1
                if code in (_RET_INLINE, _RET_ERROR):
                    blen, = _U32.unpack_from(view, off)
                    off += _U32.size
                    data: Any = bytes(view[off:off + blen])
                    if len(data) != blen:
                        raise HotFrameError("truncated ack blob")
                    off += blen
                elif code == _RET_PLASMA:
                    data, = _U64.unpack_from(view, off)
                    off += _U64.size
                elif code == _RET_STREAM_END:
                    count, = _U32.unpack_from(view, off)
                    off += _U32.size
                    has_err = view[off]
                    off += 1
                    err_payload = None
                    if has_err:
                        blen, = _U32.unpack_from(view, off)
                        off += _U32.size
                        err_payload = bytes(view[off:off + blen])
                        off += blen
                    data = (count, err_payload)
                else:
                    raise HotFrameError(f"bad return kind code {code}")
                returns.append((_RET_NAMES[code], data))
            out.append((msg_id, {"returns": returns}, False))
    except (struct.error, IndexError, pickle.UnpicklingError,
            EOFError) as e:
        raise HotFrameError(f"truncated ack frame: {e!r}") from e
    counters["acks_decoded"] += len(out)
    return out
