"""The project-specific checkers.  Each rule encodes a bug class this
repo has already shipped once — the ``prevents`` string names it.

Heuristics over proofs: these are AST pattern matchers, not a type
system.  A rule that cries wolf gets suppressed into uselessness, so
every matcher is written to UNDER-match (e.g. ``.call()`` is only a
blocking RPC when the receiver is named like a client) and deliberate
sites carry ``# artlint: disable=<rule> — <why>`` rationale comments.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Iterable

from ant_ray_tpu_torch._lint.framework import (
    Checker,
    Finding,
    ProjectChecker,
)

# ------------------------------------------------------------ shared bits

#: Attribute calls that park the calling thread on I/O or a subprocess.
_SOCKET_BLOCKING_ATTRS = {"sendall", "recv", "recv_into", "recvfrom",
                          "recvmsg"}
#: ``send`` blocks too, but only flag it on receivers that are plainly
#: sockets/collectives — ``generator.send`` is everywhere and harmless.
_SEND_BASES = {"sock", "socket", "conn", "col"}
_SUBPROCESS_FNS = {"run", "call", "check_call", "check_output", "Popen"}
#: Receiver names that mark ``.call()`` as a synchronous RPC.
_RPC_BASES = {"gcs", "rpc"}
_LOCKISH_RE = re.compile(r"lock|mutex|cond|_cv$", re.IGNORECASE)


def _terminal_name(node: ast.AST) -> str:
    """The rightmost identifier of a Name/Attribute/Call chain:
    ``self._chunk_cache_lock`` -> ``_chunk_cache_lock``,
    ``_pair_lock(g, s)`` -> ``_pair_lock``."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _base_name(func: ast.Attribute) -> str:
    """The terminal name of an attribute call's receiver:
    ``runtime._clients.get`` -> ``_clients``, ``time.sleep`` -> ``time``."""
    return _terminal_name(func.value)


def _is_lockish(expr: ast.AST) -> bool:
    return bool(_LOCKISH_RE.search(_terminal_name(expr)))


class _StmtTracker(ast.NodeVisitor):
    """NodeVisitor that remembers the innermost enclosing statement.
    Findings anchor there: that is the line a fix edits and the line a
    ``# artlint: disable`` comment block sits above (a directive above
    a multi-line statement must suppress a match on a continuation
    line)."""

    def __init__(self):
        self._stmt: ast.stmt | None = None

    def visit(self, node):
        if isinstance(node, ast.stmt):
            self._stmt = node
        return super().visit(node)

    def anchor(self, node: ast.AST) -> ast.AST:
        return self._stmt if self._stmt is not None else node

    def stmt_header_span(self, node: ast.AST) -> tuple[int, int]:
        """(start, end) lines of the enclosing statement's HEADER: for
        a compound statement (If/While/With/...) the span stops before
        the first body statement — `if time.time() - t > 60:` must not
        be exempted by what its body happens to mention."""
        stmt = self.anchor(node)
        start = stmt.lineno
        body = getattr(stmt, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.stmt):
            return start, max(start, body[0].lineno - 1)
        return start, getattr(stmt, "end_lineno", start) or start


def _blocking_call(node: ast.Call) -> str | None:
    """Why this call blocks the thread, or None.  The deny-list mirrors
    the repo's real blocking surface: time.sleep, socket I/O,
    subprocess, sync RpcClient.call, concurrent.futures ``result()``."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    attr, base = func.attr, _base_name(func)
    base_l = base.lower()
    if attr == "sleep" and base == "time":
        return "time.sleep() parks the thread"
    if attr in _SOCKET_BLOCKING_ATTRS:
        return f"socket .{attr}() blocks on the wire"
    if attr == "send" and base_l in _SEND_BASES:
        return f"{base}.send() blocks on the wire"
    if base == "subprocess" and attr in _SUBPROCESS_FNS:
        return f"subprocess.{attr}() blocks on a child process"
    if attr == "call" and ("client" in base_l or base_l in _RPC_BASES):
        return (f"sync RPC {base}.call() blocks on a round trip "
                "(use call_async / oneway)")
    if attr == "result" and len(node.args) <= 1 and not node.keywords:
        return "future .result() parks the thread on remote completion"
    return None


# -------------------------------------------------------------- checkers

class BlockingUnderLockChecker(Checker):
    """Blocking calls inside ``with <lock>:`` bodies serialize every
    contender behind one I/O round trip — the whole plane stalls, not
    one caller.

    DELIBERATE over-match: nested ``def``s inside the critical section
    are scanned too (unlike blocking-in-async, which exempts them).
    The historical bug this rule encodes lived in exactly such a
    helper — ``_recv_all`` defined under the tensor-transport pair
    lock and executed while it was held.  A callback that is defined
    under a lock but genuinely invoked lock-free carries a rationale
    suppression instead."""

    rule = "blocking-under-lock"
    prevents = ("ADVICE round 5: blocking col.send() under a "
                "module-global lock serialized all tensor transfers")
    scope = ("ant_ray_tpu_torch/_private/",
             "ant_ray_tpu_torch/experimental/",
             "ant_ray_tpu_torch/util/collective/")

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        checker = self
        findings: list[Finding] = []

        class V(_StmtTracker):
            def __init__(self):
                super().__init__()
                self.lock_depth = 0

            def visit_With(self, node: ast.With):
                held = any(_is_lockish(i.context_expr)
                           for i in node.items)
                self.lock_depth += held
                self.generic_visit(node)
                self.lock_depth -= held

            def visit_Call(self, node: ast.Call):
                if self.lock_depth:
                    why = _blocking_call(node)
                    if why:
                        findings.append(checker.finding(
                            rel_path, self.anchor(node),
                            f"{why} while a lock is held — move the "
                            "blocking work outside the critical "
                            "section (snapshot under the lock, then "
                            "do I/O)", lines))
                self.generic_visit(node)

        V().visit(tree)
        return findings


class BlockingInAsyncChecker(Checker):
    """The same blocking set inside ``async def`` parks the whole event
    loop: every coroutine sharing it stalls, heartbeats included."""

    rule = "blocking-in-async"
    prevents = ("daemon-plane review: one sync RPC on the io loop "
                "freezes every in-flight request on that process")

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        checker = self
        findings: list[Finding] = []

        class V(_StmtTracker):
            def __init__(self):
                super().__init__()
                self.async_depth = 0

            def visit_AsyncFunctionDef(self, node):
                self.async_depth += 1
                self.generic_visit(node)
                self.async_depth -= 1

            def visit_FunctionDef(self, node):
                # A nested sync def runs wherever it is CALLED (often a
                # thread-pool executor) — not on the loop.
                saved, self.async_depth = self.async_depth, 0
                self.generic_visit(node)
                self.async_depth = saved

            visit_Lambda = visit_FunctionDef

            def visit_Call(self, node: ast.Call):
                if self.async_depth:
                    why = _blocking_call(node)
                    if why:
                        findings.append(checker.finding(
                            rel_path, self.anchor(node),
                            f"{why} inside async def — this parks the "
                            "event loop; await the async variant or "
                            "run_in_executor", lines))
                self.generic_visit(node)

        V().visit(tree)
        return findings


class BannedApisChecker(Checker):
    """APIs with a strictly-better project-native replacement.

    * ``asyncio.iscoroutine`` → ``inspect.iscoroutine``: on py<3.12 the
      asyncio variant also matches plain generators, which fed streaming
      tasks' generators to the event loop ("Task got bad yield" — the
      root cause of 8 tier-1 failures at once).
    * ``time.time()`` in duration/deadline arithmetic →
      ``time.monotonic()``: wall clock steps under NTP correction, so
      intervals computed from it can go negative or jump hours.
      Cross-process wire fields are the sanctioned exception — wall
      clock is the only clock two hosts share.  Statements mentioning
      ``deadline_ts`` (the wire-deadline naming convention) are
      allowlisted automatically; other deliberate sites carry a
      ``# artlint: disable=banned-apis — <why>`` rationale.
    * bare ``asyncio.ensure_future(...)`` (result discarded, or the
      function passed as a callback) in ``_private/`` →
      ``protocol._spawn``: the event loop keeps only a WEAK reference
      to tasks, so a fire-and-forget task with no strong ref can be
      garbage-collected mid-flight and silently never finish (the
      actor-sender restart path would strand a whole actor's queue).
      Holding the returned task (assignment, container, await) is the
      other sanctioned fix and is not flagged.
    """

    rule = "banned-apis"
    prevents = ("root cause: asyncio.iscoroutine matched plain "
                "generators on py<3.12 (all 8 pre-existing tier-1 "
                "failures); NTP steps break time.time() intervals; "
                "GC'd fire-and-forget tasks strand actor send queues")

    #: Where the ensure_future rule applies: the always-on control-plane
    #: daemons, where a GC'd background task is a silent outage.
    _SPAWN_SCOPE = ("ant_ray_tpu_torch/_private/",)

    #: Identifiers whose presence on the flagged line marks the value as
    #: a cross-process wire field (wall clock is correct there).
    wallclock_wire_names = ("deadline_ts",)

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        checker = self
        findings: list[Finding] = []

        def _is_time_time(node: ast.AST) -> bool:
            return (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "time"
                    and _base_name(node.func) == "time")

        def _is_ensure_future(node: ast.AST) -> bool:
            return (isinstance(node, ast.Attribute)
                    and node.attr == "ensure_future"
                    and _base_name(node) == "asyncio")

        spawn_scoped = any(rel_path.startswith(p)
                           for p in self._SPAWN_SCOPE)
        # Attribute nodes serving as a call's callee — a bare
        # `asyncio.ensure_future` reference OUTSIDE this set is being
        # passed around as a callback (the call_soon_threadsafe shape).
        callee_ids = {id(n.func) for n in ast.walk(tree)
                      if isinstance(n, ast.Call)}

        class V(_StmtTracker):
            def _flag_time_arith(self, node: ast.AST):
                # Findings anchor on the enclosing STATEMENT: that is
                # the line a fix edits and the line a disable comment
                # sits above.  The wire-field allowlist scans only the
                # statement HEADER — an `if time.time() - t0 > 60:`
                # must not be exempted because its body happens to
                # mention deadline_ts.
                anchor = self.anchor(node)
                start, end = self.stmt_header_span(node)
                text = " ".join(lines[start - 1:end])
                if any(name in text
                       for name in checker.wallclock_wire_names):
                    return
                findings.append(checker.finding(
                    rel_path, anchor,
                    "time.time() in duration/deadline arithmetic — "
                    "use time.monotonic() (wall clock steps under "
                    "NTP); keep wall clock only for cross-process "
                    "wire fields, with a disable comment saying so",
                    lines))

            def visit_Call(self, node: ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr == "iscoroutine"
                        and _base_name(func) == "asyncio"):
                    findings.append(checker.finding(
                        rel_path, node,
                        "asyncio.iscoroutine() also matches plain "
                        "generators on py<3.12 — use "
                        "inspect.iscoroutine()", lines))
                self.generic_visit(node)

            def visit_Expr(self, node: ast.Expr):
                v = node.value
                if (spawn_scoped and isinstance(v, ast.Call)
                        and _is_ensure_future(v.func)):
                    findings.append(checker.finding(
                        rel_path, node,
                        "bare asyncio.ensure_future() discards its "
                        "task — the loop holds only a weak ref, so it "
                        "can be GC'd mid-flight; use protocol._spawn "
                        "(or hold the returned task)", lines))
                self.generic_visit(node)

            def visit_Attribute(self, node: ast.Attribute):
                if (spawn_scoped and _is_ensure_future(node)
                        and id(node) not in callee_ids):
                    findings.append(checker.finding(
                        rel_path, self.anchor(node),
                        "asyncio.ensure_future passed as a bare "
                        "callback — nothing holds the spawned task, so "
                        "it can be GC'd mid-flight; pass "
                        "protocol._spawn instead", lines))
                self.generic_visit(node)

            def visit_BinOp(self, node: ast.BinOp):
                if isinstance(node.op, (ast.Add, ast.Sub)) and (
                        _is_time_time(node.left)
                        or _is_time_time(node.right)):
                    self._flag_time_arith(node)
                self.generic_visit(node)

            def visit_Compare(self, node: ast.Compare):
                if any(_is_time_time(n)
                       for n in [node.left, *node.comparators]):
                    self._flag_time_arith(node)
                self.generic_visit(node)

        V().visit(tree)
        return findings


class BaseExceptionSwallowChecker(Checker):
    """``except:`` / ``except BaseException`` without a re-raise eats
    the interrupts this codebase treats as control flow:
    ``train.PreemptionInterrupt`` is a BaseException BY DESIGN (so user
    ``except Exception`` can't swallow a node drain) and
    ``asyncio.CancelledError`` drives every shutdown path.

    The error-channeling idiom is exempt: a handler that binds the
    exception (``as e``) and forwards the bound value somewhere a
    consumer will re-raise it (queue.put, set_exception, storing it
    for a reply) propagates rather than swallows.  Merely LOGGING the
    bound name is not channeling — ``logger.warning("ignored: %s", e)``
    is the canonical swallow, the exact pattern this rule exists to
    catch.
    """

    rule = "baseexception-swallow"
    prevents = ("a broad handler in the unwind path would eat "
                "PreemptionInterrupt and re-run completed train steps")

    #: Callee names whose arguments are considered CONSUMED, not
    #: forwarded: a reference that only feeds these is still a swallow.
    _LOG_CALLEES = frozenset(
        {"debug", "info", "warning", "warn", "error", "exception",
         "critical", "log", "print"})

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            if any(isinstance(n, ast.Raise) for n in ast.walk(node)):
                continue
            if node.name and self._channels(node):
                continue
            what = ("bare except:" if node.type is None
                    else "except BaseException")
            findings.append(self.finding(
                rel_path, node,
                f"{what} without re-raise swallows PreemptionInterrupt/"
                "CancelledError — narrow to Exception, or re-raise "
                "BaseExceptions before handling", lines))
        return findings

    def _channels(self, handler: ast.ExceptHandler) -> bool:
        """True when the bound exception is referenced OUTSIDE logging
        calls — forwarded to a queue/future/variable a consumer will
        re-raise, rather than printed and dropped."""
        logged_refs: set[int] = set()
        all_refs: list[ast.Name] = []
        for stmt in handler.body:
            for n in ast.walk(stmt):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in self._LOG_CALLEES) or (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name)
                        and n.func.id in self._LOG_CALLEES):
                    for arg in ast.walk(n):
                        if isinstance(arg, ast.Name) \
                                and arg.id == handler.name:
                            logged_refs.add(id(arg))
                elif isinstance(n, ast.Name) and n.id == handler.name:
                    all_refs.append(n)
        return any(id(ref) not in logged_refs for ref in all_refs)

    @staticmethod
    def _is_broad(type_node: ast.AST | None) -> bool:
        if type_node is None:
            return True
        nodes = (type_node.elts if isinstance(type_node, ast.Tuple)
                 else [type_node])
        return any(_terminal_name(n) == "BaseException" for n in nodes)


class ResponseTruthinessChecker(Checker):
    """Truth-testing an aiohttp ``web.Response``: an unprepared response
    defines ``__len__`` via its body and is FALSY, so ``resp or
    fallback`` / ``if resp:`` silently drops a typed reply.  Compare
    against ``None`` explicitly."""

    rule = "response-truthiness"
    prevents = ("third review round: `resp or fallback` replaced "
                "a typed 429 (empty body => falsy Response) with a 500")
    scope = ("ant_ray_tpu_torch/serve/",
             "ant_ray_tpu_torch/_private/dashboard.py")

    _RESPONSE_CALL_RE = re.compile(
        r"(Response$)|(^json_response$)|(_response$)")

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(rel_path, node,
                                                     lines))
        return findings

    def _response_names(self, fn: ast.AST) -> set[str]:
        names: set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = _terminal_name(node.value.func)
            if not self._RESPONSE_CALL_RE.search(callee):
                continue
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
        return names

    def _check_function(self, rel_path: str, fn: ast.AST,
                        lines: list[str]) -> Iterable[Finding]:
        names = self._response_names(fn)
        if not names:
            return []

        def bad(expr: ast.AST) -> bool:
            return isinstance(expr, ast.Name) and expr.id in names

        findings = []

        def flag(expr: ast.AST, how: str):
            findings.append(self.finding(
                rel_path, expr,
                f"truth-testing Response-bound name "
                f"'{expr.id}' ({how}) — an unprepared web.Response "  # type: ignore[attr-defined]
                "with an empty body is FALSY; compare `is None` "
                "instead", lines))

        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and bad(node.test):
                flag(node.test, "if/while test")
            elif isinstance(node, ast.BoolOp):
                for value in node.values:
                    if bad(value):
                        flag(value, "and/or chain")
            elif isinstance(node, ast.UnaryOp) \
                    and isinstance(node.op, ast.Not) and bad(node.operand):
                flag(node.operand, "not <resp>")
            elif isinstance(node, ast.Assert) and bad(node.test):
                flag(node.test, "assert")
        return findings


# ---------------------------------------------------- wire-schema drift

def snapshot_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "wire_methods.json")


def load_snapshot(path: str | None = None) -> dict:
    try:
        with open(path or snapshot_path()) as f:
            return json.load(f).get("methods", {})
    except (OSError, ValueError):
        return {}


def save_snapshot(path: str | None = None) -> None:
    from ant_ray_tpu_torch._private import wire_schema  # noqa: PLC0415

    methods = {name: entry["since"]
               for name, entry in sorted(wire_schema.METHODS.items())}
    with open(path or snapshot_path(), "w") as f:
        json.dump({"comment": "additive-only METHODS snapshot — a "
                              "removed/renamed RPC or a changed `since` "
                              "fails wire-schema-drift; record additions "
                              "with --baseline-update",
                   "methods": methods}, f, indent=1)
        f.write("\n")


class WireSchemaDriftChecker(ProjectChecker):
    """The one-off wire lint generalized: the wire-schema registry, the
    tracing plane table, and the committed snapshot must agree.

    * every METHODS entry well-formed (service/payload/reply non-empty,
      ``since`` <= PROTOCOL_VERSION);
    * METHODS ≡ RPC_METHOD_PLANES, both directions (an RPC cannot ship
      without deciding its latency-aggregation plane);
    * additive-only vs the committed snapshot: a method present in the
      snapshot but gone from METHODS (rename/removal), or whose
      ``since`` changed, fails loudly — mixed-version peers would
      mis-route; genuinely new methods are recorded with
      ``--baseline-update``.
    """

    rule = "wire-schema-drift"
    prevents = ("one-off test generalized: an RPC renamed or "
                "shipped without a latency plane breaks mixed-version "
                "peers / ships untraced")

    _SCHEMA_PATH = "ant_ray_tpu_torch/_private/wire_schema.py"

    def __init__(self, methods: dict | None = None,
                 planes: dict | None = None,
                 snapshot: dict | None = None,
                 protocol_version: int | None = None):
        # Injectable for fixture tests; None = the real registries.
        self._methods = methods
        self._planes = planes
        self._snapshot = snapshot
        self._protocol_version = protocol_version

    def _load(self):
        from ant_ray_tpu_torch._private import protocol, wire_schema  # noqa: PLC0415
        from ant_ray_tpu_torch.observability.tracing_plane import (  # noqa: PLC0415
            RPC_METHOD_PLANES)

        methods = (self._methods if self._methods is not None
                   else wire_schema.METHODS)
        planes = (self._planes if self._planes is not None
                  else RPC_METHOD_PLANES)
        snapshot = (self._snapshot if self._snapshot is not None
                    else load_snapshot())
        version = (self._protocol_version
                   if self._protocol_version is not None
                   else protocol.PROTOCOL_VERSION)
        return methods, planes, snapshot, version

    def _line_of(self, package_root: str, method: str) -> int:
        try:
            path = os.path.join(os.path.dirname(package_root),
                                self._SCHEMA_PATH)
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    if f'"{method}"' in line:
                        return i
        except OSError:
            pass
        return 1

    def check_project(self, package_root: str) -> Iterable[Finding]:
        methods, planes, snapshot, version = self._load()
        findings: list[Finding] = []

        def finding(message: str, method: str = "") -> None:
            line = self._line_of(package_root, method) if method else 1
            findings.append(Finding(self.rule, self._SCHEMA_PATH, line,
                                    message, text=method))

        for name, entry in methods.items():
            if not (isinstance(entry, dict) and entry.get("service")
                    and entry.get("payload") and entry.get("reply")
                    and isinstance(entry.get("since"), int)):
                finding(f"METHODS[{name!r}] malformed: needs non-empty "
                        "service/payload/reply and an int `since`", name)
            elif entry["since"] > version:
                finding(f"METHODS[{name!r}].since={entry['since']} is "
                        f"ahead of PROTOCOL_VERSION={version}", name)

        for name in sorted(set(methods) - set(planes)):
            finding(f"{name!r} has no RPC_METHOD_PLANES entry — it "
                    "would ship untraced; decide its latency plane in "
                    "observability/tracing_plane.py", name)
        for name in sorted(set(planes) - set(methods)):
            finding(f"RPC_METHOD_PLANES names {name!r}, absent from "
                    "wire_schema.METHODS — stale table entry", name)
        for name, plane in planes.items():
            if not (isinstance(plane, str) and plane):
                finding(f"RPC_METHOD_PLANES[{name!r}] must be a "
                        "non-empty plane label", name)

        for name, since in sorted(snapshot.items()):
            if name not in methods:
                finding(f"{name!r} is in the committed wire snapshot "
                        "but gone from METHODS — removing/renaming an "
                        "RPC breaks mixed-version peers; bump "
                        "PROTOCOL_VERSION and refresh the snapshot "
                        "with --baseline-update", name)
            elif methods[name].get("since") != since:
                finding(f"{name!r} changed since={since} -> "
                        f"{methods[name].get('since')} — a contract "
                        "change needs a PROTOCOL_VERSION bump and a "
                        "snapshot refresh", name)
        for name in sorted(set(methods) - set(snapshot)):
            finding(f"new RPC {name!r} is not in the committed wire "
                    "snapshot — record it with --baseline-update "
                    "(additive evolution is fine; the snapshot is what "
                    "makes removals loud)", name)
        return findings


# ---------------------------------------------------- frame-schema drift

def frame_snapshot_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "wire_frames.json")


def live_frame_schema() -> tuple[dict, dict]:
    """(frame kind/flag constants, ordered hot field tables) as the
    tree defines them right now."""
    from ant_ray_tpu_torch._private import hotframe, protocol  # noqa: PLC0415

    kinds = {
        "REQ": protocol._REQ, "REP": protocol._REP,
        "ERR": protocol._ERR, "ONEWAY": protocol._ONEWAY,
        "HELLO": protocol._HELLO, "GOODBYE": protocol._GOODBYE,
        "HOT": protocol._HOT,
        "RAW_FLAG": protocol._RAW_FLAG,
        "HOT_FLAG": protocol._HOT_FLAG,
        "HOT_WIRE_VERSION": hotframe.HOT_WIRE_VERSION,
        "HOT_TEMPLATE": hotframe.HOT_TEMPLATE,
        "HOT_CALL": hotframe.HOT_CALL,
        "HOT_ACKS": hotframe.HOT_ACKS,
    }
    tables = {
        "hot_template_fields": list(hotframe.TEMPLATE_FIELDS),
        "hot_call_fields": list(hotframe.CALL_FIELDS),
    }
    return kinds, tables


def load_frame_snapshot(path: str | None = None) -> dict:
    try:
        with open(path or frame_snapshot_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_frame_snapshot(path: str | None = None) -> None:
    kinds, tables = live_frame_schema()
    with open(path or frame_snapshot_path(), "w") as f:
        json.dump({"comment": "frame-kind constants + hot-frame field "
                              "tables — values are FROZEN and the "
                              "field tables append-only (a reorder/"
                              "rename breaks peers that negotiated "
                              "the same hot version); record additive "
                              "growth with --baseline-update",
                   "frame_kinds": kinds, **tables}, f, indent=1)
        f.write("\n")


class FrameSchemaDriftChecker(ProjectChecker):
    """The wire-schema drift idea extended below the method registry to
    the FRAME layer the hot wire introduced: transport kind/flag
    constants and the hot-frame field tables must stay frozen /
    append-only against the committed ``wire_frames.json`` snapshot.

    * a frame-kind or flag value that CHANGES (or disappears) fails —
      peers that negotiated the same PROTOCOL_VERSION / hot version
      would mis-parse each other's frames;
    * the hot template/call field tables are ordered wire layout:
      renaming, removing, or REORDERING an entry fails (struct offsets
      shift under the peer); appending is the one legal evolution,
      recorded with ``--baseline-update`` alongside a
      ``HOT_WIRE_VERSION`` bump when layout-affecting.
    """

    rule = "frame-schema-drift"
    prevents = ("a hot-frame field reordered without a version bump "
                "would mis-decode every call between same-version "
                "peers — the wire-schema snapshot idea applied to the "
                "frame layer")

    _HOTFRAME_PATH = "ant_ray_tpu_torch/_private/hotframe.py"

    def __init__(self, kinds: dict | None = None,
                 tables: dict | None = None,
                 snapshot: dict | None = None):
        # Injectable for fixture tests; None = the real registries.
        self._kinds = kinds
        self._tables = tables
        self._snapshot = snapshot

    def check_project(self, package_root: str) -> Iterable[Finding]:
        if self._kinds is not None:
            kinds, tables = self._kinds, self._tables or {}
        else:
            kinds, tables = live_frame_schema()
        snapshot = (self._snapshot if self._snapshot is not None
                    else load_frame_snapshot())
        findings: list[Finding] = []

        def finding(message: str, text: str = "") -> None:
            findings.append(Finding(self.rule, self._HOTFRAME_PATH, 1,
                                    message, text=text))

        for name, value in (snapshot.get("frame_kinds") or {}).items():
            if name not in kinds:
                finding(f"frame kind/flag {name!r} is in the committed "
                        "frame snapshot but gone from the tree — "
                        "removing a frame constant breaks negotiated "
                        "peers", name)
            elif kinds[name] != value:
                finding(f"frame kind/flag {name!r} changed "
                        f"{value} -> {kinds[name]} — frame constants "
                        "are frozen wire contract; introduce a NEW "
                        "kind instead", name)
        for name in sorted(set(kinds) - set(snapshot.get("frame_kinds")
                                            or {})):
            finding(f"new frame kind/flag {name!r} is not in the "
                    "committed frame snapshot — record it with "
                    "--baseline-update", name)

        for table in ("hot_template_fields", "hot_call_fields"):
            live = tables.get(table)
            pinned = snapshot.get(table)
            if live is None or pinned is None:
                if pinned is not None:
                    finding(f"{table} missing from the tree but pinned "
                            "in the frame snapshot", table)
                continue
            if live[:len(pinned)] != pinned:
                finding(f"{table} is not an append-only extension of "
                        f"the committed snapshot ({pinned} -> {live}) "
                        "— renaming/removing/reordering shifts struct "
                        "offsets under same-version peers; append "
                        "only, and bump HOT_WIRE_VERSION for layout "
                        "changes", table)
            elif len(live) > len(pinned):
                finding(f"{table} grew ({len(pinned)} -> {len(live)} "
                        "fields) — record the addition with "
                        "--baseline-update", table)
        return findings


class PickleInHotPathChecker(Checker):
    """Direct ``pickle.dumps``/``pickle.loads`` on the framing hot path
    outside the blessed helpers.  The zero-pickle frame work holds only
    as long as per-call code keeps using the struct codec — a stray
    pickle call in protocol/hotframe/core wire sections silently
    reintroduces the cost the hot wire removed."""

    rule = "pickle-in-hot-path"
    prevents = ("the hot-frame rebuild: pickled TaskSpec frames "
                "cost ~an order of magnitude over the struct codec at "
                "10k calls/s, and a casual pickle.dumps in the framing "
                "layer regresses it invisibly")
    scope = ("ant_ray_tpu_torch/_private/protocol.py",
             "ant_ray_tpu_torch/_private/hotframe.py")

    #: Enclosing functions where pickle IS the job: the generic pickled
    #: framing helpers, and the hot-codec spots that pickle cold/rare
    #: sub-payloads (templates: once per connection; trace contexts:
    #: sampled calls only; exception acks: error path).
    _BLESSED = frozenset({
        "_encode_frame", "_encode_raw_head", "_read_frame",
        "encode_template", "decode_template", "encode_call",
        "decode_call", "encode_ack_exc", "decode_acks",
    })

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        findings: list[Finding] = []
        stack: list[str] = []

        def visit(node: ast.AST) -> None:
            is_fn = isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
            if is_fn:
                stack.append(node.name)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("dumps", "loads") \
                    and _terminal_name(node.func.value) == "pickle" \
                    and not (stack and stack[-1] in self._BLESSED):
                findings.append(self.finding(
                    rel_path, node,
                    f"direct pickle.{node.func.attr}() outside the "
                    "blessed framing helpers "
                    f"({', '.join(sorted(self._BLESSED))}) — per-call "
                    "pickle is what the hot-frame codec exists to "
                    "avoid; route through the codec or a blessed "
                    "helper", lines))
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_fn:
                stack.pop()

        visit(tree)
        return findings


class MetricTagCardinalityChecker(Checker):
    """Per-request identifiers used as metric TAGS.  Every distinct tag
    value mints a new series in the GCS metric store (keyed on
    ``(name, sorted(tags))`` — gcs.py ``_metric_record``), so tagging
    by ``task_id``/``trace_id``/... grows the store linearly with
    traffic until ``MetricsGet`` and the ``/metrics`` scrape drown.
    High-cardinality samples belong in EXEMPLARS (``observe(...,
    exemplar=task_id)`` keeps the last sample per bucket, bounded) —
    the ``exemplar=`` kwarg is deliberately not matched.

    UNDER-match: only literal dict keys in a ``tags={...}`` kwarg on
    metric-shaped calls (``Counter/Gauge/Histogram`` constructors and
    ``.inc/.set/.observe/.record`` methods) and literal ``tag_keys=``
    tuples on the constructors are flagged — a tags dict built in a
    variable is invisible, and that's the accepted price of zero false
    positives."""

    rule = "metric-tag-cardinality"
    prevents = ("observability review: a task_id tag on a latency "
                "histogram minted one series per task and ballooned "
                "the GCS metric store past the /metrics scrape budget")

    _BANNED_KEYS = frozenset({"task_id", "trace_id", "object_id",
                              "request_id"})
    _METRIC_CTORS = frozenset({"Counter", "Gauge", "Histogram"})
    _METRIC_METHODS = frozenset({"inc", "set", "observe", "record"})

    def _banned_in(self, node: ast.AST) -> list[str]:
        """Banned identifier strings appearing as literal keys/items."""
        if isinstance(node, ast.Dict):
            items: Iterable[ast.AST] = node.keys
        elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            items = node.elts
        else:
            return []
        return sorted({n.value for n in items
                       if isinstance(n, ast.Constant)
                       and isinstance(n.value, str)
                       and n.value in self._BANNED_KEYS})

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _terminal_name(node.func)
            is_ctor = name in self._METRIC_CTORS
            is_method = (name in self._METRIC_METHODS
                         and isinstance(node.func, ast.Attribute))
            if not (is_ctor or is_method):
                continue
            for kw in node.keywords:
                if kw.arg == "tags" or (is_ctor and kw.arg == "tag_keys"):
                    banned = self._banned_in(kw.value)
                    if banned:
                        findings.append(self.finding(
                            rel_path, node,
                            f"per-request identifier(s) "
                            f"{', '.join(banned)} as metric tag(s) on "
                            f"{name}() — each distinct value mints a "
                            "new series and grows the GCS metric store "
                            "with traffic; drop the tag or attach the "
                            "id as an exemplar (exemplar= stays "
                            "bounded per bucket)", lines))
        return findings


FILE_CHECKERS: list[Checker] = [
    BlockingUnderLockChecker(),
    BlockingInAsyncChecker(),
    BannedApisChecker(),
    BaseExceptionSwallowChecker(),
    ResponseTruthinessChecker(),
    PickleInHotPathChecker(),
    MetricTagCardinalityChecker(),
]

PROJECT_CHECKERS: list[ProjectChecker] = [
    WireSchemaDriftChecker(),
    FrameSchemaDriftChecker(),
]

ALL_CHECKERS = [*FILE_CHECKERS, *PROJECT_CHECKERS]
