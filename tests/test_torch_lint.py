"""The port's artlint (``ant_ray_tpu_torch/_lint``: the framework, the
checkers, the CLI and the committed snapshots) against the JAX
package's.  Each scenario of tests/test_lint.py but lockcheck's
(``:54-562``, ``:724``, ``:754-930``) has its twin here: the same source
goes through both packages' checkers, under the reference path and under
the same path in the port, and the findings must be equal (rule, line,
anchored text, and message once the package's name is mapped); the
reference's assertions then hold on the port's findings.  The port's
own package lints clean with an empty baseline, its committed wire and
frame snapshots track its live registries and equal the reference's,
and its CLI's exit codes and ``--list-rules`` match the reference's."""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from ant_ray_tpu._lint import checkers as RC
from ant_ray_tpu._lint import framework as RF
from ant_ray_tpu_torch._lint import checkers as C
from ant_ray_tpu_torch._lint import framework as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_path(rel: str) -> str:
    return rel.replace("ant_ray_tpu/", "ant_ray_tpu_torch/", 1)


def _unport(text: str) -> str:
    return text.replace("ant_ray_tpu_torch", "ant_ray_tpu")


_HISTORY_TAG = re.compile(r"\bPR \d+(?:'s)?:? ?")


def _untagged(text: str) -> str:
    """The reference's rule texts without the tags naming the change
    that shipped each bug ("PR <n> ", "PR <n>'s "): the port's copies say
    the same without them."""
    return _HISTORY_TAG.sub("", text)


def _key(f) -> tuple:
    return (f.rule, _unport(f.path), f.line, _unport(f.message), f.text)


def _run(framework, checker, rel, source):
    tree = ast.parse(source)
    lines = source.splitlines()
    assert checker.applies_to(rel), f"{rel} outside {checker.scope}"
    return [f for f in checker.check(rel, tree, lines)
            if not framework.is_suppressed(f, lines)]


def lint_src(source: str, name: str,
             rel: str = "ant_ray_tpu/_private/x.py"):
    """Run the checker class ``name`` of both packages over a source
    snippet (suppressions applied as the driver does), hold the
    findings equal, and return the port's."""
    source = textwrap.dedent(source)
    ref = _run(RF, getattr(RC, name)(), rel, source)
    port = _run(F, getattr(C, name)(), _port_path(rel), source)
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    return port


def _applies(name: str, rel: str) -> bool:
    ref = getattr(RC, name)().applies_to(rel)
    port = getattr(C, name)().applies_to(_port_path(rel))
    assert port == ref, rel
    return port


# ------------------------------------------------- blocking-under-lock

BAD_UNDER_LOCK = """
    import time

    def grant(self):
        with self._lock:
            time.sleep(0.5)
"""

FIXED_UNDER_LOCK = """
    import time

    def grant(self):
        with self._lock:
            snapshot = dict(self._state)
        time.sleep(0.5)
"""


def test_blocking_under_lock_fires_and_fix_silences():
    bad = lint_src(BAD_UNDER_LOCK, "BlockingUnderLockChecker")
    assert len(bad) == 1 and bad[0].rule == "blocking-under-lock"
    assert "time.sleep" in bad[0].message
    assert not lint_src(FIXED_UNDER_LOCK, "BlockingUnderLockChecker")


def test_blocking_under_lock_catches_rpc_and_socket_and_result():
    src = """
        def f(self, client, sock, fut):
            with self._pair_lock:
                client.call("LeaseWorker", {})
                sock.sendall(b"x")
                fut.result()
    """
    rules = lint_src(src, "BlockingUnderLockChecker")
    assert len(rules) == 3
    assert {"round trip" in f.message or "wire" in f.message
            or "parks" in f.message for f in rules} == {True}


@pytest.mark.parametrize("rel,applies", [
    ("ant_ray_tpu/_private/node_daemon.py", True),
    ("ant_ray_tpu/util/collective/fusion.py", True),
    ("ant_ray_tpu/experimental/channel.py", True),
    ("ant_ray_tpu/train/controller.py", False),
])
def test_blocking_under_lock_scoped_to_concurrent_planes(rel, applies):
    assert _applies("BlockingUnderLockChecker", rel) is applies


# --------------------------------------------------- blocking-in-async

def test_blocking_in_async_fires_and_async_sleep_is_fine():
    bad = lint_src("""
        import time

        async def handler(self):
            time.sleep(0.1)
    """, "BlockingInAsyncChecker")
    assert len(bad) == 1 and bad[0].rule == "blocking-in-async"
    assert not lint_src("""
        import asyncio

        async def handler(self):
            await asyncio.sleep(0.1)
    """, "BlockingInAsyncChecker")


def test_blocking_in_async_exempts_nested_sync_defs():
    assert not lint_src("""
        import time

        async def handler(self, loop):
            def work():
                time.sleep(0.1)
            await loop.run_in_executor(None, work)
    """, "BlockingInAsyncChecker")


# --------------------------------------------------------- banned-apis

def test_banned_iscoroutine_fires_and_inspect_is_fine():
    bad = lint_src("""
        import asyncio

        def classify(obj):
            return asyncio.iscoroutine(obj)
    """, "BannedApisChecker")
    assert len(bad) == 1 and "inspect.iscoroutine" in bad[0].message
    assert not lint_src("""
        import inspect

        def classify(obj):
            return inspect.iscoroutine(obj)
    """, "BannedApisChecker")


def test_banned_time_time_arithmetic_fires_and_monotonic_is_fine():
    bad = lint_src("""
        import time

        def wait(self):
            deadline = time.time() + 5.0
            while time.time() < deadline:
                pass
    """, "BannedApisChecker")
    assert len(bad) == 2
    assert all("monotonic" in f.message for f in bad)
    assert not lint_src("""
        import time

        def wait(self):
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                pass
    """, "BannedApisChecker")


def test_banned_time_time_allowlists_wire_deadline_fields():
    assert not lint_src("""
        import time

        def stamp(self, meta, timeout):
            meta["deadline_ts"] = time.time() + timeout
    """, "BannedApisChecker")


def test_banned_time_time_anchors_multiline_statement():
    src = """
        import time

        def f(self, dur):
            # artlint: disable=banned-apis — span ts is a wire field
            record(
                ts=time.time() - dur)
    """
    assert not lint_src(src, "BannedApisChecker")
    stripped = src.replace(
        "# artlint: disable=banned-apis — span ts is a wire field", "#")
    assert len(lint_src(stripped, "BannedApisChecker")) == 1


def test_banned_time_time_compound_header_not_exempted_by_body():
    bad = lint_src("""
        import time

        def sweep(self):
            if time.time() - self._started > 60:
                self._expire(self.deadline_ts)
    """, "BannedApisChecker")
    assert len(bad) == 1


def test_banned_bare_ensure_future_fires_and_spawn_is_fine():
    bad = lint_src("""
        import asyncio

        def kick(self, state):
            asyncio.ensure_future(self._actor_sender(state))
    """, "BannedApisChecker")
    assert len(bad) == 1 and "_spawn" in bad[0].message
    assert not lint_src("""
        from ant_ray_tpu_torch._private.protocol import _spawn

        def kick(self, state):
            _spawn(self._actor_sender(state))
    """, "BannedApisChecker")


def test_banned_ensure_future_as_callback_fires():
    bad = lint_src("""
        import asyncio

        def release(self, loop, coro):
            loop.call_soon_threadsafe(asyncio.ensure_future, coro)
    """, "BannedApisChecker")
    assert len(bad) == 1 and "callback" in bad[0].message


def test_banned_ensure_future_held_task_is_fine():
    assert not lint_src("""
        import asyncio

        async def run(self, coros):
            task = asyncio.ensure_future(coros[0])
            tasks = [asyncio.ensure_future(c) for c in coros]
            self._by_task = {asyncio.ensure_future(coros[1]): "x"}
            await asyncio.gather(task, *tasks)
    """, "BannedApisChecker")


@pytest.mark.parametrize("rel,fires", [
    ("ant_ray_tpu/serve/api.py", False),
    ("ant_ray_tpu/dag/compiled.py", False),
    ("ant_ray_tpu/_private/gcs_ha.py", True),
])
def test_banned_ensure_future_scoped_to_private(rel, fires):
    found = lint_src("""
        import asyncio

        def kick(self, coro):
            asyncio.ensure_future(coro)
    """, "BannedApisChecker", rel=rel)
    assert bool(found) is fires


def test_blocking_checkers_anchor_multiline_statements():
    src = """
        import subprocess

        def build(self):
            with self._lock:
                # artlint: disable=blocking-under-lock — one-time build
                proc = subprocess.run(
                    ["make"],
                    check=True)
    """
    assert not lint_src(src, "BlockingUnderLockChecker")
    stripped = src.replace(
        "# artlint: disable=blocking-under-lock — one-time build", "#")
    found = lint_src(stripped, "BlockingUnderLockChecker")
    assert len(found) == 1
    assert "proc = subprocess.run(" in found[0].text


# ----------------------------------------------- baseexception-swallow

def test_baseexception_swallow_fires_on_bare_and_broad():
    bad = lint_src("""
        def f():
            try:
                work()
            except:
                pass

        def g():
            try:
                work()
            except BaseException:
                log()
    """, "BaseExceptionSwallowChecker")
    assert len(bad) == 2
    assert all(f.rule == "baseexception-swallow" for f in bad)


def test_baseexception_swallow_fix_and_channeling_are_fine():
    assert not lint_src("""
        def f():
            try:
                work()
            except Exception:
                pass

        def g():
            try:
                work()
            except BaseException:
                cleanup()
                raise

        def h(q):
            try:
                work()
            except BaseException as e:   # channeled to the consumer
                q.put(("error", e))
    """, "BaseExceptionSwallowChecker")


def test_baseexception_swallow_log_and_continue_still_fires():
    bad = lint_src("""
        def f(logger):
            try:
                work()
            except BaseException as e:
                logger.warning("ignored: %s", e)

        def g():
            try:
                work()
            except BaseException as e:
                print(e)
    """, "BaseExceptionSwallowChecker")
    assert len(bad) == 2


def test_baseexception_swallow_store_then_forward_is_channeling():
    assert not lint_src("""
        def f(q):
            try:
                work()
            except BaseException as e:
                staged = ("error", e)
                q.put(staged)
    """, "BaseExceptionSwallowChecker")


def test_baseexception_swallow_sees_tuple_handlers():
    bad = lint_src("""
        def f():
            try:
                work()
            except (ValueError, BaseException):
                pass
    """, "BaseExceptionSwallowChecker")
    assert len(bad) == 1


# ----------------------------------------------- response-truthiness

def test_response_truthiness_fires_in_serve_scope():
    src = """
        def dispatch(request):
            resp = shed_response(429)
            if resp:
                return resp
            return resp or fallback()
    """
    bad = lint_src(src, "ResponseTruthinessChecker",
                   rel="ant_ray_tpu/serve/api.py")
    assert len(bad) == 2
    assert all("FALSY" in f.message for f in bad)


def test_response_truthiness_is_none_is_fine():
    assert not lint_src("""
        def dispatch(request):
            resp = web.Response(status=429)
            if resp is None:
                return fallback()
            return resp
    """, "ResponseTruthinessChecker", rel="ant_ray_tpu/serve/api.py")


@pytest.mark.parametrize("rel,applies", [
    ("ant_ray_tpu/serve/api.py", True),
    ("ant_ray_tpu/_private/dashboard.py", True),
    ("ant_ray_tpu/_private/node_daemon.py", False),
])
def test_response_truthiness_scope(rel, applies):
    assert _applies("ResponseTruthinessChecker", rel) is applies


# ----------------------------------------------------- wire-schema drift

def _drift(methods, planes, snapshot, version=1):
    out = []
    for checkers, framework in ((RC, RF), (C, F)):
        checker = checkers.WireSchemaDriftChecker(
            methods=methods, planes=planes, snapshot=snapshot,
            protocol_version=version)
        out.append(list(checker.check_project(framework.package_root())))
    ref, port = out
    assert all(f.path == "ant_ray_tpu_torch/_private/wire_schema.py"
               for f in port)
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    return port


_GOOD_METHOD = {"service": "gcs", "since": 1, "payload": "{}",
                "reply": "bool"}


def test_wire_drift_clean_when_all_agree():
    assert not _drift({"Ping": _GOOD_METHOD}, {"Ping": "control"},
                      {"Ping": 1})


def test_wire_drift_method_without_plane_fails():
    findings = _drift({"Ping": _GOOD_METHOD, "NewRpc": _GOOD_METHOD},
                      {"Ping": "control"}, {"Ping": 1, "NewRpc": 1})
    assert any("no RPC_METHOD_PLANES" in f.message for f in findings)


def test_wire_drift_stale_plane_fails():
    findings = _drift({"Ping": _GOOD_METHOD},
                      {"Ping": "control", "Gone": "control"}, {"Ping": 1})
    assert any("stale" in f.message for f in findings)


def test_wire_drift_removed_method_fails_loudly():
    findings = _drift({"Ping": _GOOD_METHOD}, {"Ping": "control"},
                      {"Ping": 1, "RenamedAway": 1})
    assert any("breaks mixed-version peers" in f.message
               for f in findings)


def test_wire_drift_since_change_and_new_method_fail():
    changed = _drift({"Ping": dict(_GOOD_METHOD, since=2)},
                     {"Ping": "control"}, {"Ping": 1}, version=2)
    assert any("PROTOCOL_VERSION bump" in f.message for f in changed)
    new = _drift({"Ping": _GOOD_METHOD, "Fresh": _GOOD_METHOD},
                 {"Ping": "control", "Fresh": "control"}, {"Ping": 1})
    assert any("--baseline-update" in f.message for f in new)


def test_wire_drift_malformed_entry_fails():
    findings = _drift({"Ping": {"service": "", "since": 1,
                                "payload": "{}", "reply": "bool"}},
                      {"Ping": "control"}, {"Ping": 1})
    assert any("malformed" in f.message for f in findings)


def test_wire_snapshot_matches_committed_registry():
    """The port's committed snapshot tracks its own METHODS exactly and
    equals the reference's (both packages register the same RPCs)."""
    from ant_ray_tpu_torch._private import wire_schema

    snapshot = C.load_snapshot()
    assert snapshot, "wire_methods.json missing or empty"
    assert os.path.dirname(C.snapshot_path()).endswith(
        os.path.join("ant_ray_tpu_torch", "_lint"))
    assert set(snapshot) == set(wire_schema.METHODS)
    for name, since in snapshot.items():
        assert wire_schema.METHODS[name]["since"] == since, name
    assert snapshot == RC.load_snapshot()


# ------------------------------------------------ suppression mechanics

@pytest.mark.parametrize("src", [
    """
        import time

        def f(t0):
            return time.time() - t0  # artlint: disable=banned-apis — x
    """,
    """
        import time

        def f(t0):
            # a rationale that runs
            # artlint: disable=banned-apis — over several comment
            # lines still applies to the statement below it.
            return time.time() - t0
    """,
    """
        import time

        def f(t0):
            # artlint: disable=all — kitchen sink
            return time.time() - t0
    """,
], ids=["same-line", "block-above", "all"])
def test_suppression_same_line_and_block_above_and_all(src):
    assert not lint_src(src, "BannedApisChecker")
    unsuppressed = src.replace("artlint: disable", "nothing")
    assert len(lint_src(unsuppressed, "BannedApisChecker")) == 1


def test_suppression_for_other_rule_does_not_apply():
    findings = lint_src("""
        import time

        def f(t0):
            # artlint: disable=blocking-under-lock — wrong rule
            return time.time() - t0
    """, "BannedApisChecker")
    assert len(findings) == 1


# --------------------------------------------------- baseline round trip

def test_baseline_round_trip_and_stale_detection(tmp_path):
    out = []
    for framework, pkg in ((RF, "ant_ray_tpu"), (F, "ant_ray_tpu_torch")):
        f1 = framework.Finding("banned-apis", f"{pkg}/x.py", 10, "msg",
                               text="deadline = time.time() + 5")
        f2 = framework.Finding("banned-apis", f"{pkg}/y.py", 3, "msg",
                               text="t = time.time() - t0")
        path = str(tmp_path / f"{pkg}.json")
        framework.save_baseline([f1, f2], path)
        entries = framework.load_baseline(path)
        assert len(entries) == 2
        counter = framework._baseline_counter(entries)
        assert counter[f1.baseline_key()] == 1
        remaining = framework._baseline_counter(entries)
        remaining[f1.baseline_key()] -= 1
        stale = [k for k, n in remaining.items() if n > 0]
        assert stale == [f2.baseline_key()]
        with open(path) as f:
            out.append(_unport(f.read()))
    assert out[0] == out[1]


def test_baseline_matching_survives_line_drift(tmp_path):
    entry = {"rule": "banned-apis", "path": "ant_ray_tpu_torch/x.py",
             "line": 10, "text": "deadline = time.time() + 5"}
    drifted = F.Finding("banned-apis", "ant_ray_tpu_torch/x.py", 99, "msg",
                        text="deadline = time.time() + 5")
    assert F._baseline_counter([entry])[drifted.baseline_key()] == 1


# ------------------------------------------------ the package is clean

def test_package_lints_clean_with_shrink_only_baseline():
    """Every checker over the whole port, zero new findings, zero stale
    baseline entries, an empty committed baseline, and the findings'
    paths relative to the repo (``ant_ray_tpu_torch/...``)."""
    assert F.package_root() == os.path.join(REPO, "ant_ray_tpu_torch")
    result = F.run_lint()
    assert result.files_checked > 100
    rendered = "\n".join(f.render() for f in result.findings)
    assert not result.findings, f"new artlint findings:\n{rendered}"
    assert not result.stale_baseline, result.stale_baseline
    assert F.load_baseline() == []
    assert result.suppressed > 0
    # The suppressions the port carries are found under its own paths.
    unsuppressed = F.run_lint(
        [os.path.join(REPO, "ant_ray_tpu_torch", "_private",
                      "native.py")], baseline=[])
    assert unsuppressed.suppressed == 1


# One planted violation per rule: a source appended to a file inside the
# rule's scope, or (the project rules) an entry dropped from a snapshot.
PLANTS = {
    "blocking-under-lock": ("_private/planted.py", "import time\n\n"
                            "def f(self):\n    with self._lock:\n"
                            "        time.sleep(1)\n"),
    "blocking-in-async": ("dag/planted.py", "import time\n\n"
                          "async def f():\n    time.sleep(1)\n"),
    "banned-apis": ("tune/planted.py", "import time\n\n"
                    "def f(t0):\n    return time.time() - t0\n"),
    "baseexception-swallow": ("autoscaler/planted.py",
                              "def f():\n    try:\n        g()\n"
                              "    except BaseException:\n"
                              "        pass\n"),
    "response-truthiness": ("serve/api.py", "def f():\n"
                            "    resp = web.Response()\n"
                            "    return resp or g()\n"),
    "pickle-in-hot-path": ("_private/protocol.py", "import pickle\n\n"
                           "def send(x):\n    return pickle.dumps(x)\n"),
    "metric-tag-cardinality": ("util/planted.py", "def f(self, t):\n"
                               "    self._c.inc(1, tags={'task_id': t})\n"),
    "wire-schema-drift": ("_lint/wire_methods.json", "methods"),
    "frame-schema-drift": ("_lint/wire_frames.json", "frame_kinds"),
}


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    import shutil

    root = tmp_path_factory.mktemp("lint_copy")
    shutil.copytree(os.path.join(REPO, "ant_ray_tpu_torch"),
                    root / "ant_ray_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return root


def _cli(root, *args):
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run(
        [sys.executable, "-m", "ant_ray_tpu_torch._lint", *args],
        cwd=str(root), env=env, capture_output=True, text=True,
        timeout=120)


@pytest.mark.parametrize("rule", sorted(PLANTS))
def test_planted_violation_makes_the_cli_exit_one(rule, port_copy,
                                                  tmp_path):
    """A copy of the port with one violation planted: the CLI (the
    copy's own, on the copy) exits 1 naming exactly that rule."""
    import shutil

    root = tmp_path / "copy"
    shutil.copytree(port_copy, root)
    rel, plant = PLANTS[rule]
    target = root / "ant_ray_tpu_torch" / rel
    if target.suffix == ".json":
        data = json.loads(target.read_text())
        data[plant].pop(sorted(data[plant])[0])
        target.write_text(json.dumps(data))
    else:
        with open(target, "a") as f:
            f.write("\n\n" + plant)
    proc = _cli(root)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    rules = {line.split("[", 1)[1].split("]", 1)[0]
             for line in proc.stdout.splitlines() if "[" in line}
    assert rules == {rule}, proc.stdout
    assert f"ant_ray_tpu_torch/{rel.split('/')[0]}" in proc.stdout \
        or rule.endswith("drift")


def test_unplanted_copy_lints_clean(port_copy):
    proc = _cli(port_copy, "-q")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_exits_zero_on_clean_tree_and_one_on_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\n"
                   "def f(t0):\n"
                   "    return time.time() - t0\n")
    codes = {}
    for pkg in ("ant_ray_tpu", "ant_ray_tpu_torch"):
        clean = subprocess.run(
            [sys.executable, "-m", f"{pkg}._lint", "-q"], cwd=REPO,
            capture_output=True, text=True, timeout=120)
        dirty = subprocess.run(
            [sys.executable, "-m", f"{pkg}._lint", str(bad)], cwd=REPO,
            capture_output=True, text=True, timeout=120)
        assert "banned-apis" in dirty.stdout
        codes[pkg] = (clean.returncode, dirty.returncode)
    assert codes["ant_ray_tpu_torch"] == codes["ant_ray_tpu"] == (0, 1)


def test_cli_list_rules_names_every_checker():
    outs = {}
    for pkg in ("ant_ray_tpu", "ant_ray_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}._lint", "--list-rules"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0
        outs[pkg] = proc.stdout
    for rule in ("blocking-under-lock", "blocking-in-async",
                 "banned-apis", "baseexception-swallow",
                 "response-truthiness", "wire-schema-drift",
                 "frame-schema-drift", "pickle-in-hot-path",
                 "metric-tag-cardinality"):
        assert rule in outs["ant_ray_tpu_torch"], rule
    assert "ant_ray_tpu_torch/_private/" in outs["ant_ray_tpu_torch"]
    assert _unport(outs["ant_ray_tpu_torch"]) == \
        _untagged(outs["ant_ray_tpu"])


def test_cli_baseline_update_refuses_path_arguments(tmp_path):
    some = tmp_path / "a.py"
    some.write_text("x = 1\n")
    procs = [subprocess.run(
        [sys.executable, "-m", f"{pkg}._lint", str(some),
         "--baseline-update"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
        for pkg in ("ant_ray_tpu", "ant_ray_tpu_torch")]
    assert [p.returncode for p in procs] == [2, 2]
    # The error line (argparse's usage above it wraps at the prog's
    # length, which the package's name changes).
    errors = [p.stderr.strip().splitlines()[-1] for p in procs]
    assert "without path arguments" in errors[1]
    assert _unport(errors[1]) == errors[0]


def test_lint_full_pass_stays_fast():
    t0 = time.monotonic()
    result = F.run_lint()
    elapsed = time.monotonic() - t0
    assert result.files_checked > 100
    assert elapsed < 30.0, f"lint pass took {elapsed:.1f}s"


def test_baseline_file_is_valid_json_with_schema():
    with open(F.default_baseline_path()) as f:
        data = json.load(f)
    assert isinstance(data.get("findings"), list)
    assert os.path.dirname(F.default_baseline_path()).endswith(
        os.path.join("ant_ray_tpu_torch", "_lint"))


# ----------------------------------------------------- frame-schema drift

def _frame_drift(kinds, tables, snapshot):
    out = []
    for checkers, framework in ((RC, RF), (C, F)):
        checker = checkers.FrameSchemaDriftChecker(
            kinds=kinds, tables=tables, snapshot=snapshot)
        out.append(list(checker.check_project(framework.package_root())))
    ref, port = out
    assert all(f.path == "ant_ray_tpu_torch/_private/hotframe.py"
               for f in port)
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    return port


_KINDS = {"REQ": 0, "HOT": 6, "HOT_CALL": 2}
_TABLES = {"hot_template_fields": ["function_id", "function_name"],
           "hot_call_fields": ["task_id", "sequence_no"]}


def _frame_snap(kinds=None, tables=None):
    return {"frame_kinds": kinds if kinds is not None else dict(_KINDS),
            **(tables if tables is not None else
               {k: list(v) for k, v in _TABLES.items()})}


def test_frame_drift_clean_when_all_agree():
    assert not _frame_drift(_KINDS, _TABLES, _frame_snap())


def test_frame_drift_changed_kind_value_fails():
    findings = _frame_drift(dict(_KINDS, HOT=9), _TABLES, _frame_snap())
    assert any("changed" in f.message and "frozen" in f.message
               for f in findings)


def test_frame_drift_removed_kind_fails():
    kinds = dict(_KINDS)
    del kinds["HOT_CALL"]
    findings = _frame_drift(kinds, _TABLES, _frame_snap())
    assert any("gone from the tree" in f.message for f in findings)


def test_frame_drift_new_kind_needs_snapshot_update():
    findings = _frame_drift(dict(_KINDS, HOT_NEW=7), _TABLES,
                            _frame_snap())
    assert any("--baseline-update" in f.message for f in findings)


def test_frame_drift_field_reorder_fails_append_passes():
    reordered = {"hot_template_fields": ["function_name", "function_id"],
                 "hot_call_fields": list(_TABLES["hot_call_fields"])}
    findings = _frame_drift(_KINDS, reordered, _frame_snap())
    assert any("append-only" in f.message for f in findings)
    grown = {"hot_template_fields":
             [*_TABLES["hot_template_fields"], "new_field"],
             "hot_call_fields": list(_TABLES["hot_call_fields"])}
    findings = _frame_drift(_KINDS, grown, _frame_snap())
    assert len(findings) == 1 and "--baseline-update" in \
        findings[0].message


def test_frame_snapshot_matches_committed_tree():
    """The port's wire_frames.json tracks its live constants and tables
    and equals the reference's snapshot."""
    kinds, tables = C.live_frame_schema()
    snapshot = C.load_frame_snapshot()
    assert snapshot.get("frame_kinds") == kinds
    for table, live in tables.items():
        assert snapshot.get(table) == live
    assert snapshot == RC.load_frame_snapshot()


# ----------------------------------------------------- pickle-in-hot-path

def test_pickle_in_hot_path_fires_outside_blessed_helpers():
    src = """
        import pickle

        def send_request(self, method, payload):
            return pickle.dumps((method, payload), protocol=5)
    """
    findings = lint_src(src, "PickleInHotPathChecker",
                        rel="ant_ray_tpu/_private/protocol.py")
    assert len(findings) == 1
    assert "blessed framing helpers" in findings[0].message


def test_pickle_in_hot_path_blessed_helper_is_silent():
    src = """
        import pickle

        def _encode_frame(msg):
            return pickle.dumps(msg, protocol=5)

        def encode_template(tid, spec):
            return pickle.dumps(spec, protocol=5)
    """
    assert not lint_src(src, "PickleInHotPathChecker",
                        rel="ant_ray_tpu/_private/hotframe.py")


@pytest.mark.parametrize("rel,applies", [
    ("ant_ray_tpu/_private/protocol.py", True),
    ("ant_ray_tpu/_private/hotframe.py", True),
    ("ant_ray_tpu/_private/gcs.py", False),
    ("ant_ray_tpu/serve/api.py", False),
])
def test_pickle_in_hot_path_scoped_to_framing_layer(rel, applies):
    assert _applies("PickleInHotPathChecker", rel) is applies


def test_pickle_in_hot_path_suppression_works():
    src = """
        import pickle

        def hot_send(self, payload):
            # artlint: disable=pickle-in-hot-path — measured cold path
            return pickle.dumps(payload)
    """
    assert not lint_src(src, "PickleInHotPathChecker",
                        rel="ant_ray_tpu/_private/protocol.py")


# ----------------------------------------------- metric-tag-cardinality

def test_metric_tag_cardinality_fires_on_tags_and_tag_keys():
    src = """
        def report(self, task_id, dur):
            self._latency.observe(dur, tags={"task_id": task_id})
            hist = Histogram("art_task_s", tag_keys=("node_id", "trace_id"))
            self._count.inc(1, tags={"node_id": "n", "request_id": rid})
    """
    findings = lint_src(src, "MetricTagCardinalityChecker")
    assert len(findings) == 3
    assert all(f.rule == "metric-tag-cardinality" for f in findings)
    messages = " ".join(f.message for f in findings)
    assert "task_id" in messages and "trace_id" in messages \
        and "request_id" in messages


def test_metric_tag_cardinality_fix_and_exemplar_are_silent():
    src = """
        def report(self, task_id, dur):
            self._latency.observe(dur, tags={"node_id": "n"},
                                  exemplar=task_id)
            hist = Histogram("art_task_s", tag_keys=("node_id", "method"))
            self._count.inc(1)
    """
    assert not lint_src(src, "MetricTagCardinalityChecker")


def test_metric_tag_cardinality_under_matches_non_metric_calls():
    src = """
        def other(self, task_id):
            self._event.set()
            tags = {"task_id": task_id}
            self._latency.observe(1.0, tags=tags)
            route(payload, tags={"task_id": task_id})
    """
    assert not lint_src(src, "MetricTagCardinalityChecker")


def test_metric_tag_cardinality_suppression_works():
    src = """
        def report(self, dur, tid):
            # artlint: disable=metric-tag-cardinality — bounded test ids
            self._latency.observe(dur, tags={"task_id": tid})
    """
    assert not lint_src(src, "MetricTagCardinalityChecker")


def test_lint_exports_match_the_reference():
    import ant_ray_tpu._lint as ref
    import ant_ray_tpu_torch._lint as port

    names = ("Checker", "Finding", "LintResult", "ProjectChecker",
             "load_baseline", "run_lint", "save_baseline",
             "ALL_CHECKERS", "FILE_CHECKERS", "PROJECT_CHECKERS")
    for name in names:
        assert hasattr(ref, name) and hasattr(port, name), name
    assert [c.rule for c in port.ALL_CHECKERS] == \
        [c.rule for c in ref.ALL_CHECKERS]
    assert [c.prevents for c in port.ALL_CHECKERS] == \
        [_untagged(c.prevents) for c in ref.ALL_CHECKERS]
    from ant_ray_tpu_torch._lint import lockcheck

    assert callable(lockcheck.make_lock)
