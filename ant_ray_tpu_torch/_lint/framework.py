"""Checker framework: findings, suppression comments, the shrink-only
baseline, and the driver that walks a tree and runs every checker.

stdlib-``ast`` only, by design — the linter must run anywhere the
package imports, with zero new dependencies.
"""

from __future__ import annotations

import ast
import json
import os
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable

_SUPPRESS_RE = re.compile(r"#\s*artlint:\s*disable=([\w\-, ]+)")

#: Directories never linted (generated/caches).
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache"}


@dataclass(frozen=True)
class Finding:
    """One violation at ``path:line``.

    ``text`` is the stripped source line — baseline matching keys on
    ``(rule, path, text)`` rather than the line number, so grandfathered
    entries survive unrelated edits shifting lines above them.
    """

    rule: str
    path: str          # repo-relative, posix separators
    line: int
    message: str
    text: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def baseline_key(self) -> tuple:
        return (self.rule, self.path, self.text)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "text": self.text}

    def render(self) -> str:
        return f"{self.location}: [{self.rule}] {self.message}"


class Checker:
    """Base for per-file AST checkers.

    Subclasses set ``rule`` (the suppression/baseline id), ``prevents``
    (one line naming the historical bug the rule encodes — surfaced by
    ``--list-rules`` and the README table), and optionally ``scope``
    (package-relative path prefixes; None = every file).  Implement
    :meth:`check` yielding Findings; suppression and baseline filtering
    happen in the driver.
    """

    rule: str = ""
    prevents: str = ""
    scope: tuple[str, ...] | None = None

    def applies_to(self, rel_path: str) -> bool:
        if self.scope is None:
            return True
        return any(rel_path.startswith(p) or rel_path == p.rstrip("/")
                   for p in self.scope)

    def check(self, rel_path: str, tree: ast.AST,
              lines: list[str]) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, rel_path: str, node: ast.AST, message: str,
                lines: list[str]) -> Finding:
        line = getattr(node, "lineno", 1)
        text = lines[line - 1].strip() if 0 < line <= len(lines) else ""
        return Finding(self.rule, rel_path, line, message, text)


class ProjectChecker:
    """Base for whole-project checkers (cross-file invariants like the
    wire-schema registry).  Run once per lint pass, only when the pass
    targets the whole package (explicit file arguments skip them)."""

    rule: str = ""
    prevents: str = ""

    def check_project(self, package_root: str) -> Iterable[Finding]:
        raise NotImplementedError


# ------------------------------------------------------------ suppression

def suppressed_rules(lines: list[str], line: int) -> set[str]:
    """Rules disabled at ``line`` (1-based): a directive on the line
    itself, or anywhere in the contiguous block of standalone comment
    lines directly above it (rationales are encouraged to run long)."""
    rules: set[str] = set()

    def collect(idx: int) -> None:
        m = _SUPPRESS_RE.search(lines[idx])
        if m:
            rules.update(r.strip() for r in m.group(1).split(",")
                         if r.strip())

    if 0 <= line - 1 < len(lines):
        collect(line - 1)
    idx = line - 2
    while 0 <= idx < len(lines) and lines[idx].lstrip().startswith("#"):
        collect(idx)
        idx -= 1
    return rules


def is_suppressed(finding: Finding, lines: list[str]) -> bool:
    rules = suppressed_rules(lines, finding.line)
    return finding.rule in rules or "all" in rules


# --------------------------------------------------------------- baseline

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: str | None = None) -> list[dict]:
    path = path or default_baseline_path()
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    return data.get("findings", []) if isinstance(data, dict) else data


def save_baseline(findings: list[Finding], path: str | None = None) -> None:
    path = path or default_baseline_path()
    entries = sorted((f.to_json() for f in findings),
                     key=lambda e: (e["rule"], e["path"], e["line"]))
    with open(path, "w") as f:
        json.dump({"comment": "artlint grandfathered findings — may only "
                              "shrink; regenerate with --baseline-update",
                   "findings": entries}, f, indent=1)
        f.write("\n")


def _baseline_counter(entries: list[dict]) -> Counter:
    return Counter((e.get("rule", ""), e.get("path", ""),
                    e.get("text", "")) for e in entries)


# ----------------------------------------------------------------- driver

@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)      # new, fatal
    baselined: list[Finding] = field(default_factory=list)     # grandfathered
    stale_baseline: list[dict] = field(default_factory=list)   # must prune
    suppressed: int = 0
    files_checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings and not self.stale_baseline


def iter_py_files(target: str) -> Iterable[str]:
    if os.path.isfile(target):
        yield target
        return
    for root, dirs, files in os.walk(target):
        dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def package_root() -> str:
    """The ``ant_ray_tpu_torch`` package directory this module lives in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path),
                          os.path.dirname(os.path.abspath(root)))
    if rel.startswith(".."):     # outside the repo: keep the real path
        return os.path.abspath(path).replace(os.sep, "/")
    return rel.replace(os.sep, "/")


def run_lint(targets: list[str] | None = None,
             checkers: list | None = None,
             baseline: list[dict] | None = None,
             with_project_checkers: bool | None = None) -> LintResult:
    """Run ``checkers`` over ``targets`` (default: the whole package).

    Returns a :class:`LintResult`: ``findings`` are NEW violations
    (post-suppression, post-baseline) — a non-empty list fails CI;
    ``stale_baseline`` entries no longer match any finding and must be
    pruned with ``--baseline-update`` (the shrink-only contract).
    """
    from ant_ray_tpu_torch._lint.checkers import (  # noqa: PLC0415 — cycle
        FILE_CHECKERS, PROJECT_CHECKERS)

    root = package_root()
    explicit_targets = targets is not None
    targets = targets or [root]
    if checkers is None:
        checkers = list(FILE_CHECKERS)
        project_checkers = list(PROJECT_CHECKERS)
    else:
        project_checkers = [c for c in checkers
                            if isinstance(c, ProjectChecker)]
        checkers = [c for c in checkers if isinstance(c, Checker)]
    if with_project_checkers is None:
        with_project_checkers = not explicit_targets
    if baseline is None:
        baseline = load_baseline()

    result = LintResult()
    raw: list[tuple[Finding, list[str]]] = []
    for target in targets:
        for path in iter_py_files(target):
            rel = _rel(path, root)
            try:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=path)
            except (OSError, SyntaxError) as e:
                result.findings.append(Finding(
                    "parse-error", rel, getattr(e, "lineno", 1) or 1,
                    f"cannot lint: {e}"))
                continue
            lines = source.splitlines()
            result.files_checked += 1
            for checker in checkers:
                if not checker.applies_to(rel):
                    continue
                for finding in checker.check(rel, tree, lines):
                    raw.append((finding, lines))

    if with_project_checkers:
        for checker in project_checkers:
            for finding in checker.check_project(root):
                raw.append((finding, []))

    remaining = _baseline_counter(baseline)
    for finding, lines in raw:
        if lines and is_suppressed(finding, lines):
            result.suppressed += 1
            continue
        key = finding.baseline_key()
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            result.baselined.append(finding)
            continue
        result.findings.append(finding)

    for (rule, path, text), count in remaining.items():
        if count > 0:
            result.stale_baseline.append(
                {"rule": rule, "path": path, "text": text, "count": count})
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return result
