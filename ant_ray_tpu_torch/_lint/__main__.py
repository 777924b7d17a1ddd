"""``python -m ant_ray_tpu_torch._lint`` — run every checker.

Exit status: 0 when the tree is clean (no new findings AND no stale
baseline entries), 1 otherwise.  ``--baseline-update`` regenerates both
the grandfathered-findings baseline and the additive-only wire-method
snapshot from the current tree, then exits 0.
"""

from __future__ import annotations

import argparse
import sys

from ant_ray_tpu_torch._lint import checkers as _checkers
from ant_ray_tpu_torch._lint.framework import (
    load_baseline,
    run_lint,
    save_baseline,
)


def _list_rules() -> None:
    for checker in _checkers.ALL_CHECKERS:
        scope = getattr(checker, "scope", None)
        where = ", ".join(scope) if scope else "whole package"
        print(f"{checker.rule}\n    scope:    {where}\n"
              f"    prevents: {checker.prevents}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ant_ray_tpu_torch._lint",
        description="artlint: project-native concurrency & protocol "
                    "static analysis")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the whole "
                             "ant_ray_tpu_torch package + project checkers)")
    parser.add_argument("--baseline-update", action="store_true",
                        help="regenerate baseline.json and "
                             "wire_methods.json from the current tree")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report grandfathered findings as fatal")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        _list_rules()
        return 0

    if args.baseline_update:
        if args.paths:
            # A partial pass would overwrite the GLOBAL baseline with
            # one file's findings, silently dropping every other
            # grandfathered entry.
            parser.error("--baseline-update regenerates the global "
                         "baseline; run it without path arguments")
        # Full pass with an empty baseline: everything unsuppressed and
        # not fixed right now is grandfathered (shrink-only from here).
        result = run_lint(None, baseline=[])
        keep = [f for f in result.findings
                if f.rule not in (
                    _checkers.WireSchemaDriftChecker.rule,
                    _checkers.FrameSchemaDriftChecker.rule)]
        save_baseline(keep)
        _checkers.save_snapshot()
        _checkers.save_frame_snapshot()
        print(f"baseline: {len(keep)} grandfathered finding(s); wire "
              f"+ frame snapshots refreshed "
              f"({result.files_checked} files checked)")
        return 0

    baseline = [] if args.no_baseline else load_baseline()
    result = run_lint(args.paths or None, baseline=baseline)

    for finding in result.findings:
        print(finding.render())
    for entry in result.stale_baseline:
        print(f"{entry['path']}: [baseline-stale] grandfathered "
              f"{entry['rule']} finding no longer fires "
              f"({entry['text'][:60]!r}) — shrink the baseline with "
              "--baseline-update")

    if not args.quiet:
        print(f"artlint: {result.files_checked} files, "
              f"{len(result.findings)} finding(s), "
              f"{len(result.baselined)} baselined, "
              f"{result.suppressed} suppressed, "
              f"{len(result.stale_baseline)} stale baseline entr"
              f"{'y' if len(result.stale_baseline) == 1 else 'ies'}",
              file=sys.stderr)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
