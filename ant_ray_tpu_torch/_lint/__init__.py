"""artlint — project-native static analysis for the concurrency and
protocol invariants this codebase has already been burned by (the
JAX package's rules, checking this package's sources).

Every rule here encodes a bug class that actually shipped and was found
late, by review or by a failing cluster, instead of mechanically at
commit time:

* ``banned-apis``          — ``asyncio.iscoroutine`` matched plain
  generators on py<3.12 (root cause of 8 tier-1 failures at once);
  ``time.time()`` in duration arithmetic jumps with NTP steps.
* ``blocking-under-lock``  — a blocking ``col.send()`` under a
  module-global lock serialized every transfer (ADVICE round 5).
* ``blocking-in-async``    — the same blocking set parks the whole
  event loop, not one request.
* ``baseexception-swallow``— broad handlers eat ``PreemptionInterrupt``
  (a BaseException BY DESIGN so user ``except Exception`` can't swallow
  a drain) and ``asyncio.CancelledError``.
* ``response-truthiness``  — an unprepared aiohttp ``web.Response`` has
  ``__len__`` and is FALSY, so ``resp or fallback`` silently replaced a
  typed 429 with a 500 (found in a third review round).
* ``wire-schema-drift``    — a one-off wire lint generalized: METHODS
  ≡ RPC_METHOD_PLANES, every entry well-formed, and an additive-only
  snapshot so a renamed/removed RPC fails loudly instead of silently
  breaking mixed-version peers.

Usage::

    python -m ant_ray_tpu_torch._lint                 # lint the package
    python -m ant_ray_tpu_torch._lint path/to/file.py # explicit files
    python -m ant_ray_tpu_torch._lint --baseline-update

Suppression: ``# artlint: disable=<rule>[,<rule>...] — <why>`` on the
flagged line or the line directly above.  The rationale text is part of
the convention: an allowlisted site must say why it is exempt.

Baseline: ``_lint/baseline.json`` grandfathers pre-existing findings so
the linter can land before the debt is zero.  The baseline may only
shrink — stale entries fail the run until ``--baseline-update`` prunes
them, and tests/test_lint.py keeps the whole suite wired into tier-1.

The runtime sibling — the lock-order / long-hold detector — lives in
:mod:`ant_ray_tpu_torch._lint.lockcheck` (opt-in via ``ART_LOCKCHECK=1``);
it is imported on its own (``from ant_ray_tpu_torch._lint import
lockcheck``), as the planes' lock factories do.
"""

from ant_ray_tpu_torch._lint.framework import (  # noqa: F401
    Checker,
    Finding,
    LintResult,
    ProjectChecker,
    load_baseline,
    run_lint,
    save_baseline,
)
from ant_ray_tpu_torch._lint.checkers import (  # noqa: F401
    ALL_CHECKERS,
    FILE_CHECKERS,
    PROJECT_CHECKERS,
)
