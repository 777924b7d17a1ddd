"""Arithmetic the metric readers share.  A reader that finds nothing to
read returns None, and the run leaves its metric out."""

from __future__ import annotations

import numpy as np

from portbench import counts


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(values, q)) if len(values) else None


def p90(values) -> float | None:
    return percentile(values, 90)


def ttfts(run) -> list[float]:
    """Seconds from each request's due time to its first token; one
    still waiting at the window's close counts the wait it has had."""
    close = run.window_close
    out = []
    for s in run.served:
        first = next((t for t in s.token_times[:1] if t <= close), None)
        out.append((close if first is None else first) - s.due)
    return out


def tpots(run) -> list[float]:
    """Seconds a token after the first, of each request finished in the
    window with two tokens or more."""
    return [(s.token_times[-1] - s.token_times[0]) / (len(s.token_times) - 1)
            for s in run.served
            if s.error is None and s.done is not None
            and s.done <= run.window_close and len(s.token_times) > 1]


def serve_flops(run) -> float:
    c = run.counts
    total = 0.0
    for st in run.steps:
        total += sum(c.prefill_flops(n) for _, n in st.prefills)
        if st.decode_contexts:
            total += c.decode_flops(st.decode_contexts)
    return total


def serve_mfu(run) -> float | None:
    """Model FLOPs of the traced window's engine steps over the steps'
    summed walls times 989 TFLOP/s, in %."""
    walls = sum(st.total_s for st in run.steps)
    if not walls:
        return None
    return 100.0 * serve_flops(run) / (walls * counts.PEAK_BF16_FLOPS)


def _decode_steps(run) -> list:
    return [st for st in run.steps
            if st.decode_contexts and st.phases.get("decode")]


def decode_step_ms(run) -> float | None:
    """Mean wall of the traced window's ``decode`` phases, in ms."""
    steps = _decode_steps(run)
    if not steps:
        return None
    return 1e3 * sum(st.phases["decode"] for st in steps) / len(steps)


def decode_bw_share(run) -> float | None:
    """Bytes the window's decode steps must move (every weight, each
    active slot's valid K/V, the new K/V and logits) over 3.35 TB/s
    times the decode phases' summed walls, in %."""
    steps = _decode_steps(run)
    if not steps:
        return None
    nbytes = sum(run.counts.decode_bytes(st.decode_contexts) for st in steps)
    walls = sum(st.phases["decode"] for st in steps)
    return 100.0 * nbytes / (walls * counts.PEAK_HBM_BYTES_PER_S)


def device_idle_share(run, span: str) -> float | None:
    """Share of the harness's ``span`` intervals (the window's steps) in
    which no operation ran on the device, in %."""
    if run.trace is None:
        return None
    busy, length = run.trace.busy_within(span)
    if not length or not busy:
        return None
    return 100.0 * (1.0 - busy / length)


def prefill_ms_per_ktok(run) -> float | None:
    tokens = sum(n for st in run.steps for _, n in st.prefills)
    spent = run.trace.device_s("portbench.prefill") if run.trace else 0.0
    if not tokens or not spent:
        return None
    return spent * 1e6 / tokens
