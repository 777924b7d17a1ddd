"""90th percentile, over the requests finished in the window, of
(last token - first token) / (output tokens - 1)."""

from portbench.readers import p90, tpots


def read(run):
    value = p90(tpots(run))
    return None if value is None else value * 1e3
