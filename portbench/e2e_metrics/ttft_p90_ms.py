"""90th percentile, over every request due in the window, of the time
from its due time to its first token (still waiting: its wait so far)."""

from portbench.readers import p90, ttfts


def read(run):
    value = p90(ttfts(run))
    return None if value is None else value * 1e3
