"""Bytes the traced window's decode steps must move (every weight once,
each active slot's valid K/V read once, the new K/V and the logits
written) over 3.35 TB/s times the decode phases' summed walls, in %."""

from portbench.readers import decode_bw_share


def read(run):
    return decode_bw_share(run)
