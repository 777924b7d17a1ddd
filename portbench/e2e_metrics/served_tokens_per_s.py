"""Unpadded prompt tokens plus served tokens of the requests finished in
the window, over the window's length."""

from portbench.drivers.serve import finished


def read(run):
    done = finished(run)
    if not done:
        return None
    return sum(s.prompt_len + len(s.tokens) for s in done) / run.window_s
