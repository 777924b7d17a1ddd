"""Set-up: from the process's start to the window's first request or
step (import, weights, cache or optimizer, warm-up)."""


def read(run):
    return run.setup_s
