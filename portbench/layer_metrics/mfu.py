"""Model FLOPs of the traced window's engine steps (prefill over the
real tokens, decode over each active slot's context, causal attention,
no embedding FLOPs) over the steps' summed walls (the program's
``StepProfiler``) times 989 TFLOP/s, in %."""

from portbench.readers import serve_mfu


def read(run):
    return serve_mfu(run)
