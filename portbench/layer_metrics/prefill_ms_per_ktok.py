"""Device milliseconds of the kernels launched inside the benchmark's
span around each ``prefill_into_cache`` call, per thousand unpadded
prompt tokens, in the traced window."""

from portbench.readers import prefill_ms_per_ktok


def read(run):
    return prefill_ms_per_ktok(run)
