"""Mean wall of the traced window's ``decode`` phases (the program's
``StepProfiler``; the phase ends when the sampled ids reach the host),
in ms."""

from portbench.readers import decode_step_ms


def read(run):
    return decode_step_ms(run)
