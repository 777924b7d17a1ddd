"""Share of the traced window's engine steps (the harness's spans
around ``LLMEngine.step``) in which no operation ran on the device, in
%.  The loop's waits for arrivals lie outside the steps."""

from portbench.readers import device_idle_share


def read(run):
    return device_idle_share(run, "portbench.step")
