"""One driver a kind of work; a traffic file names its driver.  A driver
is ``run(run: record.Run, device, profiler_on: bool) -> record.Run``:
it builds the program, warms it, measures for ``run.seconds``, checks
the outputs against the reference and fills the record."""
