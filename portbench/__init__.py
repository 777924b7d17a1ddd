"""The benchmark of ``ant_ray_tpu_torch`` on one NVIDIA H100.

One run is one process that runs one cell of ``BENCHMARK.json`` once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the model's published sizes, the cuts made
  to them (``reduced``), the sizes assumed, the engine or step settings;
* ``traffic/<traffic>.json``: the driver that runs it, the loop kind,
  the rate or clients, the length distributions, the check's sample and
  limits;
* ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader a metric, ``read(run) -> float | None`` over the run's record;
* ``drivers/<driver>.py``: one per kind of work (serving, training);
* ``reference/<family>.py``: the plain fp32 reference of a model
  family, which imports nothing of the program.

The yardstick (traffic generation, the frozen operation and byte counts,
the peaks, the trace reduction, the references and the comparison that
decides ``correct``) lives here; the program under test is imported only
by the drivers.
"""
