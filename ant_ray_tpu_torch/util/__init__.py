"""Utilities of the port's runtime (the counterpart of ant_ray_tpu.util):
the scheduling strategies that ``core.py`` puts on the wire, user metrics
(``metrics``), the Chrome-trace timeline (``timeline``) and spans in
OpenTelemetry's shape (``tracing``).  None of them imports torch."""
