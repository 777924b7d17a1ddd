"""Experimental subsystems of the port (the counterpart of
``ant_ray_tpu.experimental``): the shared-memory channels that compiled
DAGs run over (``channel``)."""
