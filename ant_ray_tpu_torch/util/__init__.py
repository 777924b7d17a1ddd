"""Utilities of the port's runtime (the counterpart of ant_ray_tpu.util):
so far the scheduling strategies that ``core.py`` puts on the wire."""
