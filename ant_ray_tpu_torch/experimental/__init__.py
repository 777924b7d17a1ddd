"""Experimental subsystems of the port (the counterpart of
``ant_ray_tpu.experimental``, mirroring python/ray/experimental/): the
shared-memory channels that compiled DAGs run over (``channel``), device
objects (``device_objects``) and their tensor transports
(``tensor_transport``)."""
