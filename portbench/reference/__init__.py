"""Plain fp32 references, one file a model family.  They import
neither ``jax`` nor ``ant_ray_tpu`` nor anything of
``ant_ray_tpu_torch``, and take from the run only the weights and inputs
that the benchmark itself made, and the program's outputs to judge."""
