"""Models: the Llama family (inference half) and weight conversion from
the JAX package's numpy pytrees."""
