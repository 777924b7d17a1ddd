"""Runtime checks of the port's concurrency invariants.

Only the lock factories (:mod:`lockcheck`) are ported so far; the JAX
package's static lint rules check that package's sources and are not
copied.
"""
