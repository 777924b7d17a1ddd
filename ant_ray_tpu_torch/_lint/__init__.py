"""Runtime checks of the port's concurrency invariants: the lock
factories and lock-order detector (:mod:`lockcheck`).  The JAX package's
static lint rules check that package's sources and are not ported yet
(ROADMAP queue A item 6.6).
"""
