"""Object spilling under store pressure in the port against the JAX
package: the twin of tests/test_spill.py — six 8 MB puts into a 32 MB
node store, and every one read back equal — in an
``init(num_cpus=2, object_store_memory=32 MiB)`` cluster of each package
in turn (the port exports the store's size to its processes as an
``ART_*`` variable, which both packages read).  The values' sums must
be equal.

The JAX package's ``init`` sets ``object_store_memory`` in the driver's
own config only, so its node store keeps the default capacity and
nothing spills there (ROADMAP §C, "Reference-side faults"); the twin
asserts that the port's store did spill, and keeps the reference's
assertions for both.  A bf16 tensor spilled the same way comes back
bitwise in the port."""

import numpy as np
import torch

from runtime_twins import PACKAGES, outcome, runtime


def _spill_roundtrip(art, values, equal):
    """Puts ``values`` into a 32 MiB store, then gets each back and
    holds it to ``equal`` (a reader is dropped before the next get, as
    the reference's loop drops it).  Returns the store's spilled bytes
    after the puts and each value's ``equal`` verdict."""
    art.init(num_cpus=2, object_store_memory=32 * 1024 * 1024)
    try:
        refs = []
        for i, value in enumerate(values):      # ~48 MB > the 32 MB store
            refs.append(art.put(value))
            # Sealed before the next put forces an eviction, so the
            # spiller only ever sees sealed objects.
            ready, _ = art.wait([refs[-1]], num_returns=1, timeout=60)
            assert ready, f"object {i} never sealed under store pressure"
        spilled = runtime(art)._node.call("GetStoreStats", {},
                                          timeout=10)["spilled"]
        verdicts = []
        for i, (value, ref) in enumerate(zip(values, refs)):
            # An early ref restores from disk; under a loaded host its
            # restore can lose one race with an ongoing eviction, so the
            # reference gets once more after a failed get, as here.
            first = outcome(lambda: art.get(ref, timeout=120))
            got = first[1] if first[0] == "ok" else art.get(ref,
                                                            timeout=120)
            verdicts.append(equal(got, value))
            assert verdicts[-1], f"{art.__name__}: object {i} corrupt"
            del got, first
        return spilled, verdicts
    finally:
        art.shutdown()


def test_spill_cluster_roundtrip():
    arrays = [np.full(1_000_000, i, np.float64) for i in range(6)]
    (j_spilled, want), (spilled, got) = (
        _spill_roundtrip(art, arrays, np.array_equal) for art in PACKAGES)
    assert got == want == [True] * 6
    assert spilled >= 2 * arrays[0].nbytes      # the port's store spilled
    assert j_spilled == 0                       # the reference's did not


def test_bf16_tensors_spill_and_restore_bitwise():
    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn((2048, 2048), generator=gen,
                           dtype=torch.bfloat16) for _ in range(6)]

    def bitwise(got, want):
        return (got.dtype == torch.bfloat16
                and torch.equal(got.view(torch.int16), want.view(torch.int16)))

    spilled, verdicts = _spill_roundtrip(PACKAGES[1], tensors,
                                         bitwise)
    assert spilled >= 2 * tensors[0].numel() * 2
    assert verdicts == [True] * 6
