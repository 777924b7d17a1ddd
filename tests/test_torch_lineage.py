"""Lineage reconstruction in the port against the JAX package: the twins
of tests/test_lineage.py (an object freed cluster-wide through the GCS's
``FreeObject`` is rebuilt by re-running its task; a lost ``put`` raises
``ObjectLostError``; a failing replay surfaces its own error; no replay
at ``max_retries=0``), each run in a ``init(num_cpus=2)`` cluster of
each package with the same seeded inputs.  Values must be equal and
exceptions equal by type and masked message.  Beside them, a bf16 CPU
tensor is rebuilt bitwise by the port, its task run twice (the CPU
counterpart of chip_smoke's CUDA lineage step)."""

import os

import numpy as np
import pytest
import torch

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from runtime_twins import both, free_all_copies, outcome


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=2)
    try:
        tart.init(num_cpus=2)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _big(seed: int) -> np.ndarray:
    # Big enough to take the plasma path (not inlined).
    return np.random.default_rng(seed).standard_normal(500_000)


def test_lineage_reconstruction(clusters):
    def scenario(art):
        @art.remote
        def make():
            return _big(0)

        ref = make.remote()
        first = art.get(ref)
        free_all_copies(art, ref)
        again = art.get(ref, timeout=60)
        assert np.array_equal(again, first)
        return float(again.sum()), again.shape

    want, got = both(scenario)
    assert got == want


def test_lost_object_without_lineage_raises(clusters):
    def scenario(art):
        ref = art.put(_big(1))   # driver put: no producing task to re-run
        free_all_copies(art, ref)
        result = outcome(lambda: art.get(ref, timeout=30))
        assert result[0] == "raise" and result[1][0] == "ObjectLostError"
        return result

    want, got = both(scenario)
    assert got == want


def test_reconstruction_replay_error_surfaces(clusters, tmp_path):
    """If the lineage replay itself fails, the task error surfaces
    instead of an opaque lost-object error."""
    def scenario(art):
        marker = str(tmp_path / f"{art.__name__}.ran_once")

        @art.remote
        def flaky_make(path):
            if os.path.exists(path):
                raise RuntimeError("replay exploded")
            with open(path, "w") as f:
                f.write("x")
            return _big(2)

        ref = flaky_make.remote(marker)
        art.get(ref)
        free_all_copies(art, ref)
        result = outcome(lambda: art.get(ref, timeout=60))
        assert result[0] == "raise" and "replay exploded" in str(result)
        return result

    want, got = both(scenario)
    assert got == want


def test_no_reconstruction_when_max_retries_zero(clusters):
    def scenario(art):
        @art.remote(max_retries=0)
        def make_once():
            return _big(3)

        ref = make_once.remote()
        art.get(ref)
        free_all_copies(art, ref)
        result = outcome(lambda: art.get(ref, timeout=30))
        assert result[0] == "raise" and result[1][0] == "ObjectLostError"
        return result

    want, got = both(scenario)
    assert got == want


def test_bf16_tensor_rebuilt_bitwise_by_a_second_run(clusters, tmp_path):
    """A task's seeded bf16 CPU tensor (2 MiB, in the node's arena),
    freed cluster-wide, comes back from a second run of its task bitwise
    equal to the first get and to the seeded regeneration; a ``put``
    tensor freed the same way raises ``ObjectLostError``."""
    runs = tmp_path / "runs"

    @tart.remote
    def random_tensor(seed, n, log):
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\n")
        gen = torch.Generator().manual_seed(seed)
        return torch.randn((n, n), generator=gen, dtype=torch.bfloat16)

    ref = random_tensor.remote(7, 1024, str(runs))
    first = tart.get(ref, timeout=60)
    free_all_copies(tart, ref)
    again = tart.get(ref, timeout=60)
    want = torch.randn((1024, 1024), generator=torch.Generator()
                       .manual_seed(7), dtype=torch.bfloat16)
    assert again.dtype == torch.bfloat16 and again.device.type == "cpu"
    assert torch.equal(again.view(torch.int16), first.view(torch.int16))
    assert torch.equal(again.view(torch.int16), want.view(torch.int16))
    assert len(runs.read_text().splitlines()) == 2

    put_ref = tart.put(want)
    free_all_copies(tart, put_ref)
    result = outcome(lambda: tart.get(put_ref, timeout=30))
    assert result[0] == "raise" and result[1][0] == "ObjectLostError"
