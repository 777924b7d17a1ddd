"""The node daemon's lease dependencies in the port against the JAX
package: the twins of tests/test_lease_deps.py (a lease's plasma
argument is pulled by the executing node's daemon before the grant; a
lease whose argument is another task's pending output still grants and
runs), on a two-node ``Cluster`` of each package (a 1-CPU head and a
1-CPU node labelled ``role=exec``), both built once for the module.
Values and the daemon's prefetch verdict must be equal."""

import numpy as np
import pytest

from runtime_twins import PACKAGES, both, mod


@pytest.fixture(scope="module")
def clusters():
    made = {}
    try:
        for art in PACKAGES:
            cluster = mod(art, "cluster_utils").Cluster(
                head_node_args={"num_cpus": 1})
            made[art] = (cluster, None)
            made[art] = (cluster, cluster.add_node(
                num_cpus=1, labels={"role": "exec"}))
            cluster.connect()
        yield {art: address for art, (_c, address) in made.items()}
    finally:
        for art, (cluster, _a) in made.items():
            art.shutdown()
            cluster.shutdown()


def test_args_prefetched_before_grant(clusters):
    """A big plasma argument headed to a remote node is pulled by that
    node's daemon as part of the lease, before the worker runs."""
    def scenario(art):
        big = art.put(np.arange(2_000_000, dtype=np.float64))  # 16 MB

        @art.remote
        def consume(arr):
            return float(arr[-1])

        out = art.get(consume.options(
            num_cpus=1, label_selector={"role": "exec"}).remote(big),
            timeout=120)
        stats = mod(art, "_private.protocol").ClientPool().get(
            clusters[art]).call("GetSyncStats", {}, timeout=10)
        assert stats.get("dep_prefetches", 0) >= 1, \
            f"{art.__name__}: lease deps never prefetched ({stats})"
        return out, stats.get("dep_prefetches", 0) >= 1

    want, got = both(scenario)
    assert got == want == (1_999_999.0, True)


def test_pending_dep_does_not_deadlock(clusters):
    """A lease whose argument is a not yet produced output still grants
    and runs: the daemon's bounded wait holds no resources."""
    def scenario(art):
        @art.remote
        def produce():
            return np.ones(500_000, dtype=np.float64)  # 4 MB, plasma

        @art.remote
        def consume(arr):
            return float(arr.sum())

        ref = produce.remote()
        return art.get(consume.options(
            num_cpus=1, label_selector={"role": "exec"}).remote(ref),
            timeout=120)

    want, got = both(scenario)
    assert got == want == 500_000.0
