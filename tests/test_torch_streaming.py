"""Streaming generators (``num_returns="streaming"``) in the port against
the JAX package: the twins of tests/test_streaming.py, each run in an
``init(num_cpus=4)`` cluster of each package.  Items, their order and a
mid-stream error (type, function, masked last traceback line) must be
equal; that the consumer holds item 0 while the producer still sleeps
is a timing property, asserted for each package.  Beside them, a stream
of bf16 CPU tensors from an actor method reaches the port's driver
bitwise, in order."""

import time

import numpy as np
import pytest
import torch

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from runtime_twins import both, outcome


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def test_stream_basic(clusters):
    def scenario(art):
        @art.remote(num_returns="streaming")
        def produce(n):
            for i in range(n):
                yield i * 10

        gen = produce.remote(5)
        return [art.get(ref, timeout=30) for ref in gen]

    want, got = both(scenario)
    assert got == want == [0, 10, 20, 30, 40]


def test_first_item_before_producer_finishes(clusters):
    """The consumer holds item 0 while the producer is still sleeping on
    later items (asserted for each package); the items are equal."""
    def scenario(art):
        @art.remote(num_returns="streaming")
        def slow_produce():
            for i in range(4):
                yield i
                time.sleep(0.5)

        gen = slow_produce.remote()
        t0 = time.monotonic()
        first = art.get(next(gen), timeout=30)
        first_latency = time.monotonic() - t0
        # The producer needs ~2 s in all; item 0 must arrive far sooner.
        assert first_latency < 1.0, (art.__name__, first_latency)
        return first, [art.get(r, timeout=30) for r in gen]

    want, got = both(scenario)
    assert got == want == (0, [1, 2, 3])


def test_mid_stream_error_surfaces_after_items(clusters):
    def scenario(art):
        @art.remote(num_returns="streaming")
        def flaky():
            yield "a"
            yield "b"
            raise ValueError("stream exploded")

        gen = flaky.remote()
        items = [art.get(next(gen), timeout=30) for _ in range(2)]
        error = outcome(lambda: next(gen))
        assert error[0] == "raise" and error[1][0] == "TaskError"
        assert "stream exploded" in str(error)
        return items, error

    want, got = both(scenario)
    assert got == want
    assert got[0] == ["a", "b"]


def test_actor_streaming_method(clusters):
    def scenario(art):
        @art.remote
        class Tokenizer:
            def __init__(self):
                self.calls = 0

            @art.method(num_returns="streaming")
            def stream_tokens(self, text):
                self.calls += 1
                for tok in text.split():
                    yield tok

            def get_calls(self):
                return self.calls

        t = Tokenizer.remote()
        gen = t.stream_tokens.remote("the quick brown fox")
        out = ([art.get(r, timeout=30) for r in gen],
               art.get(t.get_calls.remote()))
        art.kill(t)
        return out

    want, got = both(scenario)
    assert got == want == (["the", "quick", "brown", "fox"], 1)


def test_stream_large_items_via_plasma(clusters):
    def scenario(art):
        @art.remote(num_returns="streaming")
        def big_items():
            for i in range(3):
                yield np.full(200_000, i, np.float64)  # 1.6 MB each

        return [float(art.get(r, timeout=60).sum())
                for r in big_items.remote()]

    want, got = both(scenario)
    assert got == want == [0.0, 200_000.0, 400_000.0]


def test_bf16_tensor_stream_from_an_actor_method(clusters):
    """Seeded bf16 CPU tensors yielded by a streaming actor method (1 MiB
    each, in the node's arena) reach the driver bitwise, in order."""
    @tart.remote
    class Producer:
        @tart.method(num_returns="streaming")
        def tensors(self, seed, n, count):
            gen = torch.Generator().manual_seed(seed)
            for _ in range(count):
                yield torch.randn((n, n), generator=gen,
                                  dtype=torch.bfloat16)

    producer = Producer.remote()
    got = [tart.get(r, timeout=60)
           for r in producer.tensors.remote(3, 724, 4)]
    gen = torch.Generator().manual_seed(3)
    want = [torch.randn((724, 724), generator=gen, dtype=torch.bfloat16)
            for _ in range(4)]
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.device.type == "cpu"
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    tart.kill(producer)
