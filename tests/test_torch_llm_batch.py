"""The port's ``build_llm_processor`` (llm/batch.py) against the JAX
package's: both process one Dataset of prompts with engines built on
one HF directory of seeded fp32 weights (tests/test_torch_device_feed.py
writes it), each package in its own cluster, two actors each, the
port's on the CPU (``device="cpu"``).  Greedy generation, so every
row's ``generated_text`` must be equal, and the rows must come back in
input order with their keys unchanged."""

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu.data as jdata
import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.data as tdata
from ant_ray_tpu.llm import SamplingParams as JaxSampling
from ant_ray_tpu.llm.batch import build_llm_processor as jax_build
from ant_ray_tpu_torch.actor import ActorMethod
from ant_ray_tpu_torch.llm import SamplingParams, build_llm_processor
from test_torch_device_feed import write_model_dir


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


def test_llm_processor_generates_as_the_reference(clusters,
                                                  tmp_path_factory):
    model = write_model_dir(tmp_path_factory.mktemp("batch"))
    rows = [{"id": i, "prompt": f"item {i} " * (i + 1)} for i in range(6)]
    outs = []
    for build, data, sampling, kw in (
            (jax_build, jdata, JaxSampling, {}),
            (build_llm_processor, tdata, SamplingParams,
             {"device": "cpu"})):
        process = build(model, concurrency=2, slots=2, max_seq=64,
                        sampling=sampling(max_tokens=6, temperature=0.0),
                        **kw)
        outs.append(process(data.from_items(rows, parallelism=3))
                    .take_all())
    want, got = outs
    assert got == want
    assert [{k: v for k, v in r.items() if k != "generated_text"}
            for r in got] == rows
    assert all(isinstance(r["generated_text"], str) for r in got)
    # Each actor's launch counters: all zero on the CPU, where the
    # attention wrappers run their plain versions.
    for actor in process._actors:
        counts = tart.get(ActorMethod(actor, "_launches", 1, "").remote())
        assert "fwd_sm90_launch_count" in counts
        assert set(counts.values()) == {0}
