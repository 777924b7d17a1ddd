"""The port's tensor-parallel LLMEngine against the JAX package's
(tests/test_llm_tp.py's cases): the mesh and shard layout, greedy tokens
of a tp=2 engine equal to the single engine's and to the JAX tp=2
engine's on ``tiny``, the "divide" ValueError; and beyond the reference's
file: a chunked-prefill request, sampled requests, and a session turn
offloaded and restored, at tp=2 with the single engine's tokens, and
LLMServer reaching the TP engine.  The port's mesh is two CPU cells (a
virtual mesh), the JAX package's two of its virtual CPU devices.

Tokens are compared exactly: fp32 on the CPU, where the partial products
summed over tp move logits by ~1e-7, far from any near-tie of these
prompts (the same bound the reference's test holds)."""

import numpy as np
import pytest
import torch

import jax

from ant_ray_tpu.llm import LLMEngine as JEngine
from ant_ray_tpu.llm import SamplingParams as JSampling
from ant_ray_tpu.models import llama as jl
from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams
from ant_ray_tpu_torch.llm.serve_llm import LLMServer
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.parallel import build_mesh, spmd

PROMPT = [3, 5, 7, 11, 13, 17]
LONG = np.random.RandomState(0).randint(0, 256, 200).tolist()


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jl.CONFIGS["tiny"], jax.random.PRNGKey(7))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                    tl.CONFIGS["tiny"], device="cpu")
    return jparams, tparams


def _engine(tparams, **kwargs):
    return LLMEngine("tiny", params=tparams, slots=2, device="cpu", **kwargs)


def test_tp_engine_builds_mesh_and_shards(weights):
    engine = _engine(weights[1], tensor_parallel_size=2)
    assert engine.mesh is not None and engine.mesh.shape["tp"] == 2
    assert engine.mesh.size == 2 and engine.mesh.is_virtual
    # wq splits its head dim over tp; the KV slab splits kv-heads.
    wq = engine.params["layers"]["wq"]    # stacked (n_layers, ...) leaf
    assert "tp" in str(wq.sharding.spec)
    assert [tuple(s.shape) for s in wq.shards] == [(2, 64, 32)] * 2
    assert str(engine.cache["k"].sharding.spec).count("tp") == 1
    assert [tuple(s.shape) for s in engine.cache["k"].shards] == \
        [(2, 2, 512, 1, 16)] * 2
    assert engine.device == torch.device("cpu")
    jengine = JEngine("tiny", params=weights[0], slots=2,
                      tensor_parallel_size=2)
    assert tuple(jengine.params["layers"]["wq"].sharding.spec) == \
        tuple(wq.sharding.spec)
    assert tuple(jengine.cache["k"].sharding.spec) == \
        tuple(engine.cache["k"].sharding.spec)


def test_tp_prefill_decode_parity(weights):
    jparams, tparams = weights
    single = _engine(tparams).generate(
        [PROMPT], SamplingParams(max_tokens=6, temperature=0.0))[0]
    tp2 = _engine(tparams, tensor_parallel_size=2).generate(
        [PROMPT], SamplingParams(max_tokens=6, temperature=0.0))[0]
    jtp2 = JEngine("tiny", params=jparams, slots=2,
                   tensor_parallel_size=2).generate(
        [PROMPT], JSampling(max_tokens=6, temperature=0.0))[0]
    assert single.token_ids == tp2.token_ids == jtp2.token_ids


def test_tp_must_divide_heads(weights):
    with pytest.raises(ValueError, match="divide"):
        _engine(weights[1], tensor_parallel_size=3)  # n_heads=4, kv 2


def test_tp_on_cuda_needs_that_many_cards(weights):
    """Without a prebuilt mesh, tp=N takes N distinct cards and never
    repeats one: with fewer it raises as the reference's build_mesh."""
    if torch.cuda.is_available():
        pytest.skip("the card case: build_mesh over the visible cards")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine("tiny", params=weights[1], slots=2,
                  tensor_parallel_size=2)


@pytest.mark.parametrize("chunk", [None, 64])
def test_tp_chunked_and_sampled_requests_match_single(weights, chunk):
    sampled = SamplingParams(max_tokens=8, temperature=0.8, top_k=20,
                             top_p=0.9, seed=3)
    greedy = SamplingParams(max_tokens=8)
    outs = []
    for tp in (1, 2):
        engine = _engine(weights[1], tensor_parallel_size=tp,
                         prefill_chunk_tokens=chunk)
        outs.append([o.token_ids for o in engine.generate(
            [LONG, PROMPT], sampled)] + [o.token_ids for o in
                                         engine.generate([LONG], greedy)])
    assert outs[0] == outs[1]


def _session_turns(engine):
    got = []
    engine.add_request(LONG[:50], SamplingParams(max_tokens=4),
                       session_id="s")
    while engine.has_unfinished():
        got += [o.token_ids for o in engine.step() if o.finished]
    assert engine.evict_session("s")
    engine.add_request(LONG[50:70], SamplingParams(max_tokens=4),
                       session_id="s")
    while engine.has_unfinished():
        got += [o.token_ids for o in engine.step() if o.finished]
    return got, engine.stats["offloads"], engine.stats["restores"]


def test_tp_session_offload_and_restore_match_single(weights):
    """A session turn at tp=2 whose slab is offloaded (the cells' KV
    heads gathered into one host slot) and restored (split back) gives
    the single engine's tokens, and the host slab is the single
    engine's bit for bit."""
    single = _engine(weights[1], prefill_chunk_tokens=32)
    tp2 = _engine(weights[1], prefill_chunk_tokens=32,
                  tensor_parallel_size=2)
    want = _session_turns(single)
    assert want[1:] == (1, 1) and _session_turns(tp2) == want
    k1, v1, n1 = tl.extract_slot(single.cache, 0)
    k2, v2, n2 = tl.extract_slot(tp2.cache, 0)
    assert n1 == n2 and torch.equal(k1, k2) and torch.equal(v1, v2)
    cache = tl.init_kv_cache(tl.CONFIGS["tiny"], 2, mesh=tp2.mesh)
    tl.install_slot(cache, k1, v1, n1, 1)
    assert isinstance(cache["k"], spmd.ShardedTensor)
    assert torch.equal(cache["k"].full()[:, 1], k1)
    assert torch.equal(cache["v"].full()[:, 1], v1)


def test_tp_engine_on_a_prebuilt_mesh_and_through_llm_server(weights):
    mesh = build_mesh(devices=["cpu"] * 2, tp=2)
    engine = LLMEngine("tiny", params=weights[1], slots=2, mesh=mesh)
    assert engine.mesh is mesh and engine.device == torch.device("cpu")
    want = _engine(weights[1]).generate(
        [PROMPT], SamplingParams(max_tokens=5))[0].token_ids
    assert engine.generate([PROMPT], SamplingParams(
        max_tokens=5))[0].token_ids == want
    server = LLMServer("tiny", slots=2, device="cpu", tensor_parallel_size=2,
                       kv_offload=None)
    try:
        assert server.engine.mesh.shape["tp"] == 2
        reply = server({"prompt": PROMPT, "max_tokens": 5})
        single = LLMServer("tiny", slots=2, device="cpu", kv_offload=None)
        try:
            assert reply["choices"][0]["token_ids"] == single(
                {"prompt": PROMPT, "max_tokens": 5})["choices"][0][
                    "token_ids"]
        finally:
            single.shutdown()
    finally:
        server.shutdown()
