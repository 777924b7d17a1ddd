"""The port's LLMEngine against the JAX package's on the same carried
weights (``tiny``, fp32, CPU, max_seq 256).  Greedy token streams must
be identical; sampled ones can only be held to the port's own
determinism, since ``torch.Generator`` and ``jax.random`` give different
bits."""

import numpy as np
import pytest
import torch

import jax

from ant_ray_tpu.llm import LLMEngine as JaxEngine
from ant_ray_tpu.llm import SamplingParams as JaxSampling
from ant_ray_tpu.models import llama as jl
from ant_ray_tpu_torch.exceptions import BackPressureError
from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy

# TF32 off, so fp32 matmuls compare in full fp32 wherever a card runs them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAX_SEQ = 256
N_TOKENS = 12
# 3, 50 and 100 tokens land in buckets 16, 64 and 128.
PROMPTS = [list(np.random.default_rng(n).integers(0, 250, n))
           for n in (3, 50, 100)]


@pytest.fixture(scope="module")
def weights():
    jparams = jl.init_params(jl.CONFIGS["tiny"], jax.random.PRNGKey(21))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                    tl.CONFIGS["tiny"], device="cpu")
    return jparams, tparams


@pytest.fixture(scope="module")
def jax_greedy(weights):
    engine = JaxEngine("tiny", weights[0], slots=4, max_seq=MAX_SEQ)
    outs = engine.generate(PROMPTS, JaxSampling(max_tokens=N_TOKENS))
    return [(o.token_ids, o.finish_reason) for o in outs]


def _engine(weights, **kw):
    kw.setdefault("slots", 4)
    return LLMEngine("tiny", weights[1], max_seq=MAX_SEQ, device="cpu", **kw)


def _greedy(n=N_TOKENS):
    return SamplingParams(max_tokens=n)


def test_greedy_streams_identical_to_jax_engine(weights, jax_greedy):
    outs = _engine(weights).generate(PROMPTS, _greedy())
    assert [(o.token_ids, o.finish_reason) for o in outs] == jax_greedy
    assert all(o.finished for o in outs)


def test_staggered_batching_equals_sequential_runs(weights, jax_greedy):
    solo = [_engine(weights, slots=1).generate([p], _greedy())[0].token_ids
            for p in PROMPTS]
    eng = _engine(weights, slots=2)
    rids = [eng.add_request(PROMPTS[0], _greedy()),
            eng.add_request(PROMPTS[1], _greedy())]
    outs = {}
    eng.step()
    rids.append(eng.add_request(PROMPTS[2], _greedy()))
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.request_id] = o
    assert [outs[r].token_ids for r in rids] == solo
    assert solo == [ids for ids, _ in jax_greedy]


def test_chunked_prefill_gives_bucketed_tokens(weights, jax_greedy):
    eng = _engine(weights, prefill_chunk_tokens=16)
    outs = eng.generate(PROMPTS, _greedy())
    assert [(o.token_ids, o.finish_reason) for o in outs] == jax_greedy
    assert eng.stats["chunk_tokens"] == sum(len(p) for p in PROMPTS)


def test_stream_yields_what_generate_returns(weights):
    want = _engine(weights).generate([PROMPTS[1]], _greedy())[0]
    events = list(_engine(weights).stream(PROMPTS[1], _greedy()))
    assert [e["token_id"] for e in events[:-1]] == want.token_ids
    assert events[-1]["finished"]
    assert events[-1]["token_ids"] == want.token_ids
    assert events[-1]["finish_reason"] == want.finish_reason


def test_max_waiting_sheds_with_backpressure(weights):
    eng = _engine(weights, slots=1, max_waiting=1)
    eng.add_request(PROMPTS[0], _greedy())
    eng.step()                                # occupies the only slot
    eng.add_request(PROMPTS[1], _greedy())    # waits
    with pytest.raises(BackPressureError) as info:
        eng.add_request(PROMPTS[2], _greedy())
    assert info.value.retry_after_s > 0
    eng.add_request(PROMPTS[2], _greedy(), admit=False)   # batch path queues


def test_seeded_sampling_reproducible_and_top_k_one_is_greedy(weights):
    sampled = SamplingParams(max_tokens=8, temperature=0.8, top_k=40,
                             top_p=0.95, seed=123)
    a = _engine(weights).generate([PROMPTS[0]], sampled)[0].token_ids
    b = _engine(weights).generate([PROMPTS[0]], sampled)[0].token_ids
    assert a == b
    other = SamplingParams(max_tokens=8, temperature=0.8, seed=124)
    many = {tuple(_engine(weights).generate([PROMPTS[0]], other)[0]
                  .token_ids)}
    many.add(tuple(a))
    assert len(many) == 2          # another seed draws another stream
    top1 = SamplingParams(max_tokens=8, temperature=0.8, top_k=1, seed=5)
    greedy = _engine(weights).generate([PROMPTS[0]], _greedy(8))[0]
    assert (_engine(weights).generate([PROMPTS[0]], top1)[0].token_ids
            == greedy.token_ids)


def test_unported_options_raise(weights):
    with pytest.raises(NotImplementedError):
        _engine(weights, tensor_parallel_size=2)
    with pytest.raises(NotImplementedError):
        _engine(weights).add_request([1, 2], trace_ctx=object())
    with pytest.raises(ValueError, match="neither a named config"):
        LLMEngine("/no/such/checkpoint", device="cpu")
    with pytest.raises(ValueError):
        _engine(weights).add_request([1, 999])      # outside the vocab
