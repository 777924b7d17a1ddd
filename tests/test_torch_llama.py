"""The port's Llama (inference half) against the JAX package's, with the
JAX weights carried across by ``params_from_jax_numpy``: forward logits,
the serving primitives (prefill into the slab, chunked prefill, decode
with an ``active`` mask) and the flash-kernel path end to end.  fp32 on
the CPU; logits and slabs agree to atol 1e-4 (sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_ray_tpu.models import llama as jl
from ant_ray_tpu_torch.models import llama as tl
from ant_ray_tpu_torch.models.convert import params_from_jax_numpy

# TF32 off, so fp32 matmuls compare in full fp32 wherever a card runs them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4


def _pair(name, seed=0):
    jcfg, tcfg = jl.CONFIGS[name], tl.CONFIGS[name]
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _tokens(seed, *shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _slab(jcache, tcfg):
    return params_from_jax_numpy(jax.tree.map(np.asarray, jcache), tcfg,
                                 device="cpu")


@pytest.mark.parametrize("name", ["tiny", "moe-tiny"])
def test_forward_logits_match_jax(name):
    jcfg, tcfg, jparams, tparams = _pair(name, seed=1)
    toks = _tokens(2, 2, 48)
    want = jl.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 48, 256) and got.dtype == torch.float32
    _close(got, want)


def test_param_shapes_and_init(tiny):
    _, tcfg, _, tparams = tiny
    made = tl.init_params(tcfg, generator=torch.Generator().manual_seed(3),
                          device="cpu")
    count = sum(made[k].numel() for k in made if k != "layers")
    count += sum(w.numel() for w in made["layers"].values())
    assert count == tcfg.num_params()
    assert torch.equal(made["norm_f"], torch.ones(tcfg.dim))
    assert abs(float(made["layers"]["wq"].std()) - 0.02) < 2e-3
    assert made["embed"].dtype == tcfg.dtype


def test_prefill_into_cache_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    length, bucket = 20, 32
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :length] = _tokens(3, length)
    jcache = jl.init_kv_cache(jcfg, 2, 128)
    jlogits, jcache = jl.prefill_into_cache(
        jparams, jnp.asarray(toks, jnp.int32), jcache, 1, length, jcfg)
    tcache = tl.init_kv_cache(tcfg, 2, 128, device="cpu")
    tlogits, tcache = tl.prefill_into_cache(
        tparams, torch.from_numpy(toks), tcache, 1, length, tcfg)
    _close(tlogits, jlogits)
    want = _slab(jcache, tcfg)
    _close(tcache["k"], want["k"])
    _close(tcache["v"], want["v"])
    assert tcache["length"].tolist() == want["length"].tolist() == [0, 20]


def test_prefill_chunks_match_jax(tiny):
    """Two chunks of 16 into slot 0: the second is partial (9 real
    tokens), so its pad rows must write nothing."""
    jcfg, tcfg, jparams, tparams = tiny
    prompt = _tokens(4, 25)
    jcache = jl.init_kv_cache(jcfg, 2, 64)
    tcache = tl.init_kv_cache(tcfg, 2, 64, device="cpu")
    for start in (0, 16):
        part = prompt[start:start + 16]
        buf = np.zeros((16,), np.int64)
        buf[:len(part)] = part
        jlogits, jcache = jl.prefill_chunk_into_cache(
            jparams, jnp.asarray(buf, jnp.int32), jcache, 0, start,
            len(part), jcfg)
        tlogits, tcache = tl.prefill_chunk_into_cache(
            tparams, torch.from_numpy(buf), tcache, 0, start, len(part),
            tcfg)
        _close(tlogits, jlogits)
    want = _slab(jcache, tcfg)
    _close(tcache["k"], want["k"])
    _close(tcache["v"], want["v"])
    assert tcache["length"].tolist() == [25, 0]
    assert not tcache["k"][:, 0, 25:].any()    # pad rows wrote nothing


def test_decode_step_with_active_mask_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    slots, max_seq = 3, 32
    jcache = jl.init_kv_cache(jcfg, slots, max_seq)
    for slot, n in enumerate((5, 9, 31)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :n] = _tokens(10 + slot, n)
        _, jcache = jl.prefill_into_cache(jparams, jnp.asarray(toks), jcache,
                                          slot, n, jcfg)
    tcache = _slab(jcache, tcfg)
    inactive_k = tcache["k"][:, 1].clone()
    inactive_v = tcache["v"][:, 1].clone()
    last = np.asarray([7, 8, 9])
    # slot 2 sits at max_seq - 1: its write is the last in-bounds one, and
    # the next step would push it out of bounds (clamped, not written).
    active = np.asarray([True, False, True])
    for _ in range(2):
        jlogits, jcache = jl.decode_step(jparams, jnp.asarray(last, jnp.int32),
                                         jcache, jcfg,
                                         active=jnp.asarray(active))
        tlogits, tcache = tl.decode_step(tparams, torch.from_numpy(last),
                                         tcache, tcfg,
                                         active=torch.from_numpy(active))
        _close(tlogits[active], np.asarray(jlogits)[active])
    want = _slab(jcache, tcfg)
    _close(tcache["k"], want["k"])
    _close(tcache["v"], want["v"])
    assert tcache["length"].tolist() == want["length"].tolist() == [7, 9, 32]
    assert torch.equal(tcache["k"][:, 1], inactive_k)
    assert torch.equal(tcache["v"][:, 1], inactive_v)


def test_flash_path_matches_jax_pallas_end_to_end():
    """head_dim 128 and a 128-token sequence: the port's forward through
    the flash kernel's path (its plain version on the CPU) against the
    JAX forward through the Pallas kernel in interpret mode."""
    jcfg = dataclasses.replace(
        jl.CONFIGS["tiny"], dim=256, n_heads=2, n_kv_heads=1, mlp_dim=256,
        max_seq=256)
    tcfg = dataclasses.replace(
        tl.CONFIGS["tiny"], dim=256, n_heads=2, n_kv_heads=1, mlp_dim=256,
        max_seq=256)
    assert tcfg.head_dim == 128
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    toks = _tokens(6, 1, 128)
    want = jl.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                      attn_impl="pallas")
    got = tl.forward(tparams, torch.from_numpy(toks), tcfg,
                     attn_impl="flash")
    _close(got, want)


def test_greedy_generate_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    prompt = _tokens(7, 6)
    want = jl.greedy_generate(jparams, jcfg, jnp.asarray(prompt, jnp.int32),
                              max_new_tokens=4)
    got = tl.greedy_generate(tparams, tcfg, torch.from_numpy(prompt),
                             max_new_tokens=4)
    assert got.tolist() == np.asarray(want).tolist()
