"""Selective rematerialisation in the port: the flash kernels as
``torch.library`` custom ops, and the remat policies that name them.

What each policy saves shows in how often the flash forward op runs in
one training step through ``attention(impl="flash")``: once per layer
where its (out, lse) are saved ("none", and "matmuls" through
``saveable_attention_policy``), twice where the backward recomputes it
("full", and "dots", which saves only matmuls without batch
dimensions, as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
does).  The backward op runs once per layer under every policy.  Loss
and gradients under each policy are held against the JAX package in
tests/test_torch_train.py.

On the CPU the ops run the kernels' plain versions; ``opcheck`` tests
their schemas, fake (meta) implementations and autograd registration
there, in fp32 and bf16.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from ant_ray_tpu_torch.models import llama
from ant_ray_tpu_torch.ops import flash_attention as fa
from ant_ray_tpu_torch.ops.attention import (
    attention as attention_fn,
    dots_with_no_batch_dims_saveable,
    saveable_attention_policy,
)

FWD_RUNS_PER_LAYER = {"none": 1, "matmuls": 1, "full": 2, "dots": 2}
CFG = dataclasses.replace(llama.CONFIGS["tiny"], dim=128, n_heads=2,
                          n_kv_heads=1, mlp_dim=128, n_layers=3, max_seq=128)


def _counting(monkeypatch):
    """Count the runs of the two wrappers behind the ops (each op looks
    its wrapper up at call time)."""
    runs = {"fwd": 0, "bwd": 0}

    def wrap(key, fn):
        def counted(*args, **kwargs):
            runs[key] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(fa, "flash_attention_fwd_lse",
                        wrap("fwd", fa.flash_attention_fwd_lse))
    monkeypatch.setattr(fa, "flash_attention_backward",
                        wrap("bwd", fa.flash_attention_backward))
    return runs


@pytest.mark.parametrize("remat", list(FWD_RUNS_PER_LAYER))
def test_flash_forward_runs_as_the_policy_says(monkeypatch, remat):
    params = llama.init_params(
        CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    leaves = [params["embed"], *params["layers"].values()]
    for leaf in leaves:
        leaf.requires_grad_()
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 65)))
    runs = _counting(monkeypatch)
    loss = llama.loss_fn(params, {"tokens": toks}, CFG, attn_impl="flash",
                         remat=remat)
    assert runs == {"fwd": CFG.n_layers, "bwd": 0}
    grads = torch.autograd.grad(loss, leaves)
    assert runs == {"fwd": FWD_RUNS_PER_LAYER[remat] * CFG.n_layers,
                    "bwd": CFG.n_layers}
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("remat", list(FWD_RUNS_PER_LAYER))
def test_inference_runs_the_forward_once_per_layer(monkeypatch, remat):
    params = llama.init_params(CFG, device="cpu")
    toks = torch.zeros((1, 64), dtype=torch.int64)
    runs = _counting(monkeypatch)
    with torch.inference_mode():
        llama.forward(params, toks, CFG, attn_impl="flash", remat=remat)
    assert runs == {"fwd": CFG.n_layers, "bwd": 0}


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_flash_attention_goes_through_the_op_in_every_mode(mode):
    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    q, k, v = _qkv(torch.float32)
    if mode == "grad":
        q.requires_grad_()
    context = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
               "inference_mode": torch.inference_mode}[mode]
    with context(), Record() as record:
        attention_fn(q, k, v, causal=True, impl="flash")
    assert torch.ops.ant_ray_tpu_torch.flash_fwd.default in record.ops


def test_policies_save_what_their_jax_counterparts_save():
    aten = torch.ops.aten
    flash = torch.ops.ant_ray_tpu_torch.flash_fwd.default
    must, recompute = CheckpointPolicy.MUST_SAVE, \
        CheckpointPolicy.PREFER_RECOMPUTE
    dots, matmuls = dots_with_no_batch_dims_saveable(), \
        saveable_attention_policy()
    for op in (aten.mm.default, aten.addmm.default):
        assert dots(None, op) == matmuls(None, op) == must
    for op in (aten.bmm.default, aten.baddbmm.default, flash):
        assert dots(None, op) == recompute
        assert matmuls(None, op) == must
    for op in (aten.mul.Tensor, aten.exp.default, aten.silu.default,
               torch.ops.ant_ray_tpu_torch.flash_bwd.default):
        assert dots(None, op) == matmuls(None, op) == recompute


def _qkv(dtype, q_len=64, kv_len=64, heads=4, kv_heads=2, dim=32):
    gen = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    return (rand(2, q_len, heads, dim), rand(2, kv_len, kv_heads, dim),
            rand(2, kv_len, kv_heads, dim))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_flash_fwd(dtype, causal):
    q, k, v = (t.requires_grad_() for t in _qkv(dtype))
    torch.library.opcheck(torch.ops.ant_ray_tpu_torch.flash_fwd.default,
                          (q, k, v, causal, 32 ** -0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_flash_bwd(dtype):
    q, k, v = _qkv(dtype)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dtype)
    torch.library.opcheck(torch.ops.ant_ray_tpu_torch.flash_bwd.default,
                          (q, k, v, out, lse, do, True, 32 ** -0.5))


def test_op_outputs_equal_the_wrappers():
    q, k, v = _qkv(torch.float32, q_len=64, kv_len=128)
    out, lse = fa.flash_fwd(q, k, v, True, 0.125)
    want_out, want_lse = fa.flash_attention_fwd_lse(q, k, v, causal=True,
                                                    scale=0.125)
    assert out.is_contiguous() and lse.dtype == torch.float32
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    do = torch.ones_like(q)
    got = fa.flash_bwd(q, k, v, out, lse, do, True, 0.125)
    want = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True,
                                       scale=0.125)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_lse_is_not_differentiable():
    q, k, v = (t.requires_grad_() for t in _qkv(torch.float32))
    out, lse = fa.flash_fwd(q, k, v, True, 32 ** -0.5)
    assert out.requires_grad and not lse.requires_grad
