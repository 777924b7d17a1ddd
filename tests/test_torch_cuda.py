"""The hand-written CUDA flash-attention kernels (the forward, and the dQ
and dK/dV backward, each on its routes: the bf16 tensor-core kernels at
head_dim 64 and 128, fp32 in 3xTF32 on the tensor cores at head_dim 64
and 128, the bf16 tensor-core kernels at head_dim 256, and the 3xTF32
tensor-core kernels for fp32 at head_dim 256) against their plain
PyTorch versions, on the card; GPT-2 and the remat policies
through the kernels; and the session slabs' round
trip between the card and host memory, bitwise, with an install from
pinned memory that does not wait for the card; CUDA tensors of every
dtype through the object plane (serialize, the native arena,
deserialize), bitwise, and a local-mode actor serving an engine on the
card; in cluster mode, a node that advertises the card, a num_gpus=1
actor serving an engine from its own worker process, a task returning a
CUDA tensor of each dtype bitwise, and the card's memory coming back
after a kill; an NCCL collective group of one rank on the card.
These tests need a CUDA device and ``nvcc``: they skip on a machine
without a card.  This file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: forward bf16 out max abs error <= 2e-2
(p and out round to bf16 at other points of the tiled loop), lse <=
1e-3; fp32 both <= 1e-4.  Backward: max abs error over max |ref| per
tensor, bf16 <= 1e-2 (p and ds round to bf16 at the same points on both
sides, but sums run in another order, so a value near a rounding
boundary may land one bf16 ulp away), fp32 <= 1e-4.  Gradients in bf16
through ``attention(impl="flash")`` against reference attention:
BF16_GRAD_TOL, reason beside it.  TF32 is switched off, so fp32 matmuls
of the plain versions run in full fp32.
"""

import pytest
import torch

from ant_ray_tpu_torch.ops import flash_attention as fa
from ant_ray_tpu_torch.ops.attention import attention

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# bf16 gradients through the kernels against reference attention, max abs
# error over max |ref| per input: the kernels round p before P.V and p
# and ds before every backward product, each up to 2^-9 relative, while
# reference attention keeps its softmax in fp32 (chip_smoke.py's
# BF16_GRAD_TOL).  A wrong tile, mask or layout gives errors of order 1.
BF16_GRAD_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, q_len, kv_len, heads, kv_heads, dim, dtype):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (rand(2, q_len, heads, dim), rand(2, kv_len, kv_heads, dim),
            rand(2, kv_len, kv_heads, dim))


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,dim,dtype,causal", [
    (256, 256, 8, 2, 128, torch.bfloat16, True),
    (256, 256, 8, 8, 128, torch.bfloat16, False),
    (128, 256, 4, 1, 64, torch.float32, True),
    (192, 192, 4, 2, 256, torch.float32, False),
    (128, 128, 4, 4, 256, torch.bfloat16, True),
])
def test_kernel_matches_plain_version(cuda, q_len, kv_len, heads, kv_heads,
                                      dim, dtype, causal):
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, dim, dtype)
    before = fa.launch_count
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - want_out.float()).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


def test_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd_lse(q, k, v)
    q, k, v = _qkv(cuda, 100, 100, 4, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention_fwd_lse(q, k, v)
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_fwd_lse(q, k, v)


@pytest.mark.parametrize("q_len", [192, 320])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 128])
def test_sm90_forward_matches_plain_version_on_ragged_lengths(
        cuda, dim, groups, causal, q_len):
    """Lengths 192 and 320 are ragged against the 128-row q tiles."""
    _check_sm90_forward(cuda, q_len, q_len, 8, 8 // groups, dim, causal)


@pytest.mark.parametrize("q_len,kv_len", [(128, 256), (256, 128)])
@pytest.mark.parametrize("dim", [64, 128])
def test_sm90_forward_matches_plain_version_when_lengths_differ(
        cuda, dim, q_len, kv_len):
    """Top-left causal alignment both ways: query i sees min(i + 1, Skv)
    keys."""
    _check_sm90_forward(cuda, q_len, kv_len, 8, 2, dim, True)


def _check_sm90_forward(gen, q_len, kv_len, heads, kv_heads, dim, causal):
    q, k, v = _qkv(gen, q_len, kv_len, heads, kv_heads, dim, torch.bfloat16)
    before = (fa.fwd_sm90_launch_count, fa.launch_count)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.fwd_sm90_launch_count, fa.launch_count) == \
        (before[0] + 1, before[1] + 1)
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    tol_out, tol_lse = TOL[torch.bfloat16]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - want_out.float()).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize("dtype,dim,sm90", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float32, 256, False),
])
def test_fwd_sm90_count_rises_only_on_its_route(cuda, dtype, dim, sm90):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    before = (fa.fwd_sm90_launch_count, fa.launch_count)
    fa.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert fa.fwd_sm90_launch_count == before[0] + int(sm90)
    assert fa.launch_count == before[1] + 1


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,causal", [
    (256, 256, 8, 8, True),     # H = KVH, as GPT-2
    (256, 256, 8, 8, False),
    (256, 256, 8, 2, True),     # GQA, 4 query heads a KV head
    (256, 256, 8, 2, False),
    (192, 192, 4, 1, True),     # ragged: three 64-row tiles
    (192, 192, 4, 1, False),
    (128, 256, 8, 2, True),     # Sq < Skv: query i sees keys 0..i
    (256, 128, 8, 2, True),     # Sq > Skv: queries 128.. see every key
    (256, 128, 8, 4, False),
])
@pytest.mark.parametrize("dim", [64, 128])
def test_tf32x3_forward_matches_plain_version(cuda, dim, q_len, kv_len,
                                             heads, kv_heads, causal):
    """The fp32 forward on the tensor cores (3xTF32) holds fp32's 1e-4 on
    out and lse: one TF32 product (~2^-11 relative) would not."""
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, dim, torch.float32)
    before = (fa.fwd_tf32x3_launch_count, fa.launch_count,
              fa.fwd_sm90_launch_count)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.fwd_tf32x3_launch_count, fa.launch_count,
            fa.fwd_sm90_launch_count) == (before[0] + 1, before[1] + 1,
                                          before[2])
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    tol_out, tol_lse = TOL[torch.float32]
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out - want_out).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize("dtype,dim,tf32x3", [
    (torch.float32, 64, True), (torch.float32, 128, True),
    (torch.float32, 256, False), (torch.bfloat16, 64, False),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
])
def test_fwd_tf32x3_count_rises_only_on_its_route(cuda, dtype, dim, tf32x3):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    before = (fa.fwd_tf32x3_launch_count, fa.launch_count)
    fa.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert fa.fwd_tf32x3_launch_count == before[0] + int(tf32x3)
    assert fa.launch_count == before[1] + 1


def test_tf32x3_forward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 64, torch.float32)
    shifted = torch.empty(k.numel() + 4, device="cuda")
    k_off = shifted[1:k.numel() + 1].view(k.shape)     # 4 bytes in
    k_off.copy_(k)
    before = (fa.fwd_tf32x3_launch_count, fa.launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd_lse(q, k_off, v)
    assert (fa.fwd_tf32x3_launch_count, fa.launch_count) == before


def test_sm90_forward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 64, torch.bfloat16)
    shifted = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    q_off = shifted[1:q.numel() + 1].view(q.shape)    # 2 bytes in
    q_off.copy_(q)
    before = (fa.fwd_sm90_launch_count, fa.launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd_lse(q_off, k, v)
    assert (fa.fwd_sm90_launch_count, fa.launch_count) == before


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,causal", [
    (256, 256, 8, 8, True),     # H = KVH, as Gemma-7B
    (256, 256, 8, 8, False),
    (256, 256, 8, 2, True),     # GQA, 4 query heads a KV head
    (256, 256, 8, 1, True),     # GQA 8:1, one KV head, as Gemma-2B
    (256, 256, 8, 1, False),
    (192, 192, 8, 2, True),     # ragged: the last 128-row q tile is half
    (192, 192, 8, 1, False),
    (320, 320, 8, 8, True),
    (128, 256, 8, 2, True),     # Sq < Skv: query i sees keys 0..i
    (256, 128, 8, 2, True),     # Sq > Skv: queries 128.. see every key
    (128, 256, 8, 4, False),
])
def test_sm90_d256_forward_matches_plain_version(cuda, q_len, kv_len, heads,
                                                 kv_heads, causal):
    """The bf16 forward at head_dim 256 on its own tensor-core route (B=2):
    both 128-column halves of out (each an accumulator of its own) and
    lse against the plain version; its counter moves, and no other
    forward route's."""
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, 256,
                   torch.bfloat16)
    counters = ("fwd_sm90_d256_launch_count", "launch_count",
                "fwd_sm90_launch_count", "fwd_tf32x3_launch_count")
    before = [getattr(fa, name) for name in counters]
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert [getattr(fa, name) for name in counters] == \
        [before[0] + 1, before[1] + 1, before[2], before[3]]
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    tol_out, tol_lse = TOL[torch.bfloat16]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert lse.shape == want_lse.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    for half in (out[..., :128], out[..., 128:]):
        assert half.float().abs().max() > 0
    assert (out.float() - want_out.float()).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize("dtype,dim,d256", [
    (torch.bfloat16, 64, False), (torch.bfloat16, 128, False),
    (torch.bfloat16, 256, True), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float32, 256, False),
])
def test_fwd_sm90_d256_count_rises_only_on_its_route(cuda, dtype, dim, d256):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    before = (fa.fwd_sm90_d256_launch_count, fa.launch_count)
    fa.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert fa.fwd_sm90_d256_launch_count == before[0] + int(d256)
    assert fa.launch_count == before[1] + 1


def test_sm90_d256_forward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 256, torch.bfloat16)
    shifted = torch.empty(v.numel() + 8, dtype=v.dtype, device="cuda")
    v_off = shifted[1:v.numel() + 1].view(v.shape)    # 2 bytes in
    v_off.copy_(v)
    before = (fa.fwd_sm90_d256_launch_count, fa.launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd_lse(q, k, v_off)
    assert (fa.fwd_sm90_d256_launch_count, fa.launch_count) == before


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,causal", [
    (256, 256, 8, 8, True),     # H = KVH
    (256, 256, 8, 8, False),
    (256, 256, 8, 2, True),     # GQA, 4 query heads a KV head
    (256, 256, 8, 1, True),     # GQA 8:1, one KV head, as Gemma-2B
    (256, 256, 8, 1, False),
    (192, 192, 8, 2, True),     # ragged: six 32-row q tiles
    (192, 192, 8, 1, False),
    (128, 256, 8, 2, True),     # Sq < Skv: query i sees keys 0..i
    (256, 128, 8, 2, True),     # Sq > Skv: queries 128.. see every key
    (128, 256, 8, 4, False),
    # 64-row q tiles: grids of at least two waves of 132 SMs.
    (1152, 1152, 8, 1, True),
    (1152, 1152, 8, 1, False),
    (1152, 2048, 8, 2, True),
    (2048, 1152, 8, 2, True),
])
def test_tf32x3_d256_forward_matches_plain_version(cuda, q_len, kv_len,
                                                  heads, kv_heads, causal):
    """The fp32 forward at head_dim 256 on its own tensor-core route
    (3xTF32, B=2) holds fp32's 1e-4 on out and lse: every column quarter
    of out (each warp owns one) against the plain version; its counter
    moves, and no other forward route's."""
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, 256, torch.float32)
    counters = ("fwd_tf32x3_d256_launch_count", "launch_count",
                "fwd_sm90_launch_count", "fwd_tf32x3_launch_count",
                "fwd_sm90_d256_launch_count")
    before = [getattr(fa, name) for name in counters]
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert [getattr(fa, name) for name in counters] == \
        [before[0] + 1, before[1] + 1, *before[2:]]
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    tol_out, tol_lse = TOL[torch.float32]
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert lse.shape == want_lse.shape
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    for quarter in out.split(64, dim=-1):
        assert quarter.abs().max() > 0
    assert (out - want_out).abs().max().item() <= tol_out
    assert (lse - want_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize("dtype,dim,d256", [
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.float32, 256, True), (torch.bfloat16, 64, False),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
])
def test_fwd_tf32x3_d256_count_rises_only_on_its_route(cuda, dtype, dim,
                                                       d256):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    before = (fa.fwd_tf32x3_d256_launch_count, fa.launch_count)
    fa.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert fa.fwd_tf32x3_d256_launch_count == before[0] + int(d256)
    assert fa.launch_count == before[1] + 1


def test_tf32x3_d256_forward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 256, torch.float32)
    shifted = torch.empty(q.numel() + 4, device="cuda")
    q_off = shifted[1:q.numel() + 1].view(q.shape)     # 4 bytes in
    q_off.copy_(q)
    before = (fa.fwd_tf32x3_d256_launch_count, fa.launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd_lse(q_off, k, v)
    assert (fa.fwd_tf32x3_d256_launch_count, fa.launch_count) == before


@pytest.mark.parametrize("dim", [64, 128])
def test_bf16_gradients_through_flash_function_match_reference(cuda, dim):
    """Both sm90 directions under autograd: forward, then dQ and dK/dV."""
    q, k, v = _qkv(cuda, 256, 256, 8, 2, dim, torch.bfloat16)
    w = torch.randn(q.shape, generator=cuda, device="cuda").bfloat16()
    grads = []
    before = (fa.fwd_sm90_launch_count, fa.bwd_sm90_launch_count)
    for impl in ("flash", "reference"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention(*leaves, causal=True, impl=impl)
        grads.append(torch.autograd.grad((out.float() * w).sum(), leaves))
    torch.cuda.synchronize()
    assert (fa.fwd_sm90_launch_count, fa.bwd_sm90_launch_count) == \
        (before[0] + 1, before[1] + 1)
    for g, r in zip(*grads):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g, r) <= BF16_GRAD_TOL


@pytest.mark.parametrize("dtype,route", [(torch.float32, "tf32x3"),
                                         (torch.bfloat16, "sm90")])
def test_gpt2_gradients_through_the_kernels_match_reference(cuda, dtype,
                                                            route):
    """GPT-2 (plain multi-head attention, head_dim 64) through the
    kernels of its dtype's route, against reference attention on the
    card: every block checkpointed, so the forward kernel runs twice per
    layer and the backward pair once (fp32: the 3xTF32 forward and
    backward)."""
    import dataclasses

    from ant_ray_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.CONFIGS["tiny"], dim=256, n_heads=4,
                              n_positions=256, dtype=dtype)
    params = gpt2.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device="cuda",
                         generator=cuda)
    leaves = [params["wte"], *params["layers"].values()]
    results = {}
    for impl in ("flash", "reference"):
        before = (fa.launch_count, fa.fwd_sm90_launch_count,
                  fa.fwd_tf32x3_launch_count, fa.bwd_dq_launch_count,
                  fa.bwd_sm90_launch_count, fa.bwd_tf32x3_launch_count)
        with torch.enable_grad():
            for leaf in leaves:
                leaf.requires_grad_()
            loss = gpt2.loss_fn(params, {"tokens": toks}, cfg,
                                attn_impl=impl)
            results[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        after = (fa.launch_count, fa.fwd_sm90_launch_count,
                 fa.fwd_tf32x3_launch_count, fa.bwd_dq_launch_count,
                 fa.bwd_sm90_launch_count, fa.bwd_tf32x3_launch_count)
        launched = tuple(a - b for a, b in zip(after, before))
        sm90 = int(route == "sm90")
        want = ((2, 2 * sm90, 2 * (1 - sm90), 1, sm90, 1 - sm90)
                if impl == "flash" else (0, 0, 0, 0, 0, 0))
        assert launched == tuple(n * cfg.n_layers for n in want)
    loss, grads = results["flash"]
    ref_loss, ref_grads = results["reference"]
    tol = BF16_GRAD_TOL if dtype == torch.bfloat16 else \
        BWD_REL_TOL[torch.float32]
    assert abs(loss - ref_loss) <= (1e-2 if dtype == torch.bfloat16
                                    else 1e-5)
    for g, r in zip(grads, ref_grads):
        assert _rel_err(g, r) <= tol


@pytest.mark.parametrize("remat,fwd_per_layer", [
    ("none", 1), ("full", 2), ("dots", 2), ("matmuls", 1)])
def test_remat_policies_launch_the_forward_kernel_as_they_save(
        cuda, remat, fwd_per_layer):
    """Under "matmuls" the flash forward's (out, lse) are saved, so the
    backward does not launch the forward kernel again; under "full" and
    "dots" it does.  Gradients equal those of remat "none"."""
    import dataclasses

    from ant_ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.CONFIGS["tiny"], dim=256, n_heads=4,
                              n_kv_heads=2, mlp_dim=256, n_layers=2,
                              max_seq=256, dtype=torch.bfloat16)
    params = llama.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device="cuda",
                         generator=cuda)
    leaves = [params["embed"], *params["layers"].values()]
    grads = {}
    for policy in ("none", remat):
        before = (fa.fwd_sm90_launch_count, fa.bwd_sm90_launch_count)
        with torch.enable_grad():
            for leaf in leaves:
                leaf.requires_grad_()
            loss = llama.loss_fn(params, {"tokens": toks}, cfg,
                                 attn_impl="flash", remat=policy)
            grads[policy] = torch.autograd.grad(loss, leaves)
        launched = (fa.fwd_sm90_launch_count - before[0],
                    fa.bwd_sm90_launch_count - before[1])
        per_layer = fwd_per_layer if policy == remat else 1
        assert launched == (per_layer * cfg.n_layers, cfg.n_layers)
    for g, r in zip(grads[remat], grads["none"]):
        assert _rel_err(g, r) <= BF16_GRAD_TOL


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,dim,dtype,causal", [
    (256, 256, 8, 2, 128, torch.bfloat16, True),
    (256, 256, 8, 8, 128, torch.bfloat16, False),
    (128, 256, 4, 1, 64, torch.float32, True),
    (192, 192, 4, 2, 256, torch.float32, False),
    (128, 128, 4, 4, 256, torch.bfloat16, True),
])
def test_backward_kernels_match_plain_version(cuda, q_len, kv_len, heads,
                                              kv_heads, dim, dtype, causal):
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, dim, dtype)
    do = torch.randn(q.shape, generator=cuda, device="cuda").to(dtype)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    before = (fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count) == \
        (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_err(g, w) <= BWD_REL_TOL[dtype]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("dim", [64, 128])
def test_sm90_backward_matches_plain_version_on_ragged_lengths(
        cuda, dim, groups, causal):
    """Length 192 is ragged against the sm90 kernels' 128-row tiles."""
    _check_sm90_backward(cuda, 192, 192, 8, 8 // groups, dim, causal)


@pytest.mark.parametrize("dim", [64, 128])
def test_sm90_backward_matches_plain_version_with_more_keys(cuda, dim):
    """Sq=128 against Skv=256, causal: keys 128..255 see no query."""
    _check_sm90_backward(cuda, 128, 256, 8, 2, dim, True)


def _check_sm90_backward(gen, q_len, kv_len, heads, kv_heads, dim, causal):
    q, k, v = _qkv(gen, q_len, kv_len, heads, kv_heads, dim, torch.bfloat16)
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    before = fa.bwd_sm90_launch_count
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.bwd_sm90_launch_count == before + 1
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_err(g, w) <= BWD_REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype,dim,sm90", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float32, 256, False),
])
def test_sm90_count_rises_only_on_its_route(cuda, dtype, dim, sm90):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    before = (fa.bwd_sm90_launch_count, fa.bwd_dq_launch_count)
    fa.flash_attention_backward(q, k, v, out, lse, q, causal=True)
    torch.cuda.synchronize()
    assert fa.bwd_sm90_launch_count == before[0] + int(sm90)
    assert fa.bwd_dq_launch_count == before[1] + 1


@pytest.mark.parametrize("q_len,kv_len,heads,kv_heads,causal", [
    (256, 256, 8, 8, True),     # H = KVH, as GPT-2
    (256, 256, 8, 8, False),
    (256, 256, 8, 2, True),     # GQA, 4 query heads a KV head
    (256, 256, 8, 2, False),
    (192, 192, 4, 1, True),     # ragged: three 64-row tiles
    (128, 256, 8, 2, True),     # Sq < Skv: keys 128..255 see no query
    (256, 128, 8, 2, True),     # Sq > Skv
    (256, 128, 8, 4, False),
])
@pytest.mark.parametrize("dim", [64, 128])
def test_tf32x3_backward_matches_plain_version(cuda, dim, q_len, kv_len,
                                              heads, kv_heads, causal):
    """The fp32 backward on the tensor cores (3xTF32) holds fp32's 1e-4:
    one TF32 product (~2^-11 relative) would not."""
    q, k, v = _qkv(cuda, q_len, kv_len, heads, kv_heads, dim, torch.float32)
    do = torch.randn(q.shape, generator=cuda, device="cuda")
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    before = (fa.bwd_tf32x3_launch_count, fa.bwd_dq_launch_count,
              fa.bwd_dkv_launch_count, fa.bwd_sm90_launch_count)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.bwd_tf32x3_launch_count, fa.bwd_dq_launch_count,
            fa.bwd_dkv_launch_count, fa.bwd_sm90_launch_count) == \
        (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert _rel_err(g, w) <= BWD_REL_TOL[torch.float32]


@pytest.mark.parametrize("dtype,dim,tf32x3", [
    (torch.float32, 64, True), (torch.float32, 128, True),
    (torch.float32, 256, False), (torch.bfloat16, 64, False),
    (torch.bfloat16, 128, False), (torch.bfloat16, 256, False),
])
def test_tf32x3_count_rises_only_on_its_route(cuda, dtype, dim, tf32x3):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    before = (fa.bwd_tf32x3_launch_count, fa.bwd_dq_launch_count)
    fa.flash_attention_backward(q, k, v, out, lse, q, causal=True)
    torch.cuda.synchronize()
    assert fa.bwd_tf32x3_launch_count == before[0] + int(tf32x3)
    assert fa.bwd_dq_launch_count == before[1] + 1


def test_tf32x3_backward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 64, torch.float32)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    shifted = torch.empty(q.numel() + 4, device="cuda")
    do = shifted[1:q.numel() + 1].view(q.shape)     # 4 bytes in
    do.copy_(q)
    before = (fa.bwd_tf32x3_launch_count, fa.bwd_dq_launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert (fa.bwd_tf32x3_launch_count, fa.bwd_dq_launch_count) == before


@pytest.mark.parametrize("q_len,kv_len,groups,causal", [
    *[(q_len, q_len, groups, causal) for q_len in (192, 320)
      for groups in (1, 2, 4, 8) for causal in (True, False)],
    (128, 256, 2, True),    # Sq < Skv: keys 128..255 see no query
    (256, 128, 2, True),    # Sq > Skv: queries 128.. see every key
    (128, 256, 4, False),
    (256, 128, 4, False),
])
def test_sm90_d256_backward_matches_plain_version(cuda, q_len, kv_len,
                                                  groups, causal):
    """The bf16 backward at head_dim 256 on its own tensor-core route:
    every column of dq, dk and dv (each dK/dV warpgroup owns half of
    them) against the plain version.  Lengths 192 and 320 are ragged
    against the dQ kernel's 128-row q tiles."""
    q, k, v = _qkv(cuda, q_len, kv_len, 8, 8 // groups, 256, torch.bfloat16)
    do = torch.randn(q.shape, generator=cuda, device="cuda").bfloat16()
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    counters = ("bwd_sm90_d256_launch_count", "bwd_dq_launch_count",
                "bwd_dkv_launch_count", "bwd_sm90_launch_count")
    before = [getattr(fa, name) for name in counters]
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert [getattr(fa, name) for name in counters] == \
        [before[0] + 1, before[1] + 1, before[2] + 1, before[3]]
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        for half in (g[..., :128], g[..., 128:]):
            assert half.float().abs().max() > 0
        assert _rel_err(g, w) <= BWD_REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("kv_heads", [1, 8])
def test_sm90_d256_backward_is_deterministic(cuda, kv_heads):
    """With one KV head the dK/dV kernel splits each KV tile over a
    cluster's blocks and adds their partials in a fixed order; with eight
    it does not split.  Either way two runs agree bit for bit."""
    q, k, v = _qkv(cuda, 512, 512, 8, kv_heads, 256, torch.bfloat16)
    do = torch.randn(q.shape, generator=cuda, device="cuda").bfloat16()
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    first = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    second = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,dim,d256", [
    (torch.bfloat16, 64, False), (torch.bfloat16, 128, False),
    (torch.bfloat16, 256, True), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float32, 256, False),
])
def test_sm90_d256_count_rises_only_on_its_route(cuda, dtype, dim, d256):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    before = (fa.bwd_sm90_d256_launch_count, fa.bwd_dq_launch_count)
    fa.flash_attention_backward(q, k, v, out, lse, q, causal=True)
    torch.cuda.synchronize()
    assert fa.bwd_sm90_d256_launch_count == before[0] + int(d256)
    assert fa.bwd_dq_launch_count == before[1] + 1


def test_sm90_d256_backward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 256, torch.bfloat16)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    shifted = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    do = shifted[1:q.numel() + 1].view(q.shape)       # 2 bytes in
    do.copy_(q)
    before = (fa.bwd_sm90_d256_launch_count, fa.bwd_dq_launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert (fa.bwd_sm90_d256_launch_count, fa.bwd_dq_launch_count) == before


@pytest.mark.parametrize("q_len,kv_len,groups,causal", [
    *[(q_len, q_len, groups, causal) for q_len in (192, 320)
      for groups in (1, 2, 4, 8) for causal in (True, False)],
    (128, 256, 2, True),    # Sq < Skv: keys 128..255 see no query
    (256, 128, 2, True),    # Sq > Skv: queries 128.. see every key
    (128, 256, 4, False),
    (256, 128, 4, False),
])
def test_tf32x3_d256_backward_matches_plain_version(cuda, q_len, kv_len,
                                                   groups, causal):
    """The fp32 backward at head_dim 256 on its own tensor-core route
    (3xTF32) holds fp32's 1e-4: every column quarter of dq, dk and dv
    (each warp owns one) against the plain version.  At one and two KV
    heads the dK/dV kernel splits KV tiles over a cluster's blocks."""
    q, k, v = _qkv(cuda, q_len, kv_len, 8, 8 // groups, 256, torch.float32)
    do = torch.randn(q.shape, generator=cuda, device="cuda")
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    counters = ("bwd_tf32x3_d256_launch_count", "bwd_dq_launch_count",
                "bwd_dkv_launch_count", "bwd_tf32x3_launch_count")
    before = [getattr(fa, name) for name in counters]
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert [getattr(fa, name) for name in counters] == \
        [before[0] + 1, before[1] + 1, before[2] + 1, before[3]]
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
        for quarter in g.split(64, dim=-1):
            assert quarter.abs().max() > 0
        assert _rel_err(g, w) <= BWD_REL_TOL[torch.float32]


@pytest.mark.parametrize("kv_heads", [1, 8])
def test_tf32x3_d256_backward_is_deterministic(cuda, kv_heads):
    """With one KV head the dK/dV kernel splits each KV tile over a
    cluster's blocks and adds their partials in a fixed order; with eight
    it does not split.  Either way two runs agree bit for bit."""
    q, k, v = _qkv(cuda, 512, 512, 8, kv_heads, 256, torch.float32)
    do = torch.randn(q.shape, generator=cuda, device="cuda")
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    first = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    second = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,dim,d256", [
    (torch.bfloat16, 64, False), (torch.bfloat16, 128, False),
    (torch.bfloat16, 256, False), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.float32, 256, True),
])
def test_tf32x3_d256_count_rises_only_on_its_route(cuda, dtype, dim, d256):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, dim, dtype)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    before = (fa.bwd_tf32x3_d256_launch_count, fa.bwd_dq_launch_count)
    fa.flash_attention_backward(q, k, v, out, lse, q, causal=True)
    torch.cuda.synchronize()
    assert fa.bwd_tf32x3_d256_launch_count == before[0] + int(d256)
    assert fa.bwd_dq_launch_count == before[1] + 1


def test_tf32x3_d256_backward_refuses_an_unaligned_input(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 256, torch.float32)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
    shifted = torch.empty(q.numel() + 4, device="cuda")
    do = shifted[1:q.numel() + 1].view(q.shape)     # 4 bytes in
    do.copy_(q)
    before = (fa.bwd_tf32x3_d256_launch_count, fa.bwd_dq_launch_count)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert (fa.bwd_tf32x3_d256_launch_count, fa.bwd_dq_launch_count) == \
        before


def _card_nan(kind):
    """A NaN made on the card: 0 * inf (CUDA's canonical NaN), the same
    with its sign bit set, or the NaN whose payload is its lowest bit."""
    bits = (torch.zeros((), device="cuda") * torch.inf).view(torch.int32)
    if kind == "negative":
        bits = bits | torch.full((), -2 ** 31, dtype=torch.int32,
                                 device="cuda")
    elif kind == "low_payload":
        bits = (bits & 0x7f800000) | 1
    nan = bits.view(torch.float32)
    assert nan.isnan()
    return nan


@pytest.mark.parametrize("kind", ["0*inf", "negative", "low_payload"])
@pytest.mark.parametrize("where", ["do", "k"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [64, 128, 256])
def test_fp32_backward_keeps_a_nan_where_the_plain_version_has_it(
        cuda, dim, causal, where, kind):
    """A NaN made on the card in dO (at the last query, which sees every
    key) or in k (at the first key, which every query sees) reaches dq,
    dk and dv where the plain version puts it: the 3xTF32 split of the
    tf32x3 and tf32x3_d256 kernels passes non-finite values unchanged.
    Elsewhere the kernels hold fp32's 1e-4."""
    q, k, v = _qkv(cuda, 192, 192, 8, 2, dim, torch.float32)
    do = torch.randn(q.shape, generator=cuda, device="cuda")
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    if where == "do":
        do[1, -1, 3, 5] = _card_nan(kind)
    else:
        k[1, 0, 1, 5] = _card_nan(kind)
    route = "tf32x3_d256" if dim == 256 else "tf32x3"
    counter = f"bwd_{route}_launch_count"
    before = getattr(fa, counter)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert getattr(fa, counter) == before + 1
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=causal)
    for g, w in zip(got, want):
        assert w.isnan().any()
        assert torch.equal(g.isnan(), w.isnan())
        assert _rel_err(g.nan_to_num(), w.nan_to_num()) <= \
            BWD_REL_TOL[torch.float32]


@pytest.mark.parametrize("kind", ["0*inf", "negative", "low_payload"])
@pytest.mark.parametrize("where", ["q", "k"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dim", [64, 128, 256])
def test_fp32_forward_keeps_a_nan_where_the_plain_version_has_it(
        cuda, dim, causal, where, kind):
    """A NaN made on the card in q (at the last query) or in k (at the
    first key, which every query sees) reaches out and lse where the
    plain version puts it: the 3xTF32 split of the tf32x3 and
    tf32x3_d256 forwards passes non-finite values on.  Elsewhere the
    kernels hold fp32's 1e-4."""
    q, k, v = _qkv(cuda, 192, 192, 8, 2, dim, torch.float32)
    if where == "q":
        q[1, -1, 3, 5] = _card_nan(kind)
    else:
        k[1, 0, 1, 5] = _card_nan(kind)
    route = "tf32x3_d256" if dim == 256 else "tf32x3"
    counter = f"fwd_{route}_launch_count"
    before = getattr(fa, counter)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert getattr(fa, counter) == before + 1
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    for got, want, tol in zip((out, lse), (want_out, want_lse),
                              TOL[torch.float32]):
        assert want.isnan().any()
        assert torch.equal(got.isnan(), want.isnan())
        assert (got.nan_to_num() - want.nan_to_num()).abs().max().item() \
            <= tol


def test_gradients_through_flash_function_match_reference(cuda):
    q, k, v = _qkv(cuda, 256, 256, 8, 2, 128, torch.float32)
    w = torch.randn(q.shape, generator=cuda, device="cuda")
    grads = []
    for impl in ("flash", "reference"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention(*leaves, causal=True, impl=impl)
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
    for g, r in zip(*grads):
        assert _rel_err(g, r) <= BWD_REL_TOL[torch.float32]


def test_raw_forward_raises_under_grad_mode(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 64, torch.bfloat16)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="attention"):
        fa.flash_attention_fwd_lse(q, k, v)
    with torch.no_grad():
        fa.flash_attention_fwd_lse(q, k, v)


def test_backward_wrapper_raises_on_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 128, 128, 4, 2, 96, torch.bfloat16)
    lse = torch.zeros((2, 4, 128), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_backward(q, k, v, q, lse, q, causal=True)


# ------------------------------------------------------- session slabs

def _bf16_cache(slots=4, max_seq=256):
    from ant_ray_tpu_torch.models import llama

    cfg = llama.CONFIGS["tiny"]
    cache = llama.init_kv_cache(cfg, slots, max_seq, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name in ("k", "v"):
        cache[name] = torch.randn(cache[name].shape, generator=gen,
                                  device="cuda").to(torch.bfloat16)
    cache["length"][1] = 77
    return cache


@pytest.mark.parametrize("pinned", [True, False])
def test_slab_round_trip_on_the_card_is_bitwise(cuda, pinned):
    from ant_ray_tpu_torch.models import llama

    cache = _bf16_cache()
    before = {n: cache[n][:, 1].clone() for n in ("k", "v")}
    k, v, length = llama.extract_slot(cache, 1)
    assert k.is_pinned() and v.is_pinned() and length == 77
    if not pinned:                  # as a slab unpickled from a spill file
        k, v = k.clone(), v.clone()
        assert not k.is_pinned()
    with torch.inference_mode():
        llama.install_slot(cache, k, v, length, 3)
    torch.cuda.synchronize()
    for name in ("k", "v"):
        assert torch.equal(cache[name][:, 3], before[name])
        assert torch.equal(cache[name][:, 1], before[name])
    assert int(cache["length"][3]) == 77


def test_install_from_pinned_memory_does_not_wait_for_the_card(cuda):
    """A long kernel queued first: the install's copies queue behind it,
    the host returns at once, and the bytes are right once it drains."""
    import time

    from ant_ray_tpu_torch.models import llama

    cache = _bf16_cache()
    k, v, length = llama.extract_slot(cache, 1)
    with torch.inference_mode():
        # Once untimed: a kernel's first launch loads its module, which
        # may wait for the card.
        llama.install_slot(cache, k, v, length, 3)
    torch.cuda.synchronize()
    sleep = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(2_000_000_000)          # ~1 s of device time
    t0 = time.perf_counter()
    with torch.inference_mode():
        llama.install_slot(cache, k, v, length, 2)
    host_s = time.perf_counter() - t0
    done.record()
    assert not done.query()                   # still behind the sleep
    done.synchronize()
    device_s = sleep.elapsed_time(done) / 1e3
    assert host_s < 0.1 * device_s, (host_s, device_s)
    assert torch.equal(cache["k"][:, 2], k.cuda())
    assert torch.equal(cache["v"][:, 2], v.cuda())


def test_session_restore_from_a_spill_file_on_the_card(cuda, tmp_path):
    """Every slab spilled (capacity 0), so each restore unpickles a
    pageable slab that the fetch thread pins; every turn's tokens equal
    an engine that never evicts."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ant_ray_tpu_torch.llm.kv_offload import LocalKvStore

    def run(evict):
        store = LocalKvStore(spill_dir=str(tmp_path / str(evict)),
                             capacity_slabs=0)
        eng = LLMEngine("tiny", slots=2, max_seq=96, device="cuda",
                        prefill_chunk_tokens=8, kv_offload_store=store,
                        kv_idle_evict_s=0.0 if evict else None)
        got = []
        for prompt in ([5, 9, 17], [3, 88, 41, 2], [11, 12]):
            eng.add_request(prompt, SamplingParams(max_tokens=6),
                            admit=False, session_id="s")
            while eng.has_unfinished():
                got += [o.token_ids for o in eng.step()]
            eng.step()                        # the idle sweep, if on
        return got, eng.stats, store.spills

    want, base_stats, _ = run(False)
    got, stats, spills = run(True)
    assert got == want and base_stats["offloads"] == 0
    assert stats["restores"] == 2 and spills == stats["offloads"] == 3


def test_decode_of_a_slot_does_not_depend_on_the_other_slots(cuda):
    """A slot's logits are bitwise the same whatever length the other
    (inactive) slots hold: decode's shapes must not follow the batch."""
    import dataclasses

    from ant_ray_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.CONFIGS["tiny"], dim=512, n_heads=4, n_kv_heads=2,
        mlp_dim=512, n_layers=2, max_seq=4096, dtype=torch.bfloat16)
    params = llama.init_params(cfg, generator=cuda, device="cuda")
    cache = llama.init_kv_cache(cfg, 4, 4096, device="cuda")
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=cuda,
                                      device="cuda"))
    last = torch.tensor([5, 6, 7, 8], device="cuda")
    active = torch.tensor([True, False, False, False], device="cuda")
    outs = []
    with torch.inference_mode():
        for other in (100, 1000, 3000):
            cache["length"].fill_(other)
            cache["length"][0] = 700
            logits, _ = llama.decode_step(params, last, cache, cfg,
                                          active=active)
            outs.append(logits[0].clone())
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_bf16_directory_loads_onto_the_card_as_on_the_cpu(cuda, tmp_path):
    import dataclasses
    import json

    from ant_ray_tpu_torch.models import checkpoint as ckpt
    from ant_ray_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.CONFIGS["tiny"], dim=256, n_heads=2, n_kv_heads=1,
        mlp_dim=512, n_layers=2, max_seq=512, dtype=torch.bfloat16)
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(3),
                               device="cpu")
    torch.save(ckpt.hf_state_dict(params), str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(ckpt.hf_config(cfg)))
    on_card, config = ckpt.load_llama_params(str(tmp_path), device="cuda")
    on_cpu, _ = ckpt.load_llama_params(str(tmp_path), device="cpu")
    assert config == cfg
    flat = [(k, v) for k, v in on_card.items() if k != "layers"]
    flat += [(f"layers.{k}", v) for k, v in on_card["layers"].items()]
    for name, leaf in flat:
        want = (on_cpu["layers"][name[7:]] if name.startswith("layers.")
                else on_cpu[name])
        orig = (params["layers"][name[7:]] if name.startswith("layers.")
                else params[name])
        assert leaf.is_cuda and leaf.dtype == torch.bfloat16, name
        assert torch.equal(leaf.cpu().view(torch.int16),
                           want.view(torch.int16)), name
        assert torch.equal(want.view(torch.int16),
                           orig.view(torch.int16)), name


def test_device_memory_stats_report_the_card(cuda):
    from ant_ray_tpu_torch.observability import device_memory_stats

    held = torch.empty(1 << 26, dtype=torch.uint8, device="cuda")
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    entry = stats[torch.cuda.current_device()]
    assert entry["platform"] == "gpu"
    assert entry["bytes_in_use"] >= held.numel()
    assert entry["peak_bytes_in_use"] >= entry["bytes_in_use"]
    assert entry["bytes_limit"] == torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory


def test_step_profiler_gives_mfu_against_the_cards_peak(cuda):
    from ant_ray_tpu_torch._private.accelerators import gpu
    from ant_ray_tpu_torch.observability import StepProfiler

    a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    prof = StepProfiler(flops_per_step=2 * 2048 ** 3)
    for _ in range(3):
        with prof.step():
            (a @ a).sum().item()
    summary = prof.summary()
    if gpu.table_generation(torch.cuda.get_device_name()) is not None:
        assert 0 < summary["mfu_mean"] < 1
    else:
        assert "mfu_mean" not in summary


# ------------------------------------------------ runtime and object plane

OBJECT_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                 torch.float8_e4m3fn, torch.int8, torch.uint8, torch.int16,
                 torch.int32, torch.int64, torch.bool, torch.complex64]


def _card_tensor(gen, dtype, shape):
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen, device="cuda") > 0.5
    if dtype.is_complex:
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
    low = 0 if dtype == torch.uint8 else -100
    return torch.randint(low, 100, shape, generator=gen,
                         device="cuda").to(dtype)


def _through_the_arena(value, tmp_path):
    """serialize -> an arena write grant -> seal -> locate -> a pinned
    view -> deserialize, as chip_smoke.py's objects phase does."""
    from ant_ray_tpu_torch._private import object_store
    from ant_ray_tpu_torch._private import serialization as ser
    from ant_ray_tpu_torch._private.ids import ObjectID

    store = object_store.ObjectStore(str(tmp_path / "store"), 64 << 20)
    try:
        assert store.uses_arena
        oid = ObjectID.from_random()
        obj = ser.serialize(value)
        store.create_buffer(oid, obj.payload_nbytes())
        obj.write_into(store.view_unsealed(oid))
        store.seal_buffer(oid)
        info = store.locate(oid)
        view = object_store.ArenaClient().view(info["path"], info["offset"],
                                               info["size"])
        store.pin(oid, token=1)
        out = ser.deserialize(ser.SerializedObject.from_payload(
            view, pin_owner=object()))
        store.unpin(oid, token=1)
        return out, obj.contained_refs
    finally:
        store.destroy()


@pytest.mark.parametrize("dtype", OBJECT_DTYPES, ids=str)
def test_cuda_tensor_through_the_arena_is_bitwise(cuda, dtype, tmp_path):
    t = _card_tensor(cuda, dtype, (33, 70))
    view = t[:, 3::2]                      # non-contiguous, offset
    out, _ = _through_the_arena({"t": t, "view": view}, tmp_path)
    for name, want in (("t", t), ("view", view)):
        got = out[name]
        assert got.device.type == "cuda" and got.dtype == dtype, name
        assert got.shape == want.shape and got.is_contiguous(), name
        assert torch.equal(got.view(torch.uint8),
                           want.contiguous().view(torch.uint8)), name


def test_mixed_object_with_a_ref_through_the_arena(cuda, tmp_path):
    import numpy as np

    from ant_ray_tpu_torch._private.ids import ObjectID
    from ant_ray_tpu_torch.object_ref import ObjectRef

    ref = ObjectRef(ObjectID.from_random(), _skip_refcount=True)
    cache = _card_tensor(cuda, torch.bfloat16, (2, 4, 64, 2, 16))
    value = {"slab": cache[:, 1], "scalar": torch.tensor(2.5, device="cuda"),
             "ints": torch.arange(10, device="cuda"),
             "numpy": np.arange(100.0), "ref": ref}
    out, refs = _through_the_arena(value, tmp_path)
    assert refs == [ref] and out["ref"] == ref
    assert torch.equal(out["slab"], cache[:, 1]) and out["slab"].is_cuda
    assert out["scalar"].shape == () and out["scalar"].item() == 2.5
    assert torch.equal(out["ints"], torch.arange(10, device="cuda"))
    assert (out["numpy"] == np.arange(100.0)).all()


def test_local_mode_actor_serves_an_engine_on_the_card(cuda):
    import ant_ray_tpu_torch as art
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams

    greedy = SamplingParams(max_tokens=8)
    prompts = [[1, 2, 3, 4, 5], list(range(10, 60))]

    @art.remote
    class Server:
        def __init__(self):
            self.engine = LLMEngine("tiny", slots=2, seed=0, device="cuda")

        def generate(self, prompt):
            return self.engine.generate([prompt], greedy)[0].token_ids

    direct = LLMEngine("tiny", slots=2, seed=0, device="cuda")
    art.init(local_mode=True)
    try:
        server = Server.remote()
        refs = [server.generate.remote(p) for p in prompts]
        ready, not_ready = art.wait(refs, num_returns=2, timeout=60)
        assert (len(ready), not_ready) == (2, [])
        assert art.get(refs) == [direct.generate([p], greedy)[0].token_ids
                                 for p in prompts]
        x = torch.randn(64, device="cuda")
        assert art.get(art.put(x)) is x
    finally:
        art.shutdown()


@pytest.fixture
def card_cluster(cuda):
    """A cluster of the port on this machine: its node advertises the
    cards the detector finds."""
    import ant_ray_tpu_torch as art

    art.init(num_cpus=2)
    try:
        yield art
    finally:
        art.shutdown()


def test_cluster_detects_the_card(card_cluster):
    from ant_ray_tpu_torch._private.accelerators import gpu

    assert gpu.num_gpus() == torch.cuda.device_count() >= 1
    assert card_cluster.cluster_resources()["GPU"] == float(
        torch.cuda.device_count())


def test_worker_actor_serves_an_engine_on_the_card(card_cluster):
    """A ``num_gpus=1`` actor builds the engine in its own process, on
    the card, and answers as an engine built here does."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams

    art = card_cluster
    greedy = SamplingParams(max_tokens=8)
    prompts = [[1, 2, 3, 4, 5], list(range(10, 60))]

    @art.remote(num_gpus=1)
    class Server:
        def __init__(self):
            import os

            self.pid = os.getpid()
            self.engine = LLMEngine("tiny", slots=2, seed=0, device="cuda")

        def where(self):
            return self.pid, str(next(iter(
                self.engine.params.values())).device)

        def generate(self, prompt):
            return self.engine.generate([prompt], greedy)[0].token_ids

    import os

    direct = LLMEngine("tiny", slots=2, seed=0, device="cuda")
    server = Server.remote()
    pid, device = art.get(server.where.remote(), timeout=300)
    assert pid != os.getpid() and device.startswith("cuda")
    assert art.get([server.generate.remote(p) for p in prompts]) == \
        [direct.generate([p], greedy)[0].token_ids for p in prompts]
    art.kill(server)


@pytest.mark.parametrize("dtype", OBJECT_DTYPES, ids=str)
def test_task_returns_a_cuda_tensor_bitwise(card_cluster, dtype):
    """A task in a worker process makes a tensor of each dtype on its
    card; the driver gets it on its card, bit for bit."""
    art = card_cluster

    @art.remote(num_gpus=1)
    def make(dtype, shape):
        gen = torch.Generator(device="cuda").manual_seed(0)
        t = torch.randn(shape, generator=gen, device="cuda")
        return (t * 100).to(dtype)

    gen = torch.Generator(device="cuda").manual_seed(0)
    want = (torch.randn((33, 70), generator=gen, device="cuda") * 100
            ).to(dtype)
    got = art.get(make.remote(dtype, (33, 70)), timeout=300)
    assert got.device.type == "cuda" and got.dtype == dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_card_memory_comes_back_after_kill(card_cluster):
    """Killing an actor that holds card memory gives it back: the free
    memory the driver reads returns within 256 MiB of what it was."""
    import time

    art = card_cluster
    torch.cuda.synchronize()
    free_before, _total = torch.cuda.mem_get_info()

    @art.remote(num_gpus=1)
    class Hog:
        def __init__(self):
            self.block = torch.empty(1 << 30, dtype=torch.uint8,
                                     device="cuda")

        def held(self):
            return self.block.numel()

    hog = Hog.remote()
    assert art.get(hog.held.remote(), timeout=300) == 1 << 30
    assert torch.cuda.mem_get_info()[0] < free_before - (1 << 30)
    art.kill(hog)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if torch.cuda.mem_get_info()[0] >= free_before - (256 << 20):
            break
        time.sleep(0.2)
    assert torch.cuda.mem_get_info()[0] >= free_before - (256 << 20)


def test_nccl_group_at_world_size_one(cuda):
    """An NCCL group of one rank on the card: the per-rank verbs hand
    back their input bitwise, on the card in its dtype; a fused
    allreduce of bf16 leaves equals the per-tensor verb; the int8
    transport stays within half a block's step; send to itself raises;
    the group is gone after destroy."""
    from ant_ray_tpu_torch.util import collective as col
    from ant_ray_tpu_torch.util.collective import ReduceOp
    from ant_ray_tpu_torch.util.collective.collective import _group_mgr

    col.init_collective_group(1, 0, backend="nccl", group_name="card1")
    group = _group_mgr.get_group("card1")
    try:
        x = torch.randn(33, 65, generator=cuda, device="cuda")
        for op in ReduceOp:
            got = col.allreduce(x.clone(), "card1", op)
            assert got.device.type == "cuda" and torch.equal(got, x)
        assert torch.equal(col.broadcast(x.clone(), 0, "card1"), x)
        assert torch.equal(col.allgather(x.clone(), "card1")[0], x)
        assert torch.equal(col.reducescatter(x.clone(), "card1"), x)
        col.barrier("card1")
        leaves = [torch.randn(n, generator=cuda, device="cuda").to(
            torch.bfloat16) for n in (7, 4096, 1 << 20)]
        fused = col.allreduce_coalesced([t.clone() for t in leaves],
                                        "card1", bucket_bytes=8192)
        for f, t in zip(fused, leaves):
            assert f.dtype == torch.bfloat16 and torch.equal(f, t)
        q = col.allreduce_coalesced([x.reshape(-1)], "card1",
                                    transport_dtype="int8")[0]
        step = x.abs().max() / 127
        assert float((q - x.reshape(-1)).abs().max()) <= float(step) / 2 + 1e-6
        with pytest.raises(ValueError, match="itself"):
            col.send(x, 0, "card1")
    finally:
        col.destroy_collective_group("card1")
    assert group.destroyed and not col.is_group_initialized("card1")
