"""Which kernels the flash-attention wrappers route to, and what they
refuse, checked on the CPU (no card, no nvcc).

One rule (``_route``) serves both directions: bf16 at head_dim 64 and
128 goes to the tensor-core kernels of ``csrc/flash_attention_fwd_sm90.cu``
and ``csrc/flash_attention_bwd_sm90.cu``; fp32, and bf16 at head_dim 256,
to the CUDA-core kernels of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``.  Shapes no kernel takes raise before any
launch (tested on the meta device, which reaches the kernel checks
without a card), and CPU tensors run the plain version and launch
nothing.
"""

import pytest
import torch

from ant_ray_tpu_torch.ops import _build
from ant_ray_tpu_torch.ops import flash_attention as fa

DTYPES = (torch.float32, torch.bfloat16)


def _counts():
    return (fa.launch_count, fa.fwd_sm90_launch_count,
            fa.bwd_dq_launch_count, fa.bwd_dkv_launch_count,
            fa.bwd_sm90_launch_count)


def _want_route(dtype, head_dim):
    return ("sm90" if dtype == torch.bfloat16 and head_dim in (64, 128)
            else "simt")


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_route_by_dtype_and_head_dim(dtype, head_dim):
    """The one rule, which the backward and the forward share."""
    assert fa._route(dtype, head_dim) == _want_route(dtype, head_dim)


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_wrappers_launch_the_entry_points_of_one_route(
        monkeypatch, dtype, head_dim):
    """The forward and the backward wrapper launch the kernels of the
    route ``_route`` names, and count them.  Meta tensors stand in for
    CUDA ones: the device rule is waived and the launches recorded."""
    launched = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda q, k: None)
    monkeypatch.setattr(fa, "_launch",
                        lambda name, *args: launched.append(name))
    for counter in ("launch_count", "fwd_sm90_launch_count",
                    "bwd_dq_launch_count", "bwd_dkv_launch_count",
                    "bwd_sm90_launch_count"):
        monkeypatch.setattr(fa, counter, 0)
    q, k, v, _, _, do = _meta_inputs(128, 4, 2, head_dim, dtype)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    sm90 = _want_route(dtype, head_dim) == "sm90"
    suffix = "_sm90" if sm90 else ""
    assert launched == [f"flash_attention_fwd{suffix}",
                        f"flash_attention_bwd_dq{suffix}",
                        f"flash_attention_bwd_dkv{suffix}"]
    assert _counts() == (1, int(sm90), 1, 1, int(sm90))


@pytest.mark.parametrize("suffix", ["", "_sm90"])
@pytest.mark.parametrize("kernel", ["fwd", "bwd_dq", "bwd_dkv"])
def test_every_route_names_an_entry_point_with_a_source(kernel, suffix):
    lib, n_ptr = fa._ENTRY_POINTS[f"flash_attention_{kernel}{suffix}"]
    assert (_build.CSRC / f"{lib}.cu").exists()
    assert n_ptr == {"fwd": 5, "bwd_dq": 7, "bwd_dkv": 8}[kernel]


def _meta_inputs(q_len, heads, kv_heads, dim, dtype):
    q = torch.empty((1, q_len, heads, dim), dtype=dtype, device="meta")
    k = torch.empty((1, q_len, kv_heads, dim), dtype=dtype, device="meta")
    lse = torch.empty((1, heads, q_len), dtype=torch.float32, device="meta")
    return q, k, k.clone(), q.clone(), lse, q.clone()


@pytest.mark.parametrize("q_len,dim,dtype,match", [
    (128, 96, torch.bfloat16, "head_dim"),
    (128, 32, torch.float32, "head_dim"),
    (100, 128, torch.bfloat16, "multiples"),
    (128, 64, torch.float16, "bfloat16"),
    (128, 128, torch.bfloat16, "device"),
    (128, 256, torch.float32, "device"),
])
def test_backward_wrapper_raises_on_what_no_kernel_takes(q_len, dim, dtype,
                                                         match):
    before = _counts()
    q, k, v, out, lse, do = _meta_inputs(q_len, 4, 2, dim, dtype)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert _counts() == before


@pytest.mark.parametrize("q_len,dim,dtype,match", [
    (128, 96, torch.bfloat16, "head_dim"),
    (128, 32, torch.float32, "head_dim"),
    (100, 128, torch.bfloat16, "multiples"),
    (128, 64, torch.float16, "bfloat16"),
    (128, 128, torch.bfloat16, "device"),
    (128, 64, torch.bfloat16, "device"),
    (128, 256, torch.float32, "device"),
])
def test_forward_wrapper_raises_on_what_no_kernel_takes(q_len, dim, dtype,
                                                        match):
    before = _counts()
    q, k, v, _, _, _ = _meta_inputs(q_len, 4, 2, dim, dtype)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd_lse(q, k, v, causal=True)
    assert _counts() == before


def test_unaligned_tensor_is_refused_for_the_sm90_kernels():
    whole = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    fa._check_aligned(whole[:64], whole[8:72])     # 16-byte steps
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_aligned(whole[1:65])             # 2 bytes in


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_forward_runs_the_plain_version_and_launches_nothing(
        dtype, head_dim, causal):
    gen = torch.Generator().manual_seed(head_dim + int(causal))

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    q, k, v = (rand(1, 128, 4, head_dim), rand(1, 64, 2, head_dim),
               rand(1, 64, 2, head_dim))
    before = _counts()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    want_out, want_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                        causal=causal)
    assert _counts() == before
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_backward_runs_the_plain_version_and_launches_nothing(dtype,
                                                                  head_dim):
    gen = torch.Generator().manual_seed(head_dim)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    q, k, v, do = (rand(1, 64, 4, head_dim), rand(1, 64, 2, head_dim),
                   rand(1, 64, 2, head_dim), rand(1, 64, 4, head_dim))
    before = _counts()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                           causal=True)
    assert _counts() == before
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
