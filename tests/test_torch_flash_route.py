"""Which kernels the flash-attention wrappers route to, and what they
refuse, checked on the CPU (no card, no nvcc).

One rule (``_route``) names the kernels per dtype, head_dim and
direction: bf16 at head_dim 64 and 128 goes to the tensor-core kernels
of ``csrc/flash_attention_fwd_sm90.cu`` and
``csrc/flash_attention_bwd_sm90.cu`` in both directions; fp32 at head_dim
64 and 128 to the 3xTF32 tensor-core kernels of
``csrc/flash_attention_fwd_tf32x3.cu`` and
``csrc/flash_attention_bwd_tf32x3.cu`` in both directions; bf16 at
head_dim 256 to the tensor-core kernels of
``csrc/flash_attention_fwd_sm90_d256.cu`` and
``csrc/flash_attention_bwd_sm90_d256.cu`` in both directions; fp32 at
head_dim 256 to the CUDA-core kernels of ``csrc/flash_attention_fwd.cu``
and ``csrc/flash_attention_bwd.cu``.
Shapes no kernel takes raise before any launch (tested on the meta
device, which reaches the kernel checks without a card), and CPU tensors
run the plain version and launch nothing.
"""

import pytest
import torch

from ant_ray_tpu_torch.ops import _build
from ant_ray_tpu_torch.ops import flash_attention as fa

DTYPES = (torch.float32, torch.bfloat16)


COUNTERS = ("launch_count", "fwd_sm90_launch_count",
            "fwd_tf32x3_launch_count", "bwd_dq_launch_count",
            "bwd_dkv_launch_count", "bwd_sm90_launch_count",
            "bwd_tf32x3_launch_count", "bwd_sm90_d256_launch_count",
            "fwd_sm90_d256_launch_count")


def _counts():
    return tuple(getattr(fa, name) for name in COUNTERS)


def _want_route(dtype, head_dim, direction):
    """The same rule in both directions (``direction`` is checked by
    ``_route`` alone)."""
    if head_dim in (64, 128):
        return "sm90" if dtype == torch.bfloat16 else "tf32x3"
    return "sm90_d256" if dtype == torch.bfloat16 else "simt"


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_route_by_dtype_and_head_dim(dtype, head_dim):
    """The backward: tf32x3 for fp32 at 64 and 128, sm90 for bf16 there,
    sm90_d256 for bf16 at 256, the CUDA cores for fp32 at 256."""
    want = {(torch.float32, 64): "tf32x3", (torch.float32, 128): "tf32x3",
            (torch.bfloat16, 64): "sm90", (torch.bfloat16, 128): "sm90",
            (torch.bfloat16, 256): "sm90_d256"}
    assert fa._route(dtype, head_dim, "bwd") == want.get((dtype, head_dim),
                                                         "simt")


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fwd_route_by_dtype_and_head_dim(dtype, head_dim):
    """The forward: tf32x3 for fp32 at 64 and 128, sm90 for bf16 there,
    sm90_d256 for bf16 at 256, the CUDA cores for fp32 at 256."""
    want = {(torch.float32, 64): "tf32x3", (torch.float32, 128): "tf32x3",
            (torch.bfloat16, 64): "sm90", (torch.bfloat16, 128): "sm90",
            (torch.bfloat16, 256): "sm90_d256"}
    assert fa._route(dtype, head_dim, "fwd") == want.get((dtype, head_dim),
                                                         "simt")


def test_route_refuses_an_unknown_direction():
    with pytest.raises(ValueError, match="direction"):
        fa._route(torch.float32, 64, "forward")


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
    for counter in COUNTERS:
        monkeypatch.setattr(fa, counter, 0)
    q, k, v, _, _, do = _meta_inputs(128, 4, 2, head_dim, dtype)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    fwd, bwd = (_want_route(dtype, head_dim, d) for d in ("fwd", "bwd"))
    suffix = {"sm90": "_sm90", "tf32x3": "_tf32x3", "simt": "",
              "sm90_d256": "_sm90_d256"}
    assert launched == [f"flash_attention_fwd{suffix[fwd]}",
                        f"flash_attention_bwd_dq{suffix[bwd]}",
                        f"flash_attention_bwd_dkv{suffix[bwd]}"]
    assert _counts() == (1, int(fwd == "sm90"), int(fwd == "tf32x3"), 1, 1,
                         int(bwd == "sm90"), int(bwd == "tf32x3"),
                         int(bwd == "sm90_d256"), int(fwd == "sm90_d256"))


@pytest.mark.parametrize("kernel,suffix", [
    *[(kernel, suffix) for suffix in ("", "_sm90", "_tf32x3")
      for kernel in ("fwd", "bwd_dq", "bwd_dkv")],
    ("bwd_dq", "_sm90_d256"), ("bwd_dkv", "_sm90_d256"),
    ("fwd", "_sm90_d256"),
])
def test_every_route_names_an_entry_point_with_a_source(kernel, suffix):
    """Each route's entry points, for each direction it serves, exist with
    their pointer counts in a source that defines them."""
    name = f"flash_attention_{kernel}{suffix}"
    lib, n_ptr = fa._ENTRY_POINTS[name]
    assert f"int {name}(" in (_build.CSRC / f"{lib}.cu").read_text()
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
    (128, 256, torch.bfloat16, "device"),
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


def test_the_bf16_d256_backward_checks_alignment(monkeypatch):
    """The bf16 backward at head_dim 256 copies 16 bytes at a time (TMA):
    its route checks every tensor's alignment before the launches, as
    the other tensor-core routes do."""
    events = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda q, k: None)
    monkeypatch.setattr(fa, "_check_aligned",
                        lambda *ts: events.append(("aligned", len(ts))))
    monkeypatch.setattr(fa, "_launch",
                        lambda name, *args: events.append(("launch", name)))
    for counter in COUNTERS:
        monkeypatch.setattr(fa, counter, 0)
    q, k, v, out, lse, do = _meta_inputs(128, 4, 2, 256, torch.bfloat16)
    fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert events == [("aligned", 9),
                      ("launch", "flash_attention_bwd_dq_sm90_d256"),
                      ("launch", "flash_attention_bwd_dkv_sm90_d256")]
    assert _counts()[3:] == (1, 1, 0, 0, 1, 0)


def test_the_bf16_d256_forward_checks_alignment(monkeypatch):
    """The bf16 forward at head_dim 256 copies 16 bytes at a time (TMA)
    too: its route checks the alignment of q, k, v, out and lse before
    the launch, and counts the launch on its own counter."""
    events = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda q, k: None)
    monkeypatch.setattr(fa, "_check_aligned",
                        lambda *ts: events.append(("aligned", len(ts))))
    monkeypatch.setattr(fa, "_launch",
                        lambda name, *args: events.append(("launch", name)))
    for counter in COUNTERS:
        monkeypatch.setattr(fa, counter, 0)
    q, k, v, _, _, _ = _meta_inputs(128, 4, 2, 256, torch.bfloat16)
    fa.flash_attention_fwd_lse(q, k, v, causal=True)
    assert events == [("aligned", 5),
                      ("launch", "flash_attention_fwd_sm90_d256")]
    assert _counts() == (1, 0, 0, 0, 0, 0, 0, 0, 1)


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_the_fp32_backward_checks_alignment_on_the_tf32x3_route(
        monkeypatch, head_dim):
    """The 3xTF32 kernels copy 16 bytes at a time too: their route checks
    every tensor's alignment before the launches; the CUDA-core pair
    (head_dim 256) needs no such check."""
    events = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda q, k: None)
    monkeypatch.setattr(fa, "_check_aligned",
                        lambda *ts: events.append(("aligned", len(ts))))
    monkeypatch.setattr(fa, "_launch",
                        lambda name, *args: events.append(("launch", name)))
    for counter in COUNTERS:
        monkeypatch.setattr(fa, counter, 0)
    q, k, v, out, lse, do = _meta_inputs(128, 4, 2, head_dim, torch.float32)
    fa.flash_attention_backward(q, k, v, out, lse, do, causal=True)
    suffix = "" if head_dim == 256 else "_tf32x3"
    launches = [("launch", f"flash_attention_bwd_dq{suffix}"),
                ("launch", f"flash_attention_bwd_dkv{suffix}")]
    assert events == (launches if head_dim == 256
                      else [("aligned", 9)] + launches)


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
def test_the_fp32_forward_checks_alignment_on_the_tf32x3_route(
        monkeypatch, head_dim):
    """The 3xTF32 forward copies 16 bytes at a time too: its route checks
    the alignment of q, k, v, out and lse before the launch; the
    CUDA-core kernel (head_dim 256) needs no such check."""
    events = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda q, k: None)
    monkeypatch.setattr(fa, "_check_aligned",
                        lambda *ts: events.append(("aligned", len(ts))))
    monkeypatch.setattr(fa, "_launch",
                        lambda name, *args: events.append(("launch", name)))
    for counter in COUNTERS:
        monkeypatch.setattr(fa, counter, 0)
    q, k, v, _, _, _ = _meta_inputs(128, 4, 2, head_dim, torch.float32)
    fa.flash_attention_fwd_lse(q, k, v, causal=True)
    if head_dim == 256:
        assert events == [("launch", "flash_attention_fwd")]
    else:
        assert events == [("aligned", 5),
                          ("launch", "flash_attention_fwd_tf32x3")]
    assert _counts()[:3] == (1, 0, int(head_dim != 256))


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
