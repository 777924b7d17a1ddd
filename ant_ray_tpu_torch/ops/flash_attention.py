"""Flash-attention forward with logsumexp: the hand-written CUDA kernel
(``csrc/flash_attention_fwd.cu``), its ctypes binding, and its plain
PyTorch version.

Counterpart of ``flash_attention_fwd_lse`` in
ant_ray_tpu/ops/pallas/flash_attention.py, with the same signature and
layouts.  For a CUDA tensor the wrapper launches the kernel or raises;
the plain version runs only for tensors that lie on the CPU (and as the
comparison in the tests and chip_smoke.py).
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
BLOCK = 64   # the kernel's q and kv tile: lengths must be multiples of it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel; chip_smoke.py resets and reads it to show
# that the serving path went through the kernel.
launch_count = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415

        lib = _build.load("flash_attention_fwd")
        fn = lib.flash_attention_fwd
        # Every pointer and the stream as c_void_p: ctypes would pass a
        # bare int as 32 bits and cut the pointer.
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,D) and k, v (B,Skv,KVH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    batch, _, heads, head_dim = q.shape
    if k.shape[0] != batch or k.shape[3] != head_dim:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if heads % k.shape[2]:
        raise ValueError(f"heads {heads} not a multiple of kv_heads "
                         f"{k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def flash_attention_fwd_lse_ref(q, k, v, *, causal: bool = True,
                                scale: float | None = None):
    """Plain PyTorch version of the kernel's function (full softmax, no
    tiling): fp32 scores, top-left causal mask with NEG_INF, p rounded to
    the input dtype before P.V, l == 0 -> 1, lse = m + log(l)."""
    _check(q, k, v)
    batch, q_len, heads, head_dim = q.shape
    kv_len = k.shape[1]
    groups = heads // k.shape[2]
    scale = scale if scale is not None else head_dim ** -0.5
    qt = q.transpose(1, 2).float()                                # b h q d
    kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).float()
    vt = v.repeat_interleave(groups, dim=2).transpose(1, 2)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale            # b h q k
    if causal:
        q_pos = torch.arange(q_len, device=q.device)[:, None]
        k_pos = torch.arange(kv_len, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vt.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (o / l).to(q.dtype).transpose(1, 2)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            scale: float | None = None):
    """q: (batch, q_len, heads, dim); k/v: (batch, kv_len, kv_heads, dim).
    Returns (out (B,S,H,D) in q.dtype, lse (B,H,S) fp32).

    CUDA tensors go to the hand-written kernel (fp32 or bf16, head_dim
    64/128/256, lengths multiples of 64; anything else raises).  CPU
    tensors go to :func:`flash_attention_fwd_lse_ref`."""
    global launch_count
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                           scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    batch, q_len, heads, head_dim = q.shape
    kv_len, kv_heads = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"not {head_dim}")
    if q_len % BLOCK or kv_len % BLOCK or not (q_len and kv_len and batch):
        raise ValueError(f"flash kernel wants lengths that are positive "
                         f"multiples of {BLOCK}; got ({q_len}, {kv_len})")
    scale = scale if scale is not None else head_dim ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, q_len), dtype=torch.float32,
                      device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), batch, q_len, kv_len, heads, kv_heads,
                 head_dim, _DTYPE_CODES[q.dtype], float(scale), int(causal),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launch_count += 1
    return out, lse
