"""Flash attention: the hand-written CUDA kernels (forward with
logsumexp, and backward as a dQ sweep and a dK/dV sweep), their ctypes
bindings, and their plain PyTorch versions.  :func:`_route` picks the
kernels per dtype, head_dim and direction: the bf16 tensor-core kernels
at head_dim 64 and 128 (``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``), the bf16 tensor-core kernels at
head_dim 256 (``csrc/flash_attention_fwd_sm90_d256.cu``,
``csrc/flash_attention_bwd_sm90_d256.cu``), fp32 on the tensor cores in
3xTF32 at head_dim 64 and 128 (``csrc/flash_attention_fwd_tf32x3.cu``,
``csrc/flash_attention_bwd_tf32x3.cu``, sharing
``csrc/flash_attention_tf32x3.cuh``), and fp32 in 3xTF32 at head_dim 256
(``csrc/flash_attention_fwd_tf32x3_d256.cu``,
``csrc/flash_attention_bwd_tf32x3_d256.cu``).  The CUDA-core kernels
(``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``)
are on no route; chip_smoke.py times them beside their successors.

Counterparts of ``flash_attention_fwd_lse`` and
``flash_attention_backward`` in ant_ray_tpu/ops/pallas/flash_attention.py,
with the same signatures and layouts.  For CUDA tensors a wrapper
launches its kernels or raises; the plain versions run only for tensors
that lie on the CPU (and as the comparison in the tests and
chip_smoke.py).

Both wrappers are also registered as ``torch.library`` custom ops,
``ant_ray_tpu_torch::flash_fwd`` and ``ant_ray_tpu_torch::flash_bwd``,
the forward's autograd formula calling the backward.  Autograd reaches
the kernels through them (``attention(impl="flash")`` in
ops/attention.py), never through the raw forward; and, being ops of the
dispatcher, they are what a selective-checkpoint policy can name
(``saveable_attention_policy``), as the JAX package's remat policies
name the flash kernel's residuals.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
SM90_HEAD_DIMS = (64, 128)     # the sm90 and tf32x3 routes' head dims
BLOCK = 64   # the kernels' lengths must be multiples of it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each CUDA kernel; chip_smoke.py resets and reads them to
# show that a main path went through the kernels.
launch_count = 0           # forward, any route
fwd_sm90_launch_count = 0  # forward launches of the sm90 kernel
fwd_tf32x3_launch_count = 0  # forward launches of the tf32x3 kernel
fwd_sm90_d256_launch_count = 0  # forward launches of the sm90_d256 kernel
fwd_tf32x3_d256_launch_count = 0  # ... of the tf32x3_d256 kernel
bwd_dq_launch_count = 0    # dQ, any route
bwd_dkv_launch_count = 0   # dK/dV, any route
bwd_sm90_launch_count = 0  # backward calls that ran the sm90 pair
bwd_tf32x3_launch_count = 0  # backward calls that ran the tf32x3 pair
bwd_sm90_d256_launch_count = 0  # backward calls that ran the sm90_d256 pair
bwd_tf32x3_d256_launch_count = 0  # ... that ran the tf32x3_d256 pair

# C entry point -> (library, number of pointer arguments).  Every entry
# point then takes batch, q_len, kv_len, heads, kv_heads, head_dim and
# dtype (int), scale (float), causal (int) and the stream.
_ENTRY_POINTS = {
    "flash_attention_fwd": ("flash_attention_fwd", 5),
    "flash_attention_fwd_sm90": ("flash_attention_fwd_sm90", 5),
    "flash_attention_fwd_tf32x3": ("flash_attention_fwd_tf32x3", 5),
    "flash_attention_fwd_sm90_d256": ("flash_attention_fwd_sm90_d256", 5),
    "flash_attention_fwd_tf32x3_d256": ("flash_attention_fwd_tf32x3_d256",
                                        5),
    "flash_attention_bwd_dq": ("flash_attention_bwd", 7),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", 8),
    "flash_attention_bwd_dq_sm90": ("flash_attention_bwd_sm90", 7),
    "flash_attention_bwd_dkv_sm90": ("flash_attention_bwd_sm90", 8),
    "flash_attention_bwd_dq_tf32x3": ("flash_attention_bwd_tf32x3", 7),
    "flash_attention_bwd_dkv_tf32x3": ("flash_attention_bwd_tf32x3", 8),
    "flash_attention_bwd_dq_sm90_d256": ("flash_attention_bwd_sm90_d256", 7),
    "flash_attention_bwd_dkv_sm90_d256": ("flash_attention_bwd_sm90_d256",
                                          8),
    "flash_attention_bwd_dq_tf32x3_d256": ("flash_attention_bwd_tf32x3_d256",
                                           7),
    "flash_attention_bwd_dkv_tf32x3_d256": (
        "flash_attention_bwd_tf32x3_d256", 8),
}
_fns: dict = {}


def _entry(name: str):
    """(C function, error-string function) of one entry point, building
    and loading its library on first use."""
    if name not in _fns:
        from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415

        lib_name, n_ptr = _ENTRY_POINTS[name]
        lib = _build.load(lib_name)
        fn = getattr(lib, name)
        # Every pointer and the stream as c_void_p: ctypes would pass a
        # bare int as 32 bits and cut the pointer.
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_str = lib.flash_attention_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns[name] = (fn, err_str)
    return _fns[name]


def _launch(name: str, tensors, q, k, scale: float, causal: bool) -> None:
    """Launch ``name`` on q's device and current stream with the data
    pointers of ``tensors``; raise if the launch is refused."""
    fn, err_str = _entry(name)
    batch, q_len, heads, head_dim = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), batch, q_len, k.shape[1],
                 heads, k.shape[2], head_dim, _DTYPE_CODES[q.dtype],
                 float(scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(err).decode()} "
                           f"(cudaError {err})")


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


def _check_kernel_inputs(q, k):
    """What the CUDA kernels take; anything else raises.  The device is
    checked last, so that the shape rules can be tested on the meta
    device."""
    batch, q_len, _, head_dim = q.shape
    kv_len = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"not {head_dim}")
    if q_len % BLOCK or kv_len % BLOCK or not (q_len and kv_len and batch):
        raise ValueError(f"flash kernel wants lengths that are positive "
                         f"multiples of {BLOCK}; got ({q_len}, {kv_len})")
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")


def _check_aligned(*tensors):
    """The tensor-core kernels (sm90, sm90_d256, tf32x3, tf32x3_d256) copy
    16 bytes at a time: every base address must lie on a 16-byte
    boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"tensor-core kernels want 16-byte aligned "
                             f"tensors; a {t.dtype} {tuple(t.shape)} tensor "
                             f"starts at {t.data_ptr():#x}")


def _route(dtype, head_dim, direction: str) -> str:
    """Which kernels take inputs of this dtype and head_dim in this
    direction ("fwd" or "bwd"):

    * "sm90", the bf16 tensor-core kernels (wgmma + TMA) of
      csrc/flash_attention_fwd_sm90.cu and csrc/flash_attention_bwd_sm90.cu,
      for bf16 at head_dim 64 or 128, both directions;
    * "tf32x3", the fp32 tensor-core kernels (mma.sync) of
      csrc/flash_attention_fwd_tf32x3.cu and
      csrc/flash_attention_bwd_tf32x3.cu, for fp32 at head_dim 64 or 128,
      both directions.  Each fp32 operand splits into a TF32 high part
      and a TF32 remainder, and three tensor-core products (lo.hi, hi.lo,
      hi.hi) keep ~22 mantissa bits: fp32's accuracy, which one TF32
      product (~2^-11 per product) would not keep;
    * "sm90_d256", the bf16 tensor-core kernels (wgmma + TMA) of
      csrc/flash_attention_fwd_sm90_d256.cu and
      csrc/flash_attention_bwd_sm90_d256.cu, for bf16 at head_dim 256,
      both directions: their own designs, since a 64 x 256 fp32
      accumulator is 128 registers a thread and the D<=128 layouts need
      more shared memory than a block has (each file's header says how
      it lays out the work);
    * "tf32x3_d256", the fp32 tensor-core kernels (mma.sync, 3xTF32) of
      csrc/flash_attention_fwd_tf32x3_d256.cu and
      csrc/flash_attention_bwd_tf32x3_d256.cu, for fp32 at head_dim 256,
      both directions: their own design (eight warps, each owning a
      quarter of the output's columns and summing a quarter of the
      inputs' columns into partial scores, which the four warps of a row
      slice add in a fixed order; each file's header says why).

    The CUDA-core kernels (csrc/flash_attention_fwd.cu,
    csrc/flash_attention_bwd.cu) are on no route.  This is routing, not
    a fallback: each route launches its kernels or raises."""
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction is 'fwd' or 'bwd', not {direction!r}")
    if head_dim in SM90_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "sm90"
        if dtype == torch.float32:
            return "tf32x3"
    if dtype == torch.bfloat16:
        return "sm90_d256"
    return "tf32x3_d256"


# Entry-point name suffix per route.
_SUFFIX = {"sm90": "_sm90", "tf32x3": "_tf32x3", "sm90_d256": "_sm90_d256",
           "tf32x3_d256": "_tf32x3_d256"}


def _scores(q, k, causal, scale):
    """fp32 scores (B,H,Sq,Skv) with GQA heads repeated, and the causal
    mask (True where k_pos > q_pos, top-left alignment) or None."""
    groups = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).float()                                # b h q d
    kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).float()
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale            # b h q k
    mask = None
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = k_pos > q_pos
    return s, mask


def flash_attention_fwd_lse_ref(q, k, v, *, causal: bool = True,
                                scale: float | None = None):
    """Plain PyTorch version of the kernel's function (full softmax, no
    tiling): fp32 scores, top-left causal mask with NEG_INF, p rounded to
    the input dtype before P.V, l == 0 -> 1, lse = m + log(l)."""
    _check(q, k, v)
    groups = q.shape[2] // k.shape[2]
    scale = scale if scale is not None else q.shape[3] ** -0.5
    s, mask = _scores(q, k, causal, scale)
    if mask is not None:
        s = s.masked_fill(mask, NEG_INF)
    vt = v.repeat_interleave(groups, dim=2).transpose(1, 2)
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

    CUDA tensors go to the hand-written kernel of the route
    :func:`_route` picks (fp32 or bf16, head_dim 64/128/256, lengths
    multiples of 64; anything else raises).  CPU tensors go to
    :func:`flash_attention_fwd_lse_ref`.

    The kernel's output is invisible to autograd, so on CUDA this raises
    when grad mode is on and an input requires grad: differentiate
    through ``attention(..., impl="flash")`` instead."""
    global launch_count, fwd_sm90_launch_count, fwd_tf32x3_launch_count
    global fwd_sm90_d256_launch_count, fwd_tf32x3_d256_launch_count
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                           scale=scale)
    _check_kernel_inputs(q, k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd_lse writes its output through a CUDA "
            "kernel that autograd cannot see, so every gradient through it "
            "would be lost; call ant_ray_tpu_torch.ops.attention(q, k, v, "
            "impl='flash'), which runs the backward kernels, or run under "
            "torch.no_grad()")
    scale = scale if scale is not None else q.shape[3] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    route = _route(q.dtype, q.shape[3], "fwd")
    # Every forward route runs on the tensor cores, 16 bytes a copy.
    _check_aligned(q, k, v, out, lse)
    _launch("flash_attention_fwd" + _SUFFIX[route], (q, k, v, out, lse), q,
            k, scale, causal)
    launch_count += 1
    if route == "sm90":
        fwd_sm90_launch_count += 1
    elif route == "tf32x3":
        fwd_tf32x3_launch_count += 1
    elif route == "sm90_d256":
        fwd_sm90_d256_launch_count += 1
    elif route == "tf32x3_d256":
        fwd_tf32x3_d256_launch_count += 1
    return out, lse


# ------------------------------------------------------------- backward


def _check_residuals(q, out, lse, do):
    batch, q_len, heads, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (batch, heads, q_len) or \
            lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 (B,H,Sq) = {(batch, heads, q_len)}"
                         f"; got {lse.dtype} {tuple(lse.shape)}")
    if not (out.dtype == do.dtype == q.dtype):
        raise ValueError(f"out and do must be in q's dtype {q.dtype}; got "
                         f"{out.dtype}, {do.dtype}")
    if not (out.device == lse.device == do.device == q.device):
        raise ValueError("q, out, lse and do must be on one device")


def _delta(out, do):
    """rowsum(dO * O) in fp32, (B,H,Sq): computed outside the kernels, as
    the JAX package does."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2)


def flash_attention_backward_ref(q, k, v, out, lse, do, *, causal: bool,
                                 scale: float | None = None):
    """Plain PyTorch version of the two backward kernels (full matrices,
    fp32), with the TPU kernels' rounding points: p = exp(s - lse) (0
    where k_pos > q_pos), ds = p * (dO.V^T - delta) * scale, ds rounded
    to q's dtype before ds.K and ds^T.Q, p rounded before p^T.dO; dq in
    q's dtype, dk and dv in k's and v's."""
    _check(q, k, v)
    _check_residuals(q, out, lse, do)
    batch, _, heads, head_dim = q.shape
    kv_len, kv_heads = k.shape[1], k.shape[2]
    groups = heads // kv_heads
    scale = scale if scale is not None else head_dim ** -0.5
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    qt = q.transpose(1, 2).float()
    vt = v.repeat_interleave(groups, dim=2).transpose(1, 2).float()
    kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).float()
    dot = do.transpose(1, 2).float()
    dp = torch.matmul(dot, vt.transpose(-1, -2))
    ds = p * (dp - _delta(out, do)[..., None]) * scale
    ds = ds.to(q.dtype).float()
    p = p.to(q.dtype).float()
    dq = torch.matmul(ds, kt)                                     # b h q d

    def per_kv_head(x):   # (b, h, kv, d) summed over each group of heads
        return x.reshape(batch, kv_heads, groups, kv_len, head_dim).sum(2)

    dk = per_kv_head(torch.matmul(ds.transpose(-1, -2), qt))
    dv = per_kv_head(torch.matmul(p.transpose(-1, -2), dot))
    return (dq.to(q.dtype).transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def flash_attention_backward(q, k, v, out, lse, do, *, causal: bool,
                             scale: float | None = None):
    """Returns (dq, dk, dv) in the input layouts (q: (B,S,H,D); k/v:
    (B,S,KVH,D)), given the forward's ``out`` and ``lse`` (B,H,Sq) and
    the output gradient ``do``.

    CUDA tensors go to the dQ kernel and then the dK/dV kernel of the
    route :func:`_route` picks (same dtypes, head dims and lengths as
    the forward; anything else raises), with delta = rowsum(dO * O)
    computed here in fp32.  CPU tensors go to
    :func:`flash_attention_backward_ref`."""
    global bwd_dq_launch_count, bwd_dkv_launch_count, bwd_sm90_launch_count
    global bwd_tf32x3_launch_count, bwd_sm90_d256_launch_count
    global bwd_tf32x3_d256_launch_count
    _check(q, k, v)
    _check_residuals(q, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_backward_ref(q, k, v, out, lse, do,
                                            causal=causal, scale=scale)
    _check_kernel_inputs(q, k)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    q, k, v, do, lse = (t.contiguous() for t in (q, k, v, do, lse))
    delta = _delta(out, do).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    route = _route(q.dtype, q.shape[3], "bwd")
    suffix = _SUFFIX[route]
    # Every backward route runs on the tensor cores, 16 bytes a copy.
    _check_aligned(q, k, v, do, lse, delta, dq, dk, dv)
    _launch("flash_attention_bwd_dq" + suffix,
            (q, k, v, do, lse, delta, dq), q, k, scale, causal)
    bwd_dq_launch_count += 1
    _launch("flash_attention_bwd_dkv" + suffix,
            (q, k, v, do, lse, delta, dk, dv), q, k, scale, causal)
    bwd_dkv_launch_count += 1
    if route == "sm90":
        bwd_sm90_launch_count += 1
    elif route == "tf32x3":
        bwd_tf32x3_launch_count += 1
    elif route == "sm90_d256":
        bwd_sm90_d256_launch_count += 1
    elif route == "tf32x3_d256":
        bwd_tf32x3_d256_launch_count += 1
    return dq, dk, dv


# ---------------------------------------------------------- custom ops
# Each op's function is the wrapper above, so a CUDA tensor launches the
# kernels of its route (and counts them) or raises, and a CPU tensor runs
# the plain version.  Outputs are made contiguous: the kernels write
# contiguous tensors, and a fake tensor must describe what the op
# returns on every device.


@torch.library.custom_op("ant_ray_tpu_torch::flash_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """:func:`flash_attention_fwd_lse` as an op: (out, lse)."""
    out, lse = flash_attention_fwd_lse(q, k, v, causal=causal, scale=scale)
    return out.contiguous(), lse.contiguous()


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, scale):
    batch, q_len, heads, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((batch, heads, q_len), dtype=torch.float32))


@torch.library.custom_op("ant_ray_tpu_torch::flash_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool, scale: float) -> tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]:
    """:func:`flash_attention_backward` as an op: (dq, dk, dv)."""
    grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal,
                                     scale=scale)
    return tuple(g.contiguous() for g in grads)


@flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, out, lse, do, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_fwd_setup(ctx, inputs, output):
    """Saves what the JAX package's ``_flash`` custom VJP saves: (q, k, v,
    out, lse).  lse is a residual, not a result to differentiate: the
    backward kernels take no gradient of it."""
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal,
                           ctx.scale)
    return dq, dk, dv, None, None


flash_fwd.register_autograd(_flash_fwd_backward,
                            setup_context=_flash_fwd_setup)
