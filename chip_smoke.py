#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ant_ray_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds and serves there.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the
final line is printed:

1. Setup: a CUDA device must exist; print the card's name and power
   limit (nvidia-smi); build every hand-written kernel from the sources
   in this checkout, timed.
2. Kernels: the flash-attention forward kernel against its plain
   PyTorch version at the serving path's shapes (Llama-3-8B prefill:
   B=1, H=32, KVH=8, D=128, bf16, causal) and at a few others (fp32
   with D=64, non-causal without GQA, Sq != Skv).  Tolerances: bf16 out
   max abs error <= 2e-2 (bf16 rounds p and out at other points in the
   tiled loop), lse <= 1e-3; fp32 both <= 1e-4.  Times by CUDA events,
   median of 10 runs: the kernel, its plain version, and
   torch's scaled_dot_product_attention as a yardstick the port never
   calls; the bound is the larger of FLOPs over the card's peak for the
   input type and bytes over 3.35 TB/s.
3. Correctness of the model path on a small fp32 model with head_dim
   128: logits through the flash kernel against the plain reference
   attention on the card, and against the same model on the CPU.
4. The serving slice: LLMEngine("llama3-8b", slots=8, max_seq=4096) with
   random weights from a fixed seed, five greedy prompts of 20, 100,
   700, 1500 and 3000 random token ids (buckets 32 to 4096) and one
   seeded sampled prompt of 300, 32 new tokens each.  The flash
   kernel's launch count is reset just before and read just after: it
   must equal n_layers for every prefill with a bucket of 128 or more.
   The 8B logits through the kernel are checked against blockwise
   attention, then prefill time per bucket, decode tokens/s and peak
   memory are printed, and a torch.profiler trace of a short and a long
   prefill and of one decode step gives the device's busy share.
5. One line {"kernels": [...]}, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

TF32 is switched off for matmuls and cuDNN, so fp32 comparisons are
made in full fp32.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-4)}
REPS = 10


def _median_ms(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name, causal):
    """Least time (ms) for the work these inputs need, and what sets it."""
    if causal:   # top-left: query i sees min(i + 1, kv_len) keys
        pairs = sum(min(i + 1, kv_len) for i in range(q_len))
    else:
        pairs = q_len * kv_len
    flops = 4.0 * batch * heads * dim * pairs
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (elt * batch * dim * (2 * q_len * heads + 2 * kv_len * kv_heads)
              + 4 * batch * heads * q_len)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(torch, fa):
    import torch.nn.functional as F  # noqa: PLC0415

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (q_len, kv_len, heads, kv_heads, dim, dtype, causal)
        (128, 128, 32, 8, 128, bf16, True),
        (512, 512, 32, 8, 128, bf16, True),
        (1024, 1024, 32, 8, 128, bf16, True),
        (2048, 2048, 32, 8, 128, bf16, True),
        (4096, 4096, 32, 8, 128, bf16, True),
        (1024, 1024, 32, 8, 64, fp32, True),
        (1024, 1024, 32, 32, 128, bf16, False),
        (128, 256, 32, 8, 128, bf16, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for q_len, kv_len, heads, kv_heads, dim, dtype, causal in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = rand(1, q_len, heads, dim)
        k = rand(1, kv_len, kv_heads, dim)
        v = rand(1, kv_len, kv_heads, dim)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                          causal=causal)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        name = str(dtype).removeprefix("torch.")
        tol_out, tol_lse = TOL[name]
        shape = (f"B=1 Sq={q_len} Skv={kv_len} H={heads} KVH={kv_heads} "
                 f"D={dim} {name} {'causal' if causal else 'full'}")
        if not (err_out <= tol_out and err_lse <= tol_lse):
            raise AssertionError(
                f"flash kernel disagrees with its plain version at {shape}: "
                f"out err {err_out} (tol {tol_out}), lse err {err_lse} "
                f"(tol {tol_lse})")
        del ref_out, ref_lse
        ms = _median_ms(torch, lambda: fa.flash_attention_fwd_lse(
            q, k, v, causal=causal))
        plain_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_lse_ref(
            q, k, v, causal=causal))
        groups = heads // kv_heads
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        bound_ms, bound_by = _bound(1, q_len, kv_len, heads, kv_heads, dim,
                                    name, causal)
        row = {"shape": shape, "max_abs_err": err_out, "lse_err": err_lse,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        print("kernel flash_attention_fwd " + json.dumps(row), flush=True)
        results.append(row)
    return results


def model_check_phase(torch, llama):
    """Small fp32 model, head_dim 128: flash path against the plain
    reference attention on the card, and against the CPU."""
    cfg = dataclasses.replace(
        llama.CONFIGS["tiny"], dim=512, n_heads=4, n_kv_heads=2,
        mlp_dim=512, n_layers=2, max_seq=512, dtype=torch.float32)
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256)))
    with torch.inference_mode():
        flash = llama.forward(params, toks.cuda(), cfg, attn_impl="flash")
        ref = llama.forward(params, toks.cuda(), cfg, attn_impl="reference")
        cpu_params = {k: (v.cpu() if k != "layers" else
                          {n: w.cpu() for n, w in v.items()})
                      for k, v in params.items()}
        cpu = llama.forward(cpu_params, toks, cfg, attn_impl="flash")
    err_ref = (flash - ref).abs().max().item()
    err_cpu = (flash.cpu() - cpu).abs().max().item()
    print(f"model check (fp32, head_dim 128, S=256): flash vs reference "
          f"{err_ref:.3e}, card vs CPU {err_cpu:.3e} (tol 1e-3)", flush=True)
    if not (torch.isfinite(flash).all() and err_ref <= 1e-3
            and err_cpu <= 1e-3):
        raise AssertionError("model check failed")


def slice_phase(torch, fa, llama):
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.engine import _bucket  # noqa: PLC0415

    t0 = time.perf_counter()
    engine = LLMEngine("llama3-8b", slots=8, max_seq=4096, seed=0)
    torch.cuda.synchronize()
    cfg = engine.config
    print(f"llama3-8b engine up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e9:.2f} B params, {cfg.dtype}, slab "
          f"{2 * engine.cache['k'].numel() * 2 / 1e9:.2f} GB)", flush=True)
    rng = np.random.default_rng(0)
    lengths = (20, 100, 700, 1500, 3000)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    sampled_prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    greedy = SamplingParams(max_tokens=32)
    sampled = SamplingParams(max_tokens=32, temperature=0.8, top_k=50,
                             top_p=0.95, seed=1234)

    torch.cuda.reset_peak_memory_stats()
    fa.launch_count = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, greedy)
    outs += engine.generate([sampled_prompt], sampled)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fa.launch_count

    all_lengths = (*lengths, len(sampled_prompt))
    kernel_prefills = sum(1 for n in all_lengths
                          if _bucket(n, engine.max_seq) >= 128)
    for n, out in zip(all_lengths, outs):
        print(f"request prompt={n} bucket={_bucket(n, engine.max_seq)} "
              f"tokens={len(out.token_ids)} finish={out.finish_reason}",
              flush=True)
        if out.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request finished with {out.finish_reason}")
    expected = cfg.n_layers * kernel_prefills
    print(f"main path: {len(outs)} requests in {main_s:.2f} s, flash kernel "
          f"launches {launches} (expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {expected}")

    # Is the 8B path right?  Last-token logits of the 1500-token prompt
    # through the flash kernel against the same model with blockwise
    # attention (the kernel's arithmetic in plain PyTorch).  bf16
    # activations through 32 random layers drift by rounding alone, so the
    # tolerance is measured in this run: the kernel may be at most twice
    # as far from blockwise as the full-softmax reference attention is
    # (two plain versions that differ only in where bf16 rounds).
    n = 1500
    bucket = _bucket(n, engine.max_seq)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
    toks[0, :n] = torch.tensor(prompts[3], device="cuda")
    with torch.inference_mode():
        got, _ = llama.prefill_into_cache(engine.params, toks, engine.cache,
                                          0, n, cfg)
        want, alt = (llama.forward(engine.params, toks, cfg, attn_impl=impl,
                                   logits_at=n - 1)[0]
                     for impl in ("blockwise", "reference"))

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    err, noise = rel_l2(got, want), rel_l2(alt, want)
    tol = 2 * noise + 1e-3
    print(f"8B logits check: shape {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got).all())}, relative L2 error vs "
          f"blockwise {err:.3e}, reference vs blockwise {noise:.3e} "
          f"(tol {tol:.3e})", flush=True)
    if not (got.shape == (cfg.vocab_size,) and torch.isfinite(got).all()
            and err <= tol):
        raise AssertionError("8B logits check failed")

    prefill_ms = {}
    with torch.inference_mode():
        for n in lengths:
            bucket = _bucket(n, engine.max_seq)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
            toks[0, :n] = torch.tensor(prompts[lengths.index(n)],
                                       device="cuda")
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                llama.prefill_into_cache(engine.params, toks, engine.cache,
                                         0, n, cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            prefill_ms[bucket] = statistics.median(times)
        context = 1024
        engine.cache["length"].fill_(context)
        last = torch.zeros((engine.slots,), dtype=torch.int64, device="cuda")

        def step():
            engine.cache["length"].fill_(context)
            llama.decode_step(engine.params, last, engine.cache, cfg)

        decode_ms = _median_ms(torch, step)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print("prefill ms per bucket " + json.dumps(prefill_ms), flush=True)
        print(f"decode: {decode_ms:.2f} ms per step of {engine.slots} slots "
              f"at context {context} = "
              f"{engine.slots / decode_ms * 1e3:.1f} tokens/s; peak memory "
              f"{peak_gb:.2f} GB", flush=True)
        for n in (20, 3000):
            bucket = _bucket(n, engine.max_seq)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
            toks[0, :n] = torch.tensor(prompts[lengths.index(n)],
                                       device="cuda")
            _profile(torch, f"prefill bucket {bucket}",
                     lambda t=toks, n=n: llama.prefill_into_cache(
                         engine.params, t, engine.cache, 0, n, cfg))
        _profile(torch, f"decode step, {engine.slots} slots, context "
                 f"{context}", step)
    return launches


def _profile(torch, label, fn):
    """Where one call's time goes, from a torch.profiler trace: the
    device's busy share of the host wall time, and the kernels that take
    most of it.  A trace without device events reports 'not measured'."""
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device time "
              "not measured (no device events in the trace)", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}); top kernels "
          + json.dumps({name[:60]: round(us / 1e3, 3) for name, us in top}),
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # A reference states and sets both: fp32 comparisons in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"built {names} in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = kernel_phase(torch, fa)
    model_check_phase(torch, llama)
    launches = slice_phase(torch, fa, llama)

    # S=4096, the largest prefill of the slice.
    main_row = next(r for r in rows if r["shape"].startswith("B=1 Sq=4096 "))
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ant_ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "ant_ray_tpu/ops/pallas/flash_attention.py:56",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
