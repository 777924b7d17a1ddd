#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ant_ray_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds, serves and trains
there.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the
final line is printed:

1. Setup: a CUDA device must exist; print the card's name and power
   limit (nvidia-smi); build every hand-written kernel from the sources
   in this checkout, timed, and print the registers and spill bytes
   ptxas reports for each tensor-core kernel (forward and backward, bf16
   and 3xTF32, and bf16 at head_dim 256).
2. Kernels: the flash-attention forward, through flash_attention_fwd_lse
   on the route it picks (told apart by the route counters: the
   tensor-core "sm90" kernel for bf16 at head_dim 64 and 128, the
   tensor-core "tf32x3" kernel for fp32 there, the tensor-core
   "sm90_d256" kernel for bf16 at head_dim 256, the CUDA-core "simt"
   kernel for fp32 there), against its plain PyTorch version at the
   serving path's shapes (Llama-3-8B prefill: B=1, H=32, KVH=8, D=128,
   bf16, causal), at the training slice's (B=8, S=2048, H=8, KVH=4) and
   at others: llama3-1b's heads (D=64), ragged lengths 192 and 320, fp32
   at D=64 and at D=128 with GQA, ragged, non-causal and with Sq < Skv
   and Sq > Skv, non-causal without GQA, D=256 in bf16 and in fp32 (the
   CUDA-core kernel's route: B=1, S=512, H=8, KVH=2), GPT-2's
   (B=8, S=1024, H=KVH=12, D=64) in fp32 and bf16, and bf16 at
   Gemma-7B's and Gemma-2B's attention (B=4, S=2048, D=256, H=KVH=16 and
   H=8 KVH=1) and the head_dim-256 path's own (phase 13: B=2, S=2048,
   H=8, KVH=1; the sm90_d256 kernel's route).  Tolerances: bf16
   out max abs error <= 2e-2 (bf16 rounds p and out at other points in
   the tiled loop), lse <= 1e-3; fp32 both <= 1e-4.  Times by CUDA
   events, median of 10 runs: the kernel launched directly (with its
   achieved TFLOP/s and share of its bound), the wrapper, the plain
   version, and torch's scaled_dot_product_attention as a yardstick the
   port never calls; the bound is the larger of FLOPs over the card's
   peak for the input type and bytes over 3.35 TB/s, tf32x3's at
   3xTF32's rate (494.7/3 TFLOP/s) and also at the 67 TFLOP/s of fp32
   FMAs.  At S=4096 and at the training shape (sm90), at GPT-2's fp32
   shape (tf32x3) and at the three bf16 head_dim-256 shapes (sm90_d256)
   the CUDA-core kernel is also checked and timed, launched directly,
   for a before-and-after on one card.
3. Backward kernels: dQ and dK/dV through flash_attention_backward, on
   the route it picks (tensor-core "sm90" kernels for bf16 at head_dim
   64 and 128, tensor-core "tf32x3" kernels for fp32 there, tensor-core
   "sm90_d256" kernels for bf16 at head_dim 256, CUDA-core "simt"
   kernels for fp32 at head_dim 256), against
   flash_attention_backward_ref at the training slice's shape and
   seventeen others: llama3-1b's heads (D=64), length 192 (ragged on
   128-row tiles), Sq != Skv, fp32 at D=64 and D=128 with GQA, ragged
   and with more keys, D=256 in fp32 and bf16, GPT-2's in fp32 and
   bf16, and Gemma-7B's and Gemma-2B's attention and the head_dim-256
   path's (phase 13: B=2, S=2048, H=8, KVH=1) in bf16 (BWD_TOL: max
   abs error over max |ref| per tensor).  Each line gives per kernel
   its route, time, achieved TFLOP/s and share of its bound (tf32x3's
   at 3xTF32's rate, 494.7/3 TFLOP/s, and also at the 67 TFLOP/s of
   fp32 FMAs); then the whole backward, its plain version, and as a
   yardstick SDPA's backward (fwd+bwd through autograd minus fwd).  The
   bound counts 6*D (dQ), 8*D (dK/dV) and 10*D (the whole backward)
   FLOPs per (q, k) pair against the bytes each must move.  At the
   training shape (sm90), at GPT-2's fp32 shape (tf32x3) and at
   Gemma-7B's attention (sm90_d256) the CUDA-core pair is also checked
   and timed, launched directly, for a before-and-after on one card; at
   GPT-2's fp32 shape a profile names SDPA's kernels.
4. Correctness of the model path on a small fp32 model with head_dim
   128: logits through the flash kernel against the plain reference
   attention on the card, and against the same model on the CPU; then
   the loss and every gradient leaf through the kernels (the 3xTF32
   forward and backward) against reference attention on the card and
   against the CPU, under each remat policy ("none", "full", "dots",
   "matmuls"; the forward kernel runs twice per layer under "full" and
   "dots", once where its out and lse are saved).  Then the same model
   in bf16: loss and every gradient leaf through the sm90 forward and
   backward against bf16 reference attention (BF16_GRAD_TOL, reason
   beside it), with each sm90 kernel run once per layer.
5. The serving slice: LLMEngine("llama3-8b", slots=8, max_seq=4096) with
   random weights from a fixed seed, five greedy prompts of 20, 100,
   700, 1500 and 3000 random token ids (buckets 32 to 4096) and one
   seeded sampled prompt of 300, 32 new tokens each.  The launch counts
   are reset just before and read just after: the sm90 forward must run
   n_layers times for every prefill with a bucket of 128 or more, with
   no CUDA-core forward and no backward launch.
   The 8B logits through the kernel are checked against blockwise
   attention, then prefill time per bucket, decode tokens/s and peak
   memory are printed, and a torch.profiler trace of a short and a long
   prefill and of one decode step gives the device's busy share.
6. Sessions (chunked prefill, offload and restore) on the serving
   slice's 8B weights: LLMEngine(slots=4, max_seq=4096,
   prefill_chunk_tokens=512, profiler=StepProfiler()) with a store that
   keeps one slab in memory and spills the rest to a temporary
   directory in this checkout.  Six greedy sessions whose first turns
   are 300 to 1500 random token ids and second turns 50, 8 new tokens
   each, so that admission evicts idle sessions and their next turns
   restore them; a seventh, sampled, session evicted by force
   mid-generation; a restore held in flight (the store's get waits on an
   event) while an unrelated request runs start to finish.  Gates:
   every turn's tokens equal an engine of the same shape where each
   session runs alone and nothing is evicted; every slab bitwise equal
   (torch.equal) on the host after its offload and in its slot after
   its install; at least two pressure evictions and two restores, the
   forced restore, the held one, a restore from a spill file; no restore
   failure; no flash launch.  Prints the slab's bytes, offload ms and GB/s (host clock,
   into pinned memory), install ms on the card and on the host, step
   times of plain decode steps, of steps that install and of steps with
   a restore fetch in flight, restore_wait_s, peak memory and the
   profiler's summary.
7. EngineLoop on the same weights: four client threads submit eight
   requests of 90 to 600 tokens, half of them in sessions; every handle
   must finish within 120 s without error and stream exactly its final
   tokens; a second turn, then evict_session and end_session through the
   loop.  Prints TTFT per request and loop.stats(); no flash launch.
   The 8B weights are freed after this phase.
8. Serving from a checkpoint directory: llama-400m at its published
   widths and depth (bf16, seed 0) written to a temporary directory of
   this checkout in the HF layout twice, as model.safetensors (a writer
   here: the format's header and raw buffers) and as pytorch_model.bin
   (torch.save); each loaded onto the card through LLMEngine(<dir>,
   slots=8, max_seq=4096, prefill_chunk_tokens=None).  Gates: every leaf
   bitwise equal to the weights in memory; greedy tokens of prompts of
   100, 700 and 1500 token ids equal to an engine on the weights in
   memory; one completion through LLMServer(<dir>) equal to the
   engine's; the sm90 forward launched 24 times per prefill (every bucket
   is 128 or more), nothing else.  Prints per format the file's bytes,
   write and load seconds and GB/s (host clock; the write ends in fsync,
   the load is the engine's construction), then the launches and peak
   memory.
9. LLMServer on Llama-3-8B (random weights from seed 0, slots=8,
   max_seq=4096, the reference's serving defaults: chunks of 64,
   kv_offload="local").  Four client threads send four completions of
   100 to 1500 token ids (one opening a session), two chats, two streams
   (a completion and one of the chats) and the session's second turn;
   then end_session, load_signals, a request whose deadline has passed
   and one whose deadline (0.5 s) runs out mid-generation.  Gates: every
   greedy answer equal to the same request served alone afterwards; each
   stream carrying its answer's tokens, each chunk its token's text;
   chat usage matching the tokens; the expired request shed with the
   engine's stats and request ids untouched; the late one raising after
   its first token; no flash launch.  Prints TTFT per request
   (handle.ttft_s() through the server's loop), the wall time,
   load_signals, device_memory_stats() and peak memory.
10. The training slice: llama-400m at its published widths and all 24
   layers, bf16, random weights from seed 0, one fixed batch of 8 x 2049
   token ids, AdamW (make_optimizer), remat "none": 3 warm-up and 10
   timed train_step calls.  The launch counts are reset just before and
   read just after: every step must launch the forward, dQ and dK/dV
   once per layer, all on the sm90 route.  Prints the step time,
   tokens/s, MFU against the bf16 peak, peak memory and a torch.profiler
   line of one step.
11. Remat: the training slice again, from the same weights, under
   each remat policy ("none", "full", "dots", "matmuls"), 3 warm-up and
   10 timed steps each.  Gates: the forward kernel launched twice per
   layer and step under "full" and "dots" and once under "none" and
   "matmuls" (whose selective-checkpoint policy saves the flash
   forward's out and lse), the backward pair once; the losses of the
   first two steps equal across the policies within BF16_LOSS_TOL.
   Prints per policy the step time, tokens/s, MFU and peak memory, a
   profile, and the step on 1 x 128 tokens, where the host sets the
   time.
12. GPT-2: `gpt2` (124 M) at its published widths and depth, in its
   published fp32 (the 3xTF32 forward and backward) and in a
   bf16 copy (the sm90 kernels at head_dim 64, plain multi-head
   attention), random weights
   from seed 0, a fixed batch of 8 x 1025 token ids, AdamW, 3 warm-up
   and 10 timed steps; every block checkpointed, as in the reference.
   Gates: launches per step (forward twice per layer, backward pair
   once, on the dtype's route); the first loss within GPT2_LOSS_TOL of
   the plain fp32 loss (reference attention) on the same weights; the
   loss falling; the last-position logits of a 1024-token forward within
   GPT2_LOGIT_TOL of reference attention's and the greedy next tokens
   equal but for ties.  Prints step time, tokens/s, MFU against the
   peak of the dtype the step computes in, and peak memory.
13. Head_dim 256: a Llama at Gemma-2B's widths (hidden 2048, 8 heads
   of 256, 1 KV head, MLP 16384, vocab 256000, tied embeddings, 18
   layers; 2.51 B parameters; SwiGLU and no embedding scale, so not
   Gemma), bf16, random weights from seed 0, a fixed batch of 2 x 2049
   token ids, AdamW, remat "none".  First one step's loss and every
   gradient leaf through the kernels against reference attention on the
   card (D256_GRAD_TOL per leaf, max abs error over max |ref|;
   BF16_LOSS_TOL), then 3 warm-up and 10 timed steps.  Gates: per step
   the sm90_d256 forward, dQ and dK/dV once per layer, nothing else;
   the first step's loss within BF16_LOSS_TOL of reference
   attention's; the loss falling.  Prints
   step time, tokens/s, MFU, peak memory and a profile of one step with
   the attention kernels' share.
14. One line {"kernels": [...]} with the twelve kernels (the sm90,
   tf32x3, sm90_d256 and CUDA-core forward; the sm90, tf32x3, sm90_d256
   and CUDA-core dQ and dK/dV; launches by path, the main paths being
   serving, sessions, the loop, the checkpoint directory, the server,
   training, training under each remat policy, GPT-2 in fp32 and bf16
   and the head_dim-256 Llama; the older kernels' times also at GPT-2's
   shape, the sm90_d256 ones at Gemma-7B's and Gemma-2B's attention and
   at the head_dim-256 path's own).
   The three CUDA-core kernels serve only fp32 at head_dim 256, which no
   main path uses: they show 0 launches there, and every other kernel
   must show some;
   then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

TF32 is switched off for matmuls and cuDNN, so fp32 comparisons are
made in full fp32.

Two more modes give the readings behind D256_GRAD_TOL (one GPU):

    python3 chip_smoke.py --d256-gate-readings [CHECKOUT]
    python3 chip_smoke.py --plant-d256-fault FAULT DIR

The first runs CHECKOUT's (default: this directory's) backward kernel
phase and its head_dim-256 gradient check with BWD_TOL["bfloat16"],
D256_GRAD_TOL and BF16_LOSS_TOL at infinity (launch and route gates
stay), then the gradient check twice more with the kernels' plain
versions patched in (the backward, then both directions), and prints
one JSON line.  The second copies this script and the package into DIR
(new) with one of D256_FAULTS planted in the sm90_d256 backward.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
# fp32-accurate products in 3xTF32: three TF32 tensor-core products (495
# TFLOP/s dense, 494.7 in NVIDIA's data sheet) for each fp32 one.
TF32X3_FLOPS = 494.7e12 / 3
PEAK_BYTES = 3.35e12
# Forward: max abs error of out and of lse.  fp32 readings
# (tools/fp32_gate_readings.py, H100 80GB HBM3 at 700 W): the 3xTF32
# forward up to 6.1e-6 (out) and 4.8e-6 (lse); the same kernel with one
# TF32 product 3.9e-4 to 1.8e-3 and 2.4e-4 to 1.1e-3, refused.
TOL = {"bfloat16": (2e-2, 1e-3), "float32": (1e-4, 1e-4)}
# Backward: max abs error over max |ref|, per tensor (dq, dk, dv).  bf16:
# both sides round p and ds to bf16 at the same points but sum in another
# order, so a value near a rounding boundary may land one bf16 ulp
# (2^-8 relative) away; fp32: summation order only (the 3xTF32 products
# keep ~22 mantissa bits).  fp32 readings (tools/fp32_gate_readings.py,
# H100 80GB HBM3 at 700 W): 3xTF32 up to 3.6e-5; the same kernels with
# one TF32 product 3.3e-4 to 9.3e-4, refused.
BWD_TOL = {"bfloat16": {"dq": 1e-2, "dk": 1e-2, "dv": 1e-2},
           "float32": {"dq": 1e-4, "dk": 1e-4, "dv": 1e-4}}
# fp32 model gradients, per leaf, over max |ref|: 7.9e-6 through the
# 3xTF32 backward, 5.3e-4 with one TF32 product (same readings).
GRAD_TOL = 1e-4
# bf16 model gradients through the sm90 kernels against bf16 reference
# attention, per leaf, over max |ref|.  The two paths round at different
# points (the kernels round p before P.V, and p and ds before every
# backward product; reference attention keeps its softmax in fp32), and
# each rounding is up to 2^-9 relative; two layers of bf16 matmuls carry
# that into every leaf.  5e-2 is about ten such roundings in a row, and
# far below what a wrong tile, mask or layout gives (order 1).
BF16_GRAD_TOL = 5e-2
BF16_LOSS_TOL = 1e-2   # the loss (~5.7) on fp32 logits of bf16 layers
# The head_dim-256 Llama's gradients (d256_phase) through the sm90_d256
# forward and backward against bf16 reference attention (softmax in
# fp32), per leaf, over max |ref|.  Readings (--d256-gate-readings, H100
# 80GB HBM3 at 700 W), taken while the forward still ran on the CUDA
# cores: the kernels 5.37e-2, their plain versions on the same path
# 5.50e-2 (backward only) and 5.34e-2 (both): 18 layers carry the bf16
# rounding of p and ds into every leaf, where BF16_GRAD_TOL's two layers
# read 1.2e-2.  With both directions on the tensor cores the kernels read
# 5.26e-2 (d256_phase, same card).  Faults planted in the backward: dQ's
# diagonal masked 0.163, dK/dV's 0.489, a cluster rank's partial dropped
# 0.702, the warpgroups' trade skipped 1.32.  The limit lies between.
D256_GRAD_TOL = 0.1
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


def _pairs(q_len, kv_len, causal):
    """(q, k) pairs the inputs need: top-left causal, query i sees
    min(i + 1, kv_len) keys."""
    if causal:
        return sum(min(i + 1, kv_len) for i in range(q_len))
    return q_len * kv_len


def _roofline(flops, nbytes, dtype_name, peak_flops=None):
    t_ops = flops / (peak_flops or PEAK_FLOPS[dtype_name])
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name, causal,
           peak_flops=None):
    """Least time (ms) for the work these inputs need, what sets it, and
    the FLOPs counted (4*D per (q, k) pair: S = Q.K^T and P.V), at the
    dtype's peak unless ``peak_flops`` names another."""
    flops = 4.0 * batch * heads * dim * _pairs(q_len, kv_len, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (elt * batch * dim * (2 * q_len * heads + 2 * kv_len * kv_heads)
              + 4 * batch * heads * q_len)
    return (*_roofline(flops, nbytes, dtype_name, peak_flops), flops)


def _bwd_bounds(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name,
                causal, peak_flops=None):
    """Least time (ms), what sets it, and the FLOPs counted, for the dQ
    kernel (S, dP, dS.K: 6*D FLOPs per pair; reads q, k, v, dO, lse,
    delta, writes dq), the dK/dV kernel (S, dP, P^T.dO, dS^T.Q: 8*D;
    reads the same, writes dk, dv) and the whole backward (five matmuls,
    10*D; reads q, k, v, out, dO, lse, writes dq, dk, dv), at the
    dtype's peak unless ``peak_flops`` names another."""
    per_dim = batch * heads * dim * _pairs(q_len, kv_len, causal)
    elt = 2 if dtype_name == "bfloat16" else 4
    q_bytes = elt * batch * q_len * heads * dim
    kv_bytes = elt * batch * kv_len * kv_heads * dim
    row_bytes = 4 * batch * heads * q_len
    work = {"dq": (6.0, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
            "dkv": (8.0, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
            "backward": (10.0, 4 * q_bytes + 4 * kv_bytes + row_bytes)}
    return {key: (*_roofline(per * per_dim, nbytes, dtype_name, peak_flops),
                  per * per_dim)
            for key, (per, nbytes) in work.items()}


def _shape(batch, q_len, kv_len, heads, kv_heads, dim, dtype_name, causal):
    return (f"B={batch} Sq={q_len} Skv={kv_len} H={heads} KVH={kv_heads} "
            f"D={dim} {dtype_name} {'causal' if causal else 'full'}")


# Forward shapes at which the CUDA-core kernel (flash_attention_fwd.cu)
# is also launched and timed beside the sm90 one, as (batch, q_len,
# heads): the serving slice's largest prefill and the training slice.
FWD_BEFORE_AFTER = {(1, 4096, 32), (8, 2048, 8)}
# GPT-2's attention (B, Sq, Skv, H, KVH, D): the main path of the fp32
# forward and backward on the tf32x3 route and of the bf16 ones at
# head_dim 64; in fp32 the CUDA-core kernels are also timed there.
GPT2_ATTN = (8, 1024, 1024, 12, 12, 64)
# Gemma-7B's and Gemma-2B's attention (B, Sq, Skv, H, KVH, D) at a
# training batch of 4 x 2048: the shapes of the bf16 head_dim-256 kernels
# (the sm90_d256 forward and backward); there, and at the d256 path's
# own, the CUDA-core forward is also timed, and at Gemma-7B's the
# CUDA-core backward pair.
GEMMA7B_ATTN = (4, 2048, 2048, 16, 16, 256)
GEMMA2B_ATTN = (4, 2048, 2048, 8, 1, 256)
# The shape at which the CUDA-core forward runs on its own route (fp32 at
# head_dim 256, on no main path).
SIMT_FWD_ATTN = (1, 512, 512, 8, 2, 256)
# The head_dim-256 path's batch of token ids (d256_phase): 2 sequences
# of 2048 tokens and the next one.
D256_TOKENS = (2, 2049)


def _d256_config():
    """A Llama at Gemma-2B's widths (google/gemma-2b's config.json: hidden
    2048, 8 heads of 256, 1 KV head, intermediate 16384, vocab 256000,
    tied embeddings, 18 layers, rope theta 10000, norm eps 1e-6): SwiGLU
    and no embedding scale, so a Llama with Gemma's widths, not Gemma;
    bf16."""
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415

    return llama.LlamaConfig(
        vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        mlp_dim=16384, max_seq=8192, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True)


def _d256_attn():
    """The head_dim-256 path's attention (B, Sq, Skv, H, KVH, D), from
    _d256_config and D256_TOKENS."""
    cfg = _d256_config()
    batch, seq = D256_TOKENS[0], D256_TOKENS[1] - 1
    return (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def _fwd_errors(out, lse, ref_out, ref_lse, name, shape, label):
    """Max abs error of out and of lse; raises beyond TOL."""
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    tol_out, tol_lse = TOL[name]
    if not (err_out <= tol_out and err_lse <= tol_lse):
        raise AssertionError(
            f"{label} disagrees with its plain version at {shape}: out err "
            f"{err_out} (tol {tol_out}), lse err {err_lse} (tol {tol_lse})")
    return err_out, err_lse


def _fwd_kernel_ms(torch, fa, name, q, k, v, causal):
    """Median ms of the forward kernel ``name``, launched directly (no
    count), and its (out, lse) from the last launch."""
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    ms = _median_ms(torch, lambda: fa._launch(
        name, (q, k, v, out, lse), q, k, q.shape[3] ** -0.5, causal))
    return ms, out, lse


def _shares(row):
    """A timed row's share of its bound; for tf32x3 at 3xTF32's rate and
    at the fp32 FMA rate."""
    if "share_of_fp32_fma_bound" not in row:
        return f"{row['share_of_bound']:.1%} of its bound"
    return (f"{row['share_of_bound']:.1%} of its 3xTF32 bound, "
            f"{row['share_of_fp32_fma_bound']:.1%} of the fp32 FMA one")


def kernel_phase(torch, fa):
    """The forward kernel, through the route the wrapper picks, against
    flash_attention_fwd_lse_ref; at FWD_BEFORE_AFTER (sm90), at GPT-2's
    fp32 shape (tf32x3) and at Gemma-7B's, Gemma-2B's and the d256 path's
    attention (sm90_d256) also the CUDA-core kernel, launched directly,
    for a before-and-after on one card."""
    import torch.nn.functional as F  # noqa: PLC0415

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal)
        (1, 128, 128, 32, 8, 128, bf16, True),
        (1, 512, 512, 32, 8, 128, bf16, True),
        (1, 1024, 1024, 32, 8, 128, bf16, True),
        (1, 2048, 2048, 32, 8, 128, bf16, True),
        (1, 4096, 4096, 32, 8, 128, bf16, True),
        (8, 2048, 2048, 8, 4, 128, bf16, True),    # the training slice
        (1, 2048, 2048, 32, 8, 64, bf16, True),    # llama3-1b's heads
        (2, 192, 192, 8, 2, 128, bf16, True),      # ragged on 128-row tiles
        (2, 320, 320, 8, 8, 64, bf16, False),
        (1, 1024, 1024, 32, 8, 64, fp32, True),
        (1, 1024, 1024, 32, 8, 128, fp32, True),   # fp32, D=128, GQA 4
        (2, 192, 192, 8, 2, 128, fp32, False),     # fp32, three 64-row tiles
        (1, 128, 256, 32, 8, 64, fp32, True),      # fp32, Sq < Skv
        (1, 256, 128, 32, 8, 128, fp32, True),     # fp32, Sq > Skv
        (1, 1024, 1024, 32, 32, 128, bf16, False),
        (1, 128, 256, 32, 8, 128, bf16, True),
        (1, 256, 128, 32, 8, 128, bf16, True),
        (1, 512, 512, 8, 2, 256, bf16, True),
        (*SIMT_FWD_ATTN, fp32, True),              # head_dim 256 (simt)
        (*GPT2_ATTN, fp32, True),                  # GPT-2, fp32 (tf32x3)
        (*GPT2_ATTN, bf16, True),                  # GPT-2, bf16 (sm90)
        (*GEMMA7B_ATTN, bf16, True),               # head_dim 256 (sm90_d256)
        (*GEMMA2B_ATTN, bf16, True),
        (*_d256_attn(), bf16, True),               # the d256 path's
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = rand(batch, q_len, heads, dim)
        k = rand(batch, kv_len, kv_heads, dim)
        v = rand(batch, kv_len, kv_heads, dim)
        name = str(dtype).removeprefix("torch.")
        shape = _shape(batch, q_len, kv_len, heads, kv_heads, dim, name,
                       causal)
        route = fa._route(dtype, dim, "fwd")
        before = (fa.fwd_sm90_launch_count, fa.fwd_tf32x3_launch_count,
                  fa.fwd_sm90_d256_launch_count)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        took = ("sm90" if fa.fwd_sm90_launch_count > before[0] else
                "tf32x3" if fa.fwd_tf32x3_launch_count > before[1] else
                "sm90_d256" if fa.fwd_sm90_d256_launch_count > before[2]
                else "simt")
        if took != route:
            raise AssertionError(f"forward at {shape} took route {took}, "
                                 f"expected {route}")
        ref_out, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v,
                                                          causal=causal)
        err_out, err_lse = _fwd_errors(out, lse, ref_out, ref_lse, name,
                                       shape, f"{route} forward kernel")
        # At the dtype's peak: the CUDA-core kernel's ceiling (fp32 FMAs)
        # and the sm90 kernel's (bf16 tensor cores).  tf32x3 does
        # fp32-accurate products on the tensor cores, whose ceiling for
        # them is 3xTF32's rate; its bound is taken there.
        fma_bound = _bound(batch, q_len, kv_len, heads, kv_heads, dim, name,
                           causal)
        bound = (_bound(batch, q_len, kv_len, heads, kv_heads, dim, name,
                        causal, TF32X3_FLOPS)
                 if route == "tf32x3" else fma_bound)
        kernel = "flash_attention_fwd" + fa._SUFFIX[route]
        ms, _, _ = _fwd_kernel_ms(torch, fa, kernel, q, k, v, causal)
        simt = None
        attn = (batch, q_len, kv_len, heads, kv_heads, dim)
        if ((route == "sm90" and (batch, q_len, heads) in FWD_BEFORE_AFTER)
                or (route == "tf32x3" and attn == GPT2_ATTN)
                or (route == "sm90_d256" and attn in (
                    GEMMA7B_ATTN, GEMMA2B_ATTN, _d256_attn()))):
            # The CUDA-core kernel on the same inputs, launched
            # directly: the wrapper no longer routes this dtype and
            # head_dim there.
            s_ms, s_out, s_lse = _fwd_kernel_ms(
                torch, fa, "flash_attention_fwd", q, k, v, causal)
            s_err_out, s_err_lse = _fwd_errors(
                s_out, s_lse, ref_out, ref_lse, name, shape,
                "CUDA-core forward kernel")
            simt = {"route": "simt", "max_abs_err": s_err_out,
                    "lse_err": s_err_lse, **_kernel_stats(s_ms, fma_bound)}
            del s_out, s_lse
        del ref_out, ref_lse
        wrapper_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_lse(
            q, k, v, causal=causal))
        plain_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_lse_ref(
            q, k, v, causal=causal))
        groups = heads // kv_heads
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(groups, dim=2).transpose(1, 2).contiguous()
        library_ms = _median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        row = {"shape": shape, "route": route, "max_abs_err": err_out,
               "lse_err": err_lse, **_kernel_stats(ms, bound),
               "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound[0],
               "bound_by": bound[1]}
        if route == "tf32x3":
            row["fp32_fma_bound_ms"] = fma_bound[0]
            row["share_of_fp32_fma_bound"] = fma_bound[0] / ms
        if simt is not None:
            row["simt"] = simt
        print("kernel flash_attention_fwd " + json.dumps(row), flush=True)
        if simt is not None:
            print(f"forward at {shape}: {route} {ms:.3f} ms "
                  f"({_shares(row)}, {row['tflops']:.0f} TFLOP/s) against "
                  f"the CUDA-core kernel's {simt['ms']:.3f} ms "
                  f"({simt['ms'] / ms:.2f}x faster) and SDPA's "
                  f"{library_ms:.3f} ms ({ms / library_ms:.2f}x its time)",
                  flush=True)
        results.append(row)
        del q, k, v, out, lse, qt, kt, vt
    return results


def _bwd_errors(got, want, name, shape, label):
    """Max abs error and max abs error over max |ref| per tensor; raises
    beyond BWD_TOL."""
    abs_err, rel_err = {}, {}
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{key} is {g.dtype} {tuple(g.shape)}, "
                                 f"want {w.dtype} {tuple(w.shape)}")
        abs_err[key] = (g.float() - w.float()).abs().max().item()
        rel_err[key] = abs_err[key] / w.float().abs().max().item()
    if any(rel_err[key] > BWD_TOL[name][key] for key in rel_err):
        raise AssertionError(
            f"{label} disagree with their plain version at {shape}: max abs "
            f"error over max |ref| {rel_err} (tol {BWD_TOL[name]})")
    return abs_err, rel_err


def _kernel_times(torch, fa, suffix, q, k, v, do, lse, delta, causal):
    """Median ms of the dQ and dK/dV kernels named with ``suffix`` (a
    route's, "" for the CUDA-core pair), launched directly (no count),
    and their outputs from the last launch."""
    scale = q.shape[3] ** -0.5
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dq_ms = _median_ms(torch, lambda: fa._launch(
        "flash_attention_bwd_dq" + suffix, (q, k, v, do, lse, delta, dq), q,
        k, scale, causal))
    dkv_ms = _median_ms(torch, lambda: fa._launch(
        "flash_attention_bwd_dkv" + suffix,
        (q, k, v, do, lse, delta, dk, dv), q, k, scale, causal))
    return dq_ms, dkv_ms, (dq, dk, dv)


def _kernel_stats(ms, bound):
    """Per kernel: ms, achieved TFLOP/s of the FLOPs its bound counts, and
    its share of the bound."""
    bound_ms, _by, flops = bound
    return {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": bound_ms / ms}


def bwd_kernel_phase(torch, fa):
    """The dQ and dK/dV kernels, through the route the wrapper picks,
    against flash_attention_backward_ref; at the training shape (sm90),
    at GPT-2's fp32 shape (tf32x3) and at Gemma-7B's attention
    (sm90_d256) also the CUDA-core pair, launched directly, for a
    before-and-after on one card."""
    import torch.nn.functional as F  # noqa: PLC0415

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [  # (batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal)
        (8, 2048, 2048, 8, 4, 128, bf16, True),    # the training slice
        (1, 4096, 4096, 32, 8, 128, bf16, True),
        (1, 2048, 2048, 32, 8, 64, bf16, True),    # llama3-1b's heads
        (2, 192, 192, 8, 2, 128, bf16, True),      # ragged on 128-row tiles
        (2, 192, 192, 8, 8, 64, bf16, False),
        (1, 1024, 1024, 32, 8, 64, fp32, True),
        (1, 1024, 1024, 32, 8, 128, fp32, True),   # fp32, D=128, GQA 4
        (2, 192, 192, 8, 2, 128, fp32, False),     # fp32, three 64-row tiles
        (1, 128, 256, 32, 8, 64, fp32, True),      # fp32, Sq < Skv
        (1, 1024, 1024, 32, 32, 128, bf16, False),
        (1, 128, 256, 32, 8, 128, bf16, True),
        (1, 512, 512, 8, 2, 256, fp32, True),
        (1, 512, 512, 8, 2, 256, bf16, True),
        (*GPT2_ATTN, fp32, True),                  # GPT-2, fp32 (tf32x3)
        (*GPT2_ATTN, bf16, True),                  # GPT-2, bf16 (sm90)
        (*GEMMA7B_ATTN, bf16, True),               # head_dim 256 (sm90_d256)
        (*GEMMA2B_ATTN, bf16, True),
        (*_d256_attn(), bf16, True),               # the d256 path's
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = []
    for batch, q_len, kv_len, heads, kv_heads, dim, dtype, causal in cases:
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q = rand(batch, q_len, heads, dim)
        k = rand(batch, kv_len, kv_heads, dim)
        v = rand(batch, kv_len, kv_heads, dim)
        do = rand(batch, q_len, heads, dim)
        name = str(dtype).removeprefix("torch.")
        shape = _shape(batch, q_len, kv_len, heads, kv_heads, dim, name,
                       causal)
        route = fa._route(dtype, dim, "bwd")
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
        before = (fa.bwd_sm90_launch_count, fa.bwd_tf32x3_launch_count,
                  fa.bwd_sm90_d256_launch_count)
        got = fa.flash_attention_backward(q, k, v, out, lse, do,
                                          causal=causal)
        torch.cuda.synchronize()
        took = ("sm90" if fa.bwd_sm90_launch_count > before[0] else
                "tf32x3" if fa.bwd_tf32x3_launch_count > before[1] else
                "sm90_d256" if fa.bwd_sm90_d256_launch_count > before[2]
                else "simt")
        if took != route:
            raise AssertionError(f"backward at {shape} took route {took}, "
                                 f"expected {route}")
        want = fa.flash_attention_backward_ref(q, k, v, out, lse, do,
                                               causal=causal)
        abs_err, rel_err = _bwd_errors(got, want, name, shape,
                                       f"{route} backward kernels")
        del got

        # At the dtype's peak: the CUDA-core pair's ceiling (fp32 FMAs) and
        # the sm90 kernels' (bf16 tensor cores).
        fma_bounds = _bwd_bounds(batch, q_len, kv_len, heads, kv_heads, dim,
                                 name, causal)
        # tf32x3 does fp32-accurate products on the tensor cores, whose
        # ceiling for them is 3xTF32's rate; its bound is taken there.
        bounds = (_bwd_bounds(batch, q_len, kv_len, heads, kv_heads, dim,
                              name, causal, TF32X3_FLOPS)
                  if route == "tf32x3" else fma_bounds)
        delta = fa._delta(out, do).contiguous()
        dq_ms, dkv_ms, _ = _kernel_times(torch, fa, fa._SUFFIX[route], q, k,
                                         v, do, lse, delta, causal)
        kernels = {key: {"route": route, **_kernel_stats(ms, bounds[key])}
                   for key, ms in (("dq", dq_ms), ("dkv", dkv_ms))}
        if route == "tf32x3":
            for key, row in kernels.items():
                row["fp32_fma_bound_ms"] = fma_bounds[key][0]
                row["share_of_fp32_fma_bound"] = (fma_bounds[key][0]
                                                  / row["ms"])
        simt = None
        attn = (batch, q_len, kv_len, heads, kv_heads, dim)
        gpt2 = attn == GPT2_ATTN
        if ((route == "sm90" and not results) or (route == "tf32x3" and gpt2)
                or (route == "sm90_d256" and attn == GEMMA7B_ATTN)):
            # PR 2's CUDA-core pair on the same inputs, launched directly:
            # the wrapper no longer routes this dtype and head_dim there.
            s_dq_ms, s_dkv_ms, s_got = _kernel_times(
                torch, fa, "", q, k, v, do, lse, delta, causal)
            s_abs, s_rel = _bwd_errors(s_got, want, name, shape,
                                       "CUDA-core backward kernels")
            simt = {"abs_err": s_abs, "rel_err": s_rel,
                    "dq": {"route": "simt", **_kernel_stats(s_dq_ms,
                                                            fma_bounds["dq"])},
                    "dkv": {"route": "simt", **_kernel_stats(
                        s_dkv_ms, fma_bounds["dkv"])}}
            del s_got
        del want, delta
        bwd_ms = _median_ms(torch, lambda: fa.flash_attention_backward(
            q, k, v, out, lse, do, causal=causal))
        plain_ms = _median_ms(torch, lambda: fa.flash_attention_backward_ref(
            q, k, v, out, lse, do, causal=causal))

        # SDPA's backward as a yardstick: fwd+bwd through autograd minus
        # fwd, GQA without a head repeat, top-left causal as here.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        def sdpa_both():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        sdpa_fwd_ms = _median_ms(torch, sdpa)
        sdpa_both_ms = _median_ms(torch, sdpa_both)
        if route == "tf32x3" and gpt2:
            # Which kernels SDPA runs for fp32 (their names say which
            # backend, and so whether the tensor cores do its products).
            _profile(torch, f"SDPA forward and backward at {shape}",
                     sdpa_both, top=8)
        row = {"shape": shape, "route": route, "abs_err": abs_err,
               "rel_err": rel_err, "tol": BWD_TOL[name], "kernels": kernels,
               "bwd_ms": bwd_ms,
               "bwd": _kernel_stats(bwd_ms, bounds["backward"]),
               "plain_ms": plain_ms,
               "library_ms": sdpa_both_ms - sdpa_fwd_ms,
               "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_fwd_bwd_ms": sdpa_both_ms,
               "bounds": bounds, "fma_bounds": fma_bounds}
        if simt is not None:
            row["simt"] = simt
        print("kernel flash_attention_bwd " + json.dumps(row), flush=True)
        if simt is not None:
            pair_ms = simt["dq"]["ms"] + simt["dkv"]["ms"]

            print(f"backward at {shape}: {route} dQ {dq_ms:.3f} ms "
                  f"({_shares(kernels['dq'])}), dK/dV {dkv_ms:.3f} ms "
                  f"({_shares(kernels['dkv'])}); "
                  f"pair {dq_ms + dkv_ms:.3f} ms, whole backward "
                  f"{bwd_ms:.3f} ms against the CUDA-core pair's "
                  f"{pair_ms:.3f} ms ({pair_ms / (dq_ms + dkv_ms):.2f}x "
                  f"faster) and SDPA's backward {row['library_ms']:.3f} ms "
                  f"({bwd_ms / row['library_ms']:.2f}x its time)",
                  flush=True)
        results.append(row)
        del q, k, v, do, out, lse, qt, kt, vt, dot
    return results


def model_check_phase(torch, llama):
    """Small fp32 model, head_dim 128: flash path against the plain
    reference attention on the card, and against the CPU."""
    cfg, params = _small_model(torch, llama)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256)))
    with torch.inference_mode():
        flash = llama.forward(params, toks.cuda(), cfg, attn_impl="flash")
        ref = llama.forward(params, toks.cuda(), cfg, attn_impl="reference")
        cpu = llama.forward(_to_cpu(params), toks, cfg, attn_impl="flash")
    err_ref = (flash - ref).abs().max().item()
    err_cpu = (flash.cpu() - cpu).abs().max().item()
    print(f"model check (fp32, head_dim 128, S=256): flash vs reference "
          f"{err_ref:.3e}, card vs CPU {err_cpu:.3e} (tol 1e-3)", flush=True)
    if not (torch.isfinite(flash).all() and err_ref <= 1e-3
            and err_cpu <= 1e-3):
        raise AssertionError("model check failed")


def _small_model(torch, llama, dtype=None):
    """The small model of the correctness checks (head_dim 128), fp32
    unless ``dtype`` says otherwise."""
    cfg = dataclasses.replace(
        llama.CONFIGS["tiny"], dim=512, n_heads=4, n_kv_heads=2,
        mlp_dim=512, n_layers=2, max_seq=512,
        dtype=dtype or torch.float32)
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    return cfg, params


def _to_cpu(params):
    return {k: (v.cpu() if k != "layers" else
                {n: w.cpu() for n, w in v.items()})
            for k, v in params.items()}


def _reset_counts(fa):
    fa.launch_count = fa.fwd_sm90_launch_count = fa.fwd_tf32x3_launch_count = 0
    fa.fwd_sm90_d256_launch_count = 0
    fa.bwd_dq_launch_count = fa.bwd_dkv_launch_count = 0
    fa.bwd_sm90_launch_count = fa.bwd_tf32x3_launch_count = 0
    fa.bwd_sm90_d256_launch_count = 0


def _counts(fa):
    """Launches since the last reset: the forward on any route, on the
    sm90, the tf32x3 and the sm90_d256 route, dQ and dK/dV on any route,
    and backward calls that took the sm90, the tf32x3 and the sm90_d256
    pair."""
    return {"fwd": fa.launch_count, "fwd_sm90": fa.fwd_sm90_launch_count,
            "fwd_tf32x3": fa.fwd_tf32x3_launch_count,
            "fwd_sm90_d256": fa.fwd_sm90_d256_launch_count,
            "dq": fa.bwd_dq_launch_count, "dkv": fa.bwd_dkv_launch_count,
            "sm90": fa.bwd_sm90_launch_count,
            "tf32x3": fa.bwd_tf32x3_launch_count,
            "sm90_d256": fa.bwd_sm90_d256_launch_count}


def _by_kernel(counts):
    """Launches of each of the twelve kernels from a _counts() dict."""
    tensor_cores = counts["sm90"] + counts["tf32x3"] + counts["sm90_d256"]
    return {"flash_attention_fwd_sm90": counts["fwd_sm90"],
            "flash_attention_fwd_tf32x3": counts["fwd_tf32x3"],
            "flash_attention_fwd_sm90_d256": counts["fwd_sm90_d256"],
            "flash_attention_fwd": (counts["fwd"] - counts["fwd_sm90"]
                                    - counts["fwd_tf32x3"]
                                    - counts["fwd_sm90_d256"]),
            "flash_attention_bwd_dq_sm90": counts["sm90"],
            "flash_attention_bwd_dkv_sm90": counts["sm90"],
            "flash_attention_bwd_dq_tf32x3": counts["tf32x3"],
            "flash_attention_bwd_dkv_tf32x3": counts["tf32x3"],
            "flash_attention_bwd_dq_sm90_d256": counts["sm90_d256"],
            "flash_attention_bwd_dkv_sm90_d256": counts["sm90_d256"],
            "flash_attention_bwd_dq": counts["dq"] - tensor_cores,
            "flash_attention_bwd_dkv": counts["dkv"] - tensor_cores}


# Forward-kernel launches per layer and training step under each remat
# policy: "full" and "dots" recompute the flash forward in the backward,
# "none" and "matmuls" keep its (out, lse).
FWD_PER_LAYER = {"none": 1, "full": 2, "dots": 2, "matmuls": 1}


def grad_check_phase(torch, fa, llama):
    """Loss and every gradient leaf of the small fp32 model through the
    kernels, against reference attention on the card and against the
    CPU, under each remat policy.  Returns the launches and, per policy,
    the two gradient errors."""
    cfg, params = _small_model(torch, llama)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 257)))

    def loss_and_grads(params, toks, impl, remat):
        return _loss_and_grads(torch, llama, cfg, params, toks, impl, remat)

    cpu_params = _to_cpu(params)
    total = dict.fromkeys(_counts(fa), 0)
    readings = {}
    for remat in FWD_PER_LAYER:
        _reset_counts(fa)
        loss, grads = loss_and_grads(params, toks.cuda(), "flash", remat)
        torch.cuda.synchronize()
        launches = _counts(fa)
        ref_loss, ref_grads = loss_and_grads(params, toks.cuda(),
                                             "reference", remat)
        cpu_loss, cpu_grads = loss_and_grads(cpu_params, toks, "flash",
                                             remat)
        err_ref = max((g - ref_grads[k]).abs().max().item()
                      / ref_grads[k].abs().max().item()
                      for k, g in grads.items())
        err_cpu = max((g.cpu() - cpu_grads[k]).abs().max().item()
                      / cpu_grads[k].abs().max().item()
                      for k, g in grads.items())
        fwd = cfg.n_layers * FWD_PER_LAYER[remat]
        want = {"fwd": fwd, "fwd_sm90": 0, "fwd_tf32x3": fwd,
                "fwd_sm90_d256": 0, "dq": cfg.n_layers, "dkv": cfg.n_layers,
                "sm90": 0, "tf32x3": cfg.n_layers, "sm90_d256": 0}
        total = {key: total[key] + launches[key] for key in total}
        readings[remat] = {"vs_reference": err_ref, "vs_cpu": err_cpu}
        print(f"gradient check (fp32, head_dim 128, S=256, remat {remat}): "
              f"loss {loss:.6f}, reference {ref_loss:.6f}, CPU "
              f"{cpu_loss:.6f}; max grad error over max |ref| per leaf: vs "
              f"reference {err_ref:.3e}, vs CPU {err_cpu:.3e} (tol "
              f"{GRAD_TOL}); launches {launches} (expected {want})",
              flush=True)
        if not (abs(loss - ref_loss) <= 1e-5 and abs(loss - cpu_loss) <= 1e-5
                and err_ref <= GRAD_TOL and err_cpu <= GRAD_TOL
                and launches == want):
            raise AssertionError(f"gradient check failed under remat {remat}")
    return total, readings


def _loss_and_grads(torch, model, cfg, params, toks, impl, remat=None):
    """Loss and the gradient of every leaf (by name) of a fresh copy of
    ``params``, through ``model.loss_fn`` (llama's under ``remat``, or
    gpt2's, which checkpoints every block)."""
    leaves = {k: (v.detach().clone().requires_grad_() if k != "layers"
                  else {n: w.detach().clone().requires_grad_()
                        for n, w in v.items()})
              for k, v in params.items()}
    flat = {**{k: v for k, v in leaves.items() if k != "layers"},
            **{f"layers.{n}": w for n, w in leaves["layers"].items()}}
    kw = {} if remat is None else {"remat": remat}
    loss = model.loss_fn(leaves, {"tokens": toks}, cfg, attn_impl=impl, **kw)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


def _rel_err(got, want):
    """Max abs error of ``got`` over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def bf16_grad_check_phase(torch, fa, llama):
    """Loss and every gradient leaf of the small model in bf16 through
    the sm90 backward kernels, against reference attention on the card
    in bf16; the spread of bf16 reference attention around the same
    model in fp32 is printed beside it."""
    cfg, params = _small_model(torch, llama, torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: (v.float() if k != "layers" else
                    {n: w.float() for n, w in v.items()})
                for k, v in params.items()}
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 257))).cuda()
    _reset_counts(fa)
    loss, grads = _loss_and_grads(torch, llama, cfg, params, toks, "flash",
                                  "none")
    torch.cuda.synchronize()
    launches = _counts(fa)
    ref_loss, ref_grads = _loss_and_grads(torch, llama, cfg, params, toks,
                                          "reference", "none")
    _, fp32_grads = _loss_and_grads(torch, llama, cfg32, params32, toks,
                                    "reference", "none")

    err = {k: _rel_err(g, ref_grads[k]) for k, g in grads.items()}
    spread = {k: _rel_err(g, fp32_grads[k]) for k, g in ref_grads.items()}
    worst = max(err, key=err.get)
    want = {"fwd": cfg.n_layers, "fwd_sm90": cfg.n_layers, "fwd_tf32x3": 0,
            "fwd_sm90_d256": 0, "dq": cfg.n_layers, "dkv": cfg.n_layers,
            "sm90": cfg.n_layers, "tf32x3": 0, "sm90_d256": 0}
    print(f"gradient check (bf16, head_dim 128, S=256, remat none, sm90 "
          f"backward): loss {loss:.6f}, reference {ref_loss:.6f}; max grad "
          f"error over max |ref| per leaf vs bf16 reference "
          f"{err[worst]:.3e} ({worst}; tol {BF16_GRAD_TOL}), bf16 reference "
          f"vs fp32 reference up to {max(spread.values()):.3e}; launches "
          f"{launches} (expected {want})", flush=True)
    print("bf16 gradient errors per leaf " + json.dumps(
        {k: [err[k], spread[k]] for k in err}), flush=True)
    if not (abs(loss - ref_loss) <= BF16_LOSS_TOL
            and err[worst] <= BF16_GRAD_TOL and launches == want):
        raise AssertionError("bf16 gradient check failed")
    return launches


def _train_steps(torch, fa, step, per_step, n_steps=13):
    """``n_steps`` calls of ``step`` (a train_step closure), host-timed
    to the loss's ``item()``, with the launch counts reset just before
    and every step's launches held to ``per_step``.  Returns the losses,
    the step times (ms), the launches of the whole run and the peak
    memory (GB)."""
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    losses, step_ms = [], []
    for i in range(n_steps):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step().item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = _counts(fa)
        delta = {key: after[key] - before[key] for key in after}
        if delta != per_step:
            raise AssertionError(f"step {i} launched {delta}, expected "
                                 f"{per_step}")
    launches = _counts(fa)
    return losses, step_ms, launches, torch.cuda.max_memory_allocated() / 1e9


def _llama_400m(torch, llama):
    """llama-400m at its published widths and depth, bf16, weights from
    seed 0, and one fixed batch of 8 x 2049 token ids."""
    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2049))).cuda()
    return cfg, params, tokens


def train_phase(torch, fa, llama):
    """The training slice: llama-400m, batch 8 x 2048, AdamW, remat
    "none"; returns the kernels' launches over its 13 steps."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    remat = "none"
    t0 = time.perf_counter()
    cfg, params, tokens = _llama_400m(torch, llama)
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    optimizer = make_optimizer(params)
    torch.cuda.synchronize()
    print(f"llama-400m up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e6:.1f} M params, {cfg.dtype}, "
          f"{cfg.n_layers} layers)", flush=True)

    def step():
        return train_step(params, optimizer, tokens, cfg, remat=remat)

    per_step = {"fwd": cfg.n_layers, "fwd_sm90": cfg.n_layers,
                "fwd_tf32x3": 0, "fwd_sm90_d256": 0, "dq": cfg.n_layers,
                "dkv": cfg.n_layers, "sm90": cfg.n_layers, "tf32x3": 0,
                "sm90_d256": 0}
    losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                      per_step)
    ms = statistics.median(step_ms[3:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
        "bfloat16"]
    print(f"train llama-400m batch {batch} x seq {seq} remat {remat}: "
          f"losses {[round(x, 4) for x in losses]}; step "
          f"{ms:.2f} ms (median of 10 after 3 warm-up; all "
          f"{[round(x, 1) for x in step_ms]}), {tokens_per_s:.0f} tokens/s, "
          f"MFU {mfu:.4f}, peak memory {peak_gb:.2f} GB; launches over 13 "
          f"steps {launches}", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {losses}: not finite or not "
                             "falling")
    _profile(torch, f"train step llama-400m {batch} x {seq}", step, top=16)
    return launches


def remat_phase(torch, fa, llama):
    """llama-400m's training slice under each remat policy, each from the
    same weights: 3 warm-up and 10 timed steps, a profile, and the step
    on 1 x 128 tokens, where the host sets the time.  Gates: the forward
    kernel launched FWD_PER_LAYER[remat] times per layer and step, the
    backward pair once; the losses of the first two steps (the second
    after one update, so it carries the first step's gradients) equal
    across the policies within BF16_LOSS_TOL.  Returns the launches per
    policy, keyed "remat_<policy>"."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    paths, first = {}, {}
    for remat, fwd in FWD_PER_LAYER.items():
        torch.cuda.empty_cache()
        cfg, params, tokens = _llama_400m(torch, llama)
        batch, seq = tokens.shape[0], tokens.shape[1] - 1
        optimizer = make_optimizer(params)

        def step():
            return train_step(params, optimizer, tokens, cfg, remat=remat)

        n = cfg.n_layers
        per_step = {"fwd": fwd * n, "fwd_sm90": fwd * n, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": n, "dkv": n, "sm90": n,
                    "tf32x3": 0, "sm90_d256": 0}
        losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                          per_step)
        ms = statistics.median(step_ms[3:])
        tokens_per_s = batch * seq / (ms / 1e3)
        mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
            "bfloat16"]
        print(f"remat {remat} llama-400m batch {batch} x seq {seq}: step "
              f"{ms:.2f} ms (median of 10 after 3 warm-up; all "
              f"{[round(x, 1) for x in step_ms]}), {tokens_per_s:.0f} "
              f"tokens/s, MFU {mfu:.4f} (bf16 peak), peak memory "
              f"{peak_gb:.2f} GB; launches per step {per_step}; losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"remat {remat}: losses {losses} not "
                                 "finite or not falling")
        first[remat] = losses[:2]
        paths[f"remat_{remat}"] = launches
        if remat != "none":      # "none" is profiled by train_phase
            _profile(torch, f"train step llama-400m {batch} x {seq} remat "
                     f"{remat}", step, top=16)
        # The host's share: the same step on 1 x 128 tokens, where the
        # card's work is a few ms and the wall time is the host's dispatch
        # of every op (and, under "dots" and "matmuls", the selective-
        # checkpoint dispatch mode's handling of each).
        small = tokens[:1, :129]
        host_ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(params, optimizer, small, cfg, remat=remat).item()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"remat {remat} llama-400m batch 1 x seq 128 (host-bound): "
              f"step {statistics.median(host_ms[2:]):.2f} ms (median of 5 "
              f"after 2 warm-up; all {[round(x, 1) for x in host_ms]})",
              flush=True)
        del params, optimizer, tokens
    spread = [max(v[i] for v in first.values())
              - min(v[i] for v in first.values()) for i in range(2)]
    print(f"remat gates: losses of steps 1 and 2 per policy "
          f"{json.dumps(first)}; spread {spread} (tol {BF16_LOSS_TOL})",
          flush=True)
    if max(spread) > BF16_LOSS_TOL:
        raise AssertionError(f"remat policies disagree on the loss: {first}")
    return paths


# GPT-2's first loss on the card against the plain fp32 loss (reference
# attention) on the same weights.  Both losses are fp32 (log-softmax of
# fp32 logits); what differs is the forward in front of them.  At random
# init the final LayerNorm holds the loss near ln V whatever the hidden
# state, so attention faults move it little.  Readings at this phase's
# shapes (tools/gpt2_loss_faults.py, H100 80GB HBM3 at 700 W): sound runs
# 0 (fp32) and 1.05e-4 (bf16); planted faults, bf16 (fp32 alike):
# log-softmax in bf16 3.6e-4, softmax scale doubled 6.6e-4, no causal
# mask 2.1e-3, no attention 4.5e-3, K/V of the next head 1.6e-2, scale
# halved 7e-5 (bf16) and 2.7e-4 (fp32).  Each limit sits between the
# sound reading and the smallest fault above it (bf16: about their
# geometric mean); the halved scale in bf16 is left to the logit gate.
GPT2_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-4}
# Last-position logits of a 1024-token forward through the kernels
# against reference attention in the same dtype (max abs; the largest
# logits of the random model are ~2-4).  fp32: summation order and
# 3xTF32's ~22 bits per product.  bf16: both paths round every matmul and
# the residual stream to bf16 but at other points inside attention, so
# errors of a few ulps (0.016 at 2-4) pass through twelve layers.
# Readings on the initial weights (tools/gpt2_loss_faults.py): sound
# 4.4e-6 (fp32, the CUDA-core forward) and 0.033 (bf16); the faults
# above 0.17 (scale halved) to 3.2 in either dtype.  On the trained
# weights (tools/fp32_gate_readings.py, H100 80GB HBM3 at 700 W): fp32
# 2.0e-5 through the 3xTF32 forward, 2.3e-4 with one TF32 product; the
# fp32 limit sits between them.
GPT2_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.125}
# GPT-2's fp32 gradients on the initial weights through the kernels
# against reference attention, per leaf, max abs error over max |ref|.
# Readings (tools/fp32_gate_readings.py, H100 80GB HBM3 at 700 W): 3.8e-5
# through the 3xTF32 kernels, 3.2e-4 with one TF32 product in both
# directions (2.9e-4 with it in the backward alone); the limit sits
# between them.  The first loss reads 0 and 9.5e-7 (one ulp at ~11), so
# GPT2_LOSS_TOL cannot tell them apart.
GPT2_GRAD_TOL = 1e-4
PEAK_NAME = {"float32": "fp32 outside the tensor cores (TF32 off)",
             "bfloat16": "bf16 dense"}


def gpt2_phase(torch, fa, dtype_name):
    """GPT-2 (124 M) at its published widths and depth in ``dtype_name``
    (its published fp32, or a bf16 copy), weights from seed 0, a fixed
    batch of 8 x 1025 token ids (T = 1024 = n_positions), AdamW: 3
    warm-up and 10 timed train_step calls.  Gates: every block
    checkpointed, so per step the forward kernel runs twice per layer and
    the backward pair once, on the routes of the dtype (tf32x3 in fp32,
    sm90 in bf16); in fp32, before training, every gradient leaf of the
    loss through the kernels within GPT2_GRAD_TOL of reference
    attention's (the only gate here that sees the backward); the first
    step's loss within GPT2_LOSS_TOL
    of gpt2.loss_fn in fp32 with reference attention on the same
    weights; the loss falling; then, on the trained weights, the
    last-position logits of each of the 8 rows of a 1024-token forward
    through the kernels within GPT2_LOGIT_TOL of the plain path's
    (reference attention, same dtype), and its greedy next tokens equal
    to the plain path's but for ties.  Returns the launches of the
    training steps and the gates' readings."""
    from ant_ray_tpu_torch.models import gpt2  # noqa: PLC0415
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    dtype = getattr(torch, dtype_name)
    cfg = dataclasses.replace(gpt2.CONFIGS["gpt2"], dtype=dtype)
    params = gpt2.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, cfg.n_positions + 1))).cuda()
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        params32 = {k: (v.float() if k != "layers" else
                        {n: w.float() for n, w in v.items()})
                    for k, v in params.items()}
        plain_loss = gpt2.loss_fn(params32, {"tokens": tokens}, cfg32,
                                  attn_impl="reference").item()
        del params32
    grad_err = None
    if dtype_name == "float32":
        _, grads = _loss_and_grads(torch, gpt2, cfg, params, tokens, "flash")
        _, ref_grads = _loss_and_grads(torch, gpt2, cfg, params, tokens,
                                       "reference")
        errs = {key: ((g - ref_grads[key]).abs().max()
                      / ref_grads[key].abs().max()).item()
                for key, g in grads.items()}
        worst = max(errs, key=errs.get)
        grad_err = errs[worst]
        del grads, ref_grads
        print(f"gpt2 {dtype_name} gradients on the initial weights through "
              f"the kernels against reference attention: max error over "
              f"max |ref| {grad_err:.3e} ({worst}; tol {GPT2_GRAD_TOL})",
              flush=True)
        if not grad_err <= GPT2_GRAD_TOL:
            raise AssertionError(f"gpt2 {dtype_name}: gradient error "
                                 f"{grad_err} at {worst}")
    optimizer = make_optimizer(params)

    def step():
        return train_step(params, optimizer, tokens, cfg)

    n = cfg.n_layers
    fwd, bwd = (fa._route(dtype, cfg.head_dim, d) for d in ("fwd", "bwd"))
    per_step = {"fwd": 2 * n, "fwd_sm90": 2 * n * (fwd == "sm90"),
                "fwd_tf32x3": 2 * n * (fwd == "tf32x3"),
                "fwd_sm90_d256": 2 * n * (fwd == "sm90_d256"), "dq": n,
                "dkv": n, "sm90": n * (bwd == "sm90"),
                "tf32x3": n * (bwd == "tf32x3"),
                "sm90_d256": n * (bwd == "sm90_d256")}
    losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                      per_step)
    ms = statistics.median(step_ms[3:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * gpt2.flops_per_token(cfg, seq) / PEAK_FLOPS[
        dtype_name]
    loss_err = abs(losses[0] - plain_loss)
    print(f"gpt2 {dtype_name} batch {batch} x seq {seq} "
          f"({cfg.num_params() / 1e6:.1f} M params, {n} layers, "
          f"{cfg.n_heads} heads of {cfg.head_dim}): step {ms:.2f} ms (median "
          f"of 10 after 3 warm-up; all {[round(x, 1) for x in step_ms]}), "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} against "
          f"{PEAK_FLOPS[dtype_name] / 1e12:.0f} TFLOP/s "
          f"({PEAK_NAME[dtype_name]}), peak memory {peak_gb:.2f} GB; "
          f"launches per step {per_step}; losses "
          f"{[round(x, 4) for x in losses]}; first loss against plain fp32 "
          f"{plain_loss:.6f}: error {loss_err:.3e} (tol "
          f"{GPT2_LOSS_TOL[dtype_name]})", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and loss_err <= GPT2_LOSS_TOL[dtype_name]):
        raise AssertionError(f"gpt2 {dtype_name}: losses {losses}, plain "
                             f"{plain_loss}")
    _profile(torch, f"train step gpt2 {dtype_name} {batch} x {seq}", step,
             top=16)

    prompts = tokens[:, :seq]
    with torch.inference_mode():
        flash = gpt2.forward(params, prompts, cfg)[:, -1].float()
        plain = gpt2.forward(params, prompts, cfg,
                             attn_impl="reference")[:, -1].float()
    got, want = flash.argmax(-1), plain.argmax(-1)
    logit_err = (flash - plain).abs().max().item()
    # With every logit within GPT2_LOGIT_TOL of the plain path's, the
    # card can pick another token only where the plain path's logits of
    # the two lie within twice that: a tie at this precision.
    gap = plain.gather(-1, want[:, None]) - plain.gather(-1, got[:, None])
    tie = gap[:, 0] <= 2 * GPT2_LOGIT_TOL[dtype_name]
    differ = got != want
    print(f"gpt2 {dtype_name} greedy next tokens after {seq}: card "
          f"{got.tolist()}, plain {want.tolist()}; differ at "
          f"{differ.nonzero().flatten().tolist()} (plain logit gaps there "
          f"{gap[differ, 0].tolist()}); max logit difference "
          f"{logit_err:.3e} (tol {GPT2_LOGIT_TOL[dtype_name]})", flush=True)
    if logit_err > GPT2_LOGIT_TOL[dtype_name] or (differ & ~tie).any():
        raise AssertionError(f"gpt2 {dtype_name}: greedy tokens differ "
                             "beyond a tie")
    del params, optimizer, tokens
    return launches, {"loss_err": loss_err, "logit_err": logit_err,
                      "grad_err": grad_err}


def _llama_d256(torch, llama):
    """_d256_config's Llama, weights from seed 0, and one fixed batch of
    D256_TOKENS token ids."""
    cfg = _d256_config()
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, D256_TOKENS)).cuda()
    return cfg, params, tokens


def _d256_grad_check(torch, fa, llama, cfg, params, tokens):
    """One step's loss and every gradient leaf of the head_dim-256 Llama
    through the kernels (remat "none") against reference attention on
    the card.  Returns the loss, the reference's, the per-leaf max abs
    error over max |ref| and the launches of the kernels' step."""
    ref_loss, ref_grads = _loss_and_grads(torch, llama, cfg, params, tokens,
                                          "reference", "none")
    _reset_counts(fa)
    loss, grads = _loss_and_grads(torch, llama, cfg, params, tokens, "flash",
                                  "none")
    torch.cuda.synchronize()
    launches = _counts(fa)
    err = {k: _rel_err(g, ref_grads[k]) for k, g in grads.items()}
    return loss, ref_loss, err, launches


def d256_phase(torch, fa, llama):
    """The head_dim-256 training path: _llama_d256 (2.51 B parameters),
    AdamW, remat "none".  First one step's loss and every gradient leaf
    through the kernels against reference attention on the card
    (D256_GRAD_TOL, BF16_LOSS_TOL); then 3 warm-up and 10 timed
    train_step calls.  Gates: per step the sm90_d256 forward and the
    sm90_d256 backward pair once per layer, no other flash kernel; the
    first step's loss within BF16_LOSS_TOL of reference attention's; the
    loss finite and falling.  Prints step time, tokens/s, MFU against
    the bf16 peak, peak memory and a profile of one step with the
    attention kernels' share.  Returns the launches of the 13 steps."""
    from ant_ray_tpu_torch.train import make_optimizer, train_step  # noqa: PLC0415

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params, tokens = _llama_d256(torch, llama)
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    attn = (batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if attn != _d256_attn():
        raise AssertionError(f"d256 attention {attn}, kernel phases checked "
                             f"{_d256_attn()}")
    print(f"d256 llama up in {time.perf_counter() - t0:.1f} s "
          f"({cfg.num_params() / 1e9:.3f} B params, {cfg.dtype}, "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads of {cfg.head_dim}, "
          f"{cfg.n_kv_heads} KV head)", flush=True)

    n = cfg.n_layers
    fwd, bwd = (fa._route(cfg.dtype, cfg.head_dim, d) for d in ("fwd", "bwd"))
    if (fwd, bwd) != ("sm90_d256", "sm90_d256"):
        raise AssertionError(f"head_dim 256 in bf16 routes to {fwd} and "
                             f"{bwd}")
    per_step = {"fwd": n, "fwd_sm90": 0, "fwd_tf32x3": 0, "fwd_sm90_d256": n,
                "dq": n, "dkv": n, "sm90": 0, "tf32x3": 0, "sm90_d256": n}
    loss, ref_loss, err, grad_launches = _d256_grad_check(
        torch, fa, llama, cfg, params, tokens)
    worst = max(err, key=err.get)
    print(f"d256 gradient check (bf16, {batch} x {seq}, remat none): loss "
          f"{loss:.6f}, reference attention {ref_loss:.6f}; max grad error "
          f"over max |ref| per leaf {err[worst]:.3e} ({worst}; tol "
          f"{D256_GRAD_TOL}); launches {grad_launches}", flush=True)
    print("d256 gradient errors per leaf " + json.dumps(err), flush=True)
    if not (abs(loss - ref_loss) <= BF16_LOSS_TOL
            and err[worst] <= D256_GRAD_TOL and grad_launches == per_step):
        raise AssertionError("d256 gradient check failed")
    torch.cuda.empty_cache()

    optimizer = make_optimizer(params)

    def step():
        return train_step(params, optimizer, tokens, cfg, remat="none")

    losses, step_ms, launches, peak_gb = _train_steps(torch, fa, step,
                                                      per_step)
    ms = statistics.median(step_ms[3:])
    tokens_per_s = batch * seq / (ms / 1e3)
    mfu = tokens_per_s * llama.flops_per_token(cfg, seq) / PEAK_FLOPS[
        "bfloat16"]
    loss_err = abs(losses[0] - ref_loss)
    print(f"train d256 llama batch {batch} x seq {seq} remat none: losses "
          f"{[round(x, 4) for x in losses]}; first loss against reference "
          f"attention {ref_loss:.6f}: error {loss_err:.3e} (tol "
          f"{BF16_LOSS_TOL}); step {ms:.2f} ms (median of 10 after 3 "
          f"warm-up; all {[round(x, 1) for x in step_ms]}), "
          f"{tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}, peak memory "
          f"{peak_gb:.2f} GB; launches per step {per_step}", flush=True)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and loss_err <= BF16_LOSS_TOL):
        raise AssertionError(f"d256 training: losses {losses}, reference "
                             f"first loss {ref_loss}")
    by_name = _profile(torch, f"train step d256 llama {batch} x {seq}", step,
                       top=16)
    if by_name is not None:
        busy = sum(by_name.values())
        attn = {name: us for name, us in by_name.items()
                if re.search(r"flash_(fwd|bwd)", name)}
        print(f"d256 attention kernels: {sum(attn.values()) / 1e3:.2f} ms of "
              f"{busy / 1e3:.2f} ms busy ({sum(attn.values()) / busy:.1%}); "
              + json.dumps({name: round(us / 1e3, 3)
                            for name, us in attn.items()}), flush=True)
    del params, optimizer, tokens
    return launches


def slice_phase(torch, fa, llama):
    """The serving slice; returns the launches of its main path and the
    8B weights, which the sessions and loop phases reuse (the engine and
    its cache go when this returns)."""
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
    _reset_counts(fa)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, greedy)
    outs += engine.generate([sampled_prompt], sampled)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = _counts(fa)

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
    print(f"main path: {len(outs)} requests in {main_s:.2f} s, flash "
          f"forward launches {launches['fwd']}, of them sm90 "
          f"{launches['fwd_sm90']} (expected {expected} and {expected}), "
          f"backward kernel launches {launches['dq']} and {launches['dkv']} "
          f"(expected 0)", flush=True)
    if launches != {"fwd": expected, "fwd_sm90": expected, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                    "tf32x3": 0, "sm90_d256": 0}:
        raise AssertionError(f"serving launched {launches}, expected "
                             f"{expected} sm90 forward and no other launches")

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
    return launches, engine.params


# Sessions phase: Llama-3-8B, 4 slots of 4096 positions, 512-token chunks.
FIRST_TURNS = (300, 560, 820, 1080, 1340, 1500)  # prompt tokens, turn 1
SECOND_TURN = 50                                  # prompt tokens, turns 2-3
SESSION_TOKENS = 8                                # new tokens per turn
FORCED_TURN = (400, 16)         # the force-evicted session: prompt, new
SESSION_DEADLINE_S = 300


def _restore_state(engine) -> str:
    """"fetch" while a restore fetch of ``engine`` runs, "pending" while
    a fetched slab waits for a slot, else "none"."""
    if any(not t["done"] for t in engine._restoring.values()):
        return "fetch"
    return "pending" if engine._restoring else "none"


def _drive(engine, deadline_s=SESSION_DEADLINE_S, after_step=None):
    """Step ``engine`` until it has nothing left; returns its outputs by
    request id.  Raises on a request that finished with an error and on
    a run past ``deadline_s``.  ``after_step(state)`` runs after each
    step, given the _restore_state when it began."""
    outs = {}
    deadline = time.monotonic() + deadline_s
    while engine.has_unfinished():
        inflight = _restore_state(engine)
        if inflight == "fetch" and not (engine._waiting or engine._active
                                        or engine._prefilling):
            time.sleep(0.001)     # only a fetch to wait for: no empty steps
            continue
        for out in engine.step():
            if out.finish_reason == "error":
                raise AssertionError(f"request {out.request_id} failed: "
                                     f"{out.error}")
            outs[out.request_id] = out
        if after_step is not None:
            after_step(inflight)
        if time.monotonic() > deadline:
            raise AssertionError(f"engine still busy after {deadline_s} s")
    return outs


def _first_difference(got, want):
    """Index of the first token where two streams differ."""
    got = got or []
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def _session_turn(engine, sid, prompt, sampling):
    rid = engine.add_request(prompt, sampling, admit=False, session_id=sid)
    return _drive(engine)[rid].token_ids


class _SlabLog:
    """Times and checks every slab that moves between the card and the
    host while installed: wraps ``llama.extract_slot`` and
    ``llama.install_slot``, the two functions the engine moves slabs
    with.  Each offload clones the slot on the card first and is timed
    alone (host clock; it returns once the bytes are on the host); each
    install is timed on the host and by CUDA events, then the slot is
    cloned on the card (two queued copies, inside the engine's
    restore_install phase).  The comparisons run in ``check()``, after
    the step: the host slab against the slot before its offload, and the
    slot after its install against the slot before that session's last
    offload, all with torch.equal."""

    def __init__(self, torch, llama, engine):
        self.torch, self.llama, self.engine = torch, llama, engine
        self.real = (llama.extract_slot, llama.install_slot)
        self.offload_ms, self.install_host_ms, self.install_ms = [], [], []
        self.pending = []
        self.before = {}          # session -> (k, v) on the host
        self.checked = {"offload": 0, "install": 0}
        self.clone_bytes = self.clone_peak = 0

    def __enter__(self):
        self.llama.extract_slot = self._extract
        self.llama.install_slot = self._install
        return self

    def __exit__(self, *exc):
        self.llama.extract_slot, self.llama.install_slot = self.real
        return False

    def _clone(self, cache, slot):
        pair = (cache["k"][:, slot].clone(), cache["v"][:, slot].clone())
        self.clone_bytes += 2 * pair[0].nbytes
        self.clone_peak = max(self.clone_peak, self.clone_bytes)
        return pair

    def _extract(self, cache, slot):
        torch = self.torch
        sid = next(s.session_id for s in self.engine._sessions.values()
                   if s.slot == slot)
        before = self._clone(cache, slot)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, v, length = self.real[0](cache, slot)
        self.offload_ms.append((time.perf_counter() - t0) * 1e3)
        self.pending.append(("offload", sid, before, (k, v)))
        return k, v, length

    def _install(self, cache, k, v, length, slot):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = self.real[1](cache, k, v, length, slot)
        self.install_host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        self.pending.append(("install", slot, self._clone(cache, slot),
                             (start, end)))
        return out

    def check(self):
        torch = self.torch
        for kind, key, pair, extra in self.pending:
            host = tuple(x.cpu() for x in pair)
            self.clone_bytes -= 2 * pair[0].nbytes
            if kind == "offload":
                if not all(torch.equal(a, b) for a, b in zip(host, extra)):
                    raise AssertionError(f"offload of session {key}: the "
                                         "host slab differs from the slot")
                self.before[key] = host
            else:
                sid = next(s.session_id
                           for s in self.engine._sessions.values()
                           if s.slot == key)
                if not all(torch.equal(a, b)
                           for a, b in zip(host, self.before[sid])):
                    raise AssertionError(f"restore of session {sid}: the "
                                         "slot differs from the slot "
                                         "before its offload")
                self.install_ms.append(extra[0].elapsed_time(extra[1]))
            self.checked[kind] += 1
        self.pending = []


def sessions_phase(torch, fa, llama, params):
    """Sessions on Llama-3-8B: six greedy conversations of two turns on
    4 slots, so that admission evicts idle sessions to host memory
    (all but the latest spilled to disk) and their next turns restore
    them; a seventh,
    sampled, session evicted by force mid-generation; and a restore held
    in flight while an unrelated request runs start to finish.  Every
    turn's tokens must equal an engine of the same shape where each
    session runs alone and nothing is evicted, and every slab must come
    back bit for bit.  Returns the launches (none: chunked prefill and
    decode run no flash kernel)."""
    from ant_ray_tpu_torch.llm import LLMEngine, SamplingParams  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.kv_offload import LocalKvStore  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import StepProfiler  # noqa: PLC0415

    class HeldStore(LocalKvStore):
        """A store whose get() waits while ``release`` is clear, and
        which times the puts that spill a slab and the gets that read
        one back from its file."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.release = threading.Event()
            self.release.set()
            self.spill_ms, self.unspill_ms = [], []

        def put(self, key, slab):
            spills, t0 = self.spills, time.perf_counter()
            out = super().put(key, slab)
            if self.spills > spills:
                self.spill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def get(self, handle):
            if not self.release.wait(SESSION_DEADLINE_S):
                raise TimeoutError("restore never released")
            spilled, t0 = handle not in self._mem, time.perf_counter()
            out = super().get(handle)
            if spilled:
                self.unspill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama3-8b"]
    rng = np.random.default_rng(5)

    def tokens(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    first = {f"s{i}": tokens(n) for i, n in enumerate(FIRST_TURNS)}
    second = {sid: tokens(SECOND_TURN) for sid in first}
    third = tokens(SECOND_TURN)                 # s0's held turn
    forced_prompt = tokens(FORCED_TURN[0])
    other_prompt = tokens(200)                  # runs under the held restore
    greedy = SamplingParams(max_tokens=SESSION_TOKENS)
    sampled = SamplingParams(max_tokens=FORCED_TURN[1], temperature=0.8,
                             top_k=50, top_p=0.95, seed=77)

    def engine(**kw):
        return LLMEngine(cfg, params, slots=4, max_seq=4096,
                         prefill_chunk_tokens=512, **kw)

    _reset_counts(fa)
    # The uninterrupted run: each session alone, its turns back to back,
    # then ended, so nothing is ever evicted.
    t0 = time.perf_counter()
    base = engine()
    want = {}
    for sid in first:
        want[sid, 1] = _session_turn(base, sid, first[sid], greedy)
        want[sid, 2] = _session_turn(base, sid, second[sid], greedy)
        if sid == "s0":
            want[sid, 3] = _session_turn(base, sid, third, greedy)
        base.end_session(sid)
    want["forced", 1] = _session_turn(base, "forced", forced_prompt,
                                      sampled)
    want["other", 1] = base.generate([other_prompt], greedy)[0].token_ids
    if base.stats["offloads"]:
        raise AssertionError("the uninterrupted run evicted a session")
    base_s = time.perf_counter() - t0
    del base
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as spill:
        store = HeldStore(spill_dir=spill, capacity_slabs=1)
        prof = StepProfiler(history=4096)
        eng = engine(kv_offload_store=store, profiler=prof)
        # Per step: the _restore_state when it began ("held" while the
        # held store keeps a fetch waiting); its profiler record; the
        # offloads so far.
        steps = []
        torch.cuda.reset_peak_memory_stats()
        with _SlabLog(torch, llama, eng) as log:
            def after_step(state):
                log.check()
                steps.append((state, prof.last, len(log.offload_ms)))

            t0 = time.perf_counter()
            got = {}
            for turn, prompts in ((1, first), (2, second)):
                rids = {eng.add_request(p, greedy, admit=False,
                                        session_id=sid): sid
                        for sid, p in prompts.items()}
                outs = _drive(eng, after_step=after_step)
                got.update({(sid, turn): outs[rid].token_ids
                            for rid, sid in rids.items()})
            pressure = eng.stats["pressure_evictions"]
            restores = eng.stats["restores"]

            # Forced eviction mid-generation, sampled.
            rid = eng.add_request(forced_prompt, sampled, admit=False,
                                  session_id="forced")
            seq = None
            while seq is None or len(seq.generated) < 4:
                eng.step()
                log.check()
                seq = next((s for s in eng._active.values()
                            if s.request_id == rid), None)
            if not eng.evict_session("forced", force=True):
                raise AssertionError("forced eviction refused")
            log.check()
            got["forced", 1] = _drive(eng, after_step=after_step)[
                rid].token_ids
            forced_restores = eng.stats["restores"] - restores

            # A restore held in flight while another request runs.
            if eng._sessions["s0"].state == "resident":
                eng.evict_session("s0")
                log.check()
            store.release.clear()
            rid = eng.add_request(third, greedy, admit=False,
                                  session_id="s0")
            other = eng.add_request(other_prompt, greedy, admit=False)
            held_restores = eng.stats["restores"]
            outs = {}
            deadline = time.monotonic() + SESSION_DEADLINE_S
            while other not in outs:
                state = "held" if _restore_state(eng) == "fetch" else "none"
                outs.update({o.request_id: o for o in eng.step()})
                after_step(state)
                if time.monotonic() > deadline:
                    raise AssertionError("request under the held restore "
                                         "never finished")
            held_ok = (eng.stats["restores"] == held_restores
                       and eng._sessions["s0"].state == "restoring")
            store.release.set()
            outs.update(_drive(eng, after_step=after_step))
            got["s0", 3] = outs[rid].token_ids
            got["other", 1] = outs[other].token_ids
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        slab_bytes = 2 * eng.cache["k"][:, 0].numel() * 2
    launches = _counts(fa)

    stats = eng.stats
    print(f"sessions llama3-8b slots 4 max_seq 4096 chunk 512: slab "
          f"{slab_bytes} B; first turns {list(FIRST_TURNS)} tokens, second "
          f"{SECOND_TURN}, {SESSION_TOKENS} new each; uninterrupted run "
          f"{base_s:.1f} s, this run {run_s:.1f} s; stats "
          + json.dumps(stats), flush=True)
    mismatched = {str(key): _first_difference(got.get(key), want[key])
                  for key in want if got.get(key) != want[key]}
    # Host ms of steps that only decode and offload nothing, by whether
    # a restore fetch was in flight; of steps that install a slab and
    # otherwise only decode; and the decode phase of every step, by
    # whether a fetch was in flight.
    decode_ms = {state: [] for state in ("none", "fetch", "pending", "held")}
    phase_ms = {state: [] for state in decode_ms}
    installs, quiet_installs = [], []
    offloads_before = 0
    for state, rec, offloads in steps:
        ran = set(rec.phases) - {"compute"}
        offloaded = offloads != offloads_before
        offloads_before = offloads
        if "decode" in ran:
            phase_ms[state].append(rec.phases["decode"] * 1e3)
        if "restore_install" in ran:
            installs.append(rec)
            if ran == {"restore_install", "decode"} and not offloaded:
                quiet_installs.append(rec.total_s * 1e3)
        elif ran == {"decode"} and not offloaded:
            decode_ms[state].append(rec.total_s * 1e3)
    plain = decode_ms["none"]

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    gbps = [slab_bytes / (ms * 1e6) for ms in log.offload_ms]
    print(f"offload: {len(log.offload_ms)} slabs, median "
          f"{med(log.offload_ms):.2f} ms = {med(gbps):.2f} GB/s (host clock, "
          f"into pinned memory; all "
          f"{[round(x, 2) for x in log.offload_ms]}); store spills "
          f"{store.spills}", flush=True)
    print(f"install: {len(log.install_ms)} slabs, median device "
          f"{med(log.install_ms):.2f} ms = "
          f"{slab_bytes / (med(log.install_ms) * 1e6):.2f} GB/s, host call "
          f"{med(log.install_host_ms):.3f} ms (all "
          f"{[round(x, 3) for x in log.install_host_ms]}); steps that "
          f"install {[round(r.total_s * 1e3, 1) for r in installs]} ms "
          f"(restore_install phase "
          f"{[round(r.phases['restore_install'] * 1e3, 3) for r in installs]}"
          f" ms), of them install and decode only {quiet_installs} ms, "
          f"against plain decode steps {med(plain):.2f} ms ({len(plain)} "
          f"steps)", flush=True)
    print("restore in flight: decode-only steps (median ms, count) "
          + json.dumps({k: [med(v), len(v)] for k, v in decode_ms.items()})
          + "; decode phase of every step "
          + json.dumps({k: [med(v), len(v)] for k, v in phase_ms.items()})
          + f" (none: no restore; fetch: a fetch running; pending: a "
          f"fetched slab waiting for a slot; held: the held fetch); spills "
          f"{[round(x, 1) for x in store.spill_ms]} ms on the step thread, "
          f"reads of spilled slabs {[round(x, 1) for x in store.unspill_ms]}"
          f" ms on the fetch thread; restore_wait_s "
          f"{stats['restore_wait_s']:.3f}; peak memory {peak_gb:.2f} GB "
          f"(of it at most {log.clone_peak / 1e9:.2f} GB of the check's "
          f"clones)", flush=True)
    print("profiler summary " + json.dumps(prof.summary()), flush=True)
    print(f"sessions gates: mismatched turns (first differing token) "
          f"{mismatched} of {len(want)}; "
          f"slabs checked {log.checked}; pressure evictions {pressure} and "
          f"restores {restores} in turns 1-2, forced restores "
          f"{forced_restores}, held restore pending while the other request "
          f"ran {held_ok}; launches {launches}", flush=True)
    if mismatched:
        raise AssertionError(f"turns {sorted(mismatched)} differ from the "
                             "uninterrupted run")
    if not (log.checked["offload"] == stats["offloads"] > 0
            and log.checked["install"] == stats["restores"] > 0):
        raise AssertionError(f"slab checks {log.checked} do not cover "
                             f"{stats['offloads']} offloads and "
                             f"{stats['restores']} restores")
    if not (pressure >= 2 and restores >= 2 and forced_restores == 1
            and held_ok and stats["restore_failures"] == 0
            and store.unspill_ms):
        raise AssertionError("the sessions run did not exercise pressure "
                             "eviction, restores, a forced eviction, a held "
                             "restore and a restore from a spill file as it "
                             "must")
    if any(launches.values()):
        raise AssertionError(f"the sessions path launched {launches}, "
                             "expected no flash kernel")
    return launches


def loop_phase(torch, fa, llama, params):
    """EngineLoop on Llama-3-8B: four client threads submit eight
    requests, half of them in sessions; every handle must finish without
    error within its timeout, streaming exactly its final tokens; then
    one session is evicted and every session ended through the loop."""
    from ant_ray_tpu_torch.llm import EngineLoop, LLMEngine, SamplingParams  # noqa: PLC0415

    cfg = llama.CONFIGS["llama3-8b"]
    rng = np.random.default_rng(9)
    lengths = (120, 480, 250, 600, 90, 360, 530, 200)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    greedy = SamplingParams(max_tokens=SESSION_TOKENS)
    sids = {j: f"loop-{j}" for j in range(len(prompts)) if j % 2}
    engine = LLMEngine(cfg, params, slots=4, max_seq=4096,
                       prefill_chunk_tokens=512)
    _reset_counts(fa)
    loop = EngineLoop(engine, metrics_interval_s=0.5)
    handles, errors = {}, []
    try:
        def client(c):
            try:
                for j in (2 * c, 2 * c + 1):
                    handles[j] = loop.submit(prompts[j], greedy,
                                             session_id=sids.get(j))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors or len(handles) != len(prompts):
            raise AssertionError(f"submission failed: {errors}")
        outs = {j: handles[j].wait(timeout=120) for j in sorted(handles)}
        wall_s = time.perf_counter() - t0
        for j, h in sorted(handles.items()):
            streamed = [e["token_id"] for e in h if e["type"] == "token"]
            if streamed != outs[j].token_ids or not outs[j].token_ids:
                raise AssertionError(f"request {j} streamed {streamed}, "
                                     f"returned {outs[j].token_ids}")
        # A second turn for one session, evicted through the loop after.
        again = loop.submit(prompts[0][:SECOND_TURN], greedy,
                            session_id=sids[1])
        again.wait(timeout=120)
        stats = loop.stats()
        evicted = loop.evict_session(sids[1])
        ended = [loop.end_session(sid) for sid in sids.values()]
    finally:
        loop.shutdown(timeout=30)
    launches = _counts(fa)
    ttft = {j: round(h.ttft_s() * 1e3, 1) for j, h in sorted(handles.items())}
    print(f"loop llama3-8b slots 4: {len(outs)} requests from 4 threads in "
          f"{wall_s:.2f} s; TTFT ms by request (prompt tokens "
          f"{list(lengths)}) {ttft}; evicted {evicted}, ended {ended}; "
          f"stats {json.dumps(stats)}; engine stats "
          f"{json.dumps(engine.stats)}; launches {launches}", flush=True)
    if loop._thread.is_alive():
        raise AssertionError("the loop thread did not stop")
    if not (evicted and all(ended) and engine.resident_sessions() == 0):
        raise AssertionError("evict_session / end_session through the loop "
                             "failed")
    if any(launches.values()):
        raise AssertionError(f"the loop path launched {launches}, expected "
                             "no flash kernel")
    return launches


def _write_safetensors(torch, path, state):
    """A bf16 state dict as one safetensors file: an 8-byte little-endian
    header length, a JSON header of each tensor's dtype, shape and byte
    range (padded with spaces to 8 bytes), then the raw buffers."""
    header, offset = {}, 0
    for name, t in state.items():
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the writer takes bf16, not {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in state.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())
        f.flush()
        os.fsync(f.fileno())


def _bitwise_equal(torch, a, b):
    """Every leaf of two trees has the same dtype, shape and bits."""
    flat_a = {**{k: v for k, v in a.items() if k != "layers"},
              **{f"layers.{k}": v for k, v in a["layers"].items()}}
    flat_b = {**{k: v for k, v in b.items() if k != "layers"},
              **{f"layers.{k}": v for k, v in b["layers"].items()}}
    return flat_a.keys() == flat_b.keys() and all(
        v.dtype == flat_b[k].dtype and v.shape == flat_b[k].shape
        and torch.equal(v.view(torch.int16), flat_b[k].view(torch.int16))
        for k, v in flat_a.items())


# Checkpoint phase: llama-400m, greedy prompts (buckets 128, 1024, 2048).
CKPT_PROMPTS = (100, 700, 1500)
CKPT_TOKENS = 16


def checkpoint_phase(torch, fa, llama):
    """Serving from a checkpoint directory: llama-400m's random weights
    (seed 0) written as a HF directory twice, as model.safetensors (by
    _write_safetensors) and as pytorch_model.bin (torch.save), in a
    temporary directory of this checkout; each loaded onto the card
    through LLMEngine(<dir>, prefill_chunk_tokens=None).  Gates: leaves
    bitwise equal to the weights in memory; greedy tokens of three
    prompts equal to an engine on the weights in memory; one completion
    through LLMServer(<dir>) equal to the engine's; the sm90 forward
    launched n_layers times per prefill (every bucket here is 128 or
    more), nothing else.  Returns the launches of the directory engines
    and the server."""
    from ant_ray_tpu_torch.llm import (LLMEngine, LLMServer,  # noqa: PLC0415
                                       SamplingParams, get_tokenizer)
    from ant_ray_tpu_torch.models import checkpoint as ckpt  # noqa: PLC0415

    torch.cuda.empty_cache()
    cfg = llama.CONFIGS["llama-400m"]
    params = llama.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in CKPT_PROMPTS]
    greedy = SamplingParams(max_tokens=CKPT_TOKENS)
    kw = dict(slots=8, max_seq=4096, prefill_chunk_tokens=None)

    ref = LLMEngine(cfg, params, **kw)
    want = [o.token_ids for o in ref.generate(prompts, greedy)]
    want_solo = ref.generate([prompts[1]], greedy)[0].token_ids
    del ref
    state = ckpt.hf_state_dict(params)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    per_format = {}
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        for fmt, fname in (("safetensors", "model.safetensors"),
                           ("bin", "pytorch_model.bin")):
            path = os.path.join(tmp, fmt)
            os.makedirs(path)
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(ckpt.hf_config(cfg), f)
            t0 = time.perf_counter()
            if fmt == "safetensors":
                _write_safetensors(torch, os.path.join(path, fname), state)
            else:
                with open(os.path.join(path, fname), "wb") as f:
                    torch.save(state, f)
                    f.flush()
                    os.fsync(f.fileno())
            write_s = time.perf_counter() - t0
            size = os.path.getsize(os.path.join(path, fname))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded, _ = ckpt.load_llama_params(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            bitwise = _bitwise_equal(torch, loaded, params)
            del loaded
            # LLMEngine(<dir>) also asks get_tokenizer(<dir>) for the
            # directory's tokenizer: timed alone here (the first call
            # imports transformers where it exists).
            t0 = time.perf_counter()
            get_tokenizer(path)
            tokenizer_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            engine = LLMEngine(path, **kw)
            torch.cuda.synchronize()
            engine_s = time.perf_counter() - t0
            bitwise = bitwise and _bitwise_equal(torch, engine.params, params)
            before = _counts(fa)["fwd_sm90"]
            got = [o.token_ids for o in engine.generate(prompts, greedy)]
            launched = _counts(fa)["fwd_sm90"] - before
            per_format[fmt] = {
                "file_bytes": size, "write_s": write_s,
                "write_GBps": size / write_s / 1e9, "load_s": load_s,
                "load_GBps": size / load_s / 1e9,
                "get_tokenizer_s": tokenizer_s, "engine_s": engine_s,
                "bitwise": bitwise,
                "tokens_equal": got == want, "sm90_launches": launched}
            print(f"checkpoint llama-400m {fmt}: "
                  f"{json.dumps(per_format[fmt])}", flush=True)
            del engine
            if fmt == "safetensors":
                server = LLMServer(path, prefill_chunk_tokens=None, slots=8,
                                   max_seq=4096)
                try:
                    answer = server({"prompt": prompts[1],
                                     "max_tokens": CKPT_TOKENS})
                finally:
                    server.shutdown()
                server_tokens = answer["choices"][0]["token_ids"]
                server_ok = (_bitwise_equal(torch, server.engine.params,
                                            params)
                             and server_tokens == want_solo)
                del server
    torch.cuda.synchronize()
    launches = _counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_prefill = cfg.n_layers          # every bucket here is 128 or more
    expected = per_prefill * (2 * len(prompts) + 1)
    has_hf = importlib.util.find_spec("transformers") is not None
    print(f"checkpoint llama-400m: {nbytes} bytes of bf16 weights "
          f"({cfg.num_params() / 1e6:.1f} M params; load_s is "
          f"load_llama_params alone, get_tokenizer_s get_tokenizer(<dir>) "
          f"alone, engine_s LLMEngine(<dir>) after both; transformers "
          f"installed {has_hf}), server completion "
          f"equal to the engine's {server_ok}; launches {launches} "
          f"(expected {expected} sm90 forward, nothing else); peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    if not (all(r["bitwise"] and r["tokens_equal"]
                and r["sm90_launches"] == per_prefill * len(prompts)
                for r in per_format.values()) and server_ok):
        raise AssertionError(f"checkpoint phase failed: {per_format}, "
                             f"server ok {server_ok}")
    if launches != {"fwd": expected, "fwd_sm90": expected, "fwd_tf32x3": 0,
                    "fwd_sm90_d256": 0, "dq": 0, "dkv": 0, "sm90": 0,
                    "tf32x3": 0, "sm90_d256": 0}:
        raise AssertionError(f"checkpoint phase launched {launches}")
    return launches


# Server phase: Llama-3-8B behind LLMServer, the reference's defaults.
SERVER_TOKENS = 16


def server_phase(torch, fa, llama):
    """LLMServer("llama3-8b", slots=8, max_seq=4096, kv_offload="local")
    with chunks of 64 (the reference's serving default), random weights
    from seed 0.  Four client threads send four completions of 100-1500
    token ids (one opening a session), two chats, two streams (a
    completion and the first chat), and the session's second turn; then
    end_session, load_signals, a request whose deadline has passed and
    one whose deadline runs out mid-generation.  Gates: every greedy
    answer equals the same request served alone afterwards; each stream
    equals its request's answer; chat usage matches the tokens; the
    expired request touches nothing; no flash launch (chunked prefill and
    decode run no kernel of ours)."""
    from ant_ray_tpu_torch.exceptions import DeadlineExceededError  # noqa: PLC0415
    from ant_ray_tpu_torch.llm import LLMServer  # noqa: PLC0415
    from ant_ray_tpu_torch.llm.chat import render_chat  # noqa: PLC0415
    from ant_ray_tpu_torch.observability import device_memory_stats  # noqa: PLC0415
    from ant_ray_tpu_torch.serve.api import _request_deadline  # noqa: PLC0415

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srv = LLMServer("llama3-8b", slots=8, max_seq=4096, seed=0,
                    kv_offload="local")
    torch.cuda.synchronize()
    print(f"llama3-8b LLMServer up in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg, tok = srv.engine.config, srv.engine.tokenizer
    rng = np.random.default_rng(13)

    def ids(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def completion(n, **extra):
        return {"prompt": ids(n), "max_tokens": SERVER_TOKENS, **extra}

    chat_a = {"messages": [{"role": "system", "content": "You are terse."},
                           {"role": "user", "content": "Name three rivers "
                            "of Europe and their lengths."}],
              "max_tokens": SERVER_TOKENS}
    chat_b = {"messages": [{"role": "user", "content": "Say hello."}],
              "max_tokens": SERVER_TOKENS}
    reqs = {"c100": completion(100), "c500s": completion(500, session_id="s"),
            "c1000": completion(1000), "c1500": completion(1500),
            "chat_a": chat_a, "chat_b": chat_b,
            "stream_c300": completion(300), "stream_chat_a": dict(chat_a),
            "s_turn2": completion(50, session_id="s")}
    plan = [["c100", "c500s", "s_turn2"], ["c1000", "stream_c300"],
            ["chat_a", "chat_b"], ["c1500", "stream_chat_a"]]
    label = threading.local()
    handles: dict = {}
    submit = srv._loop.submit

    def recording_submit(prompt, sampling, session_id=None):
        handle = submit(prompt, sampling, session_id=session_id)
        handles[label.name] = handle
        return handle

    srv._loop.submit = recording_submit
    answers, errors = {}, []

    def serve(name):
        label.name = name
        req = dict(reqs[name])
        if name.startswith("stream"):
            return list(srv.stream(req))
        return srv(req)

    def client(names):
        try:
            for name in names:
                answers[name] = serve(name)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    _reset_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(names,))
                   for names in plan]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SESSION_DEADLINE_S)
        wall_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"server clients failed: {errors}")
        ttft = {name: round(h.ttft_s() * 1e3, 1)
                for name, h in handles.items()}
        ended = srv.end_session("s")
        signals = srv.load_signals()

        # Each request again, alone (the session replayed under another
        # id, its turns in order).
        solo = {}
        for names in plan:
            for name in names:
                req = dict(reqs[name])
                if req.get("session_id"):
                    req["session_id"] = "s-solo"
                label.name = f"solo {name}"
                solo[name] = (list(srv.stream(dict(req)))
                              if name.startswith("stream") else srv(req))
        srv.end_session("s-solo")
        # The streams' requests as completions, for their token ids: the
        # chat one as the token ids its template renders to, which is
        # what the chat path submits.
        whole = {"stream_c300": srv(dict(reqs["stream_c300"])),
                 "stream_chat_a": srv({
                     "prompt": render_chat(tok, chat_a["messages"]),
                     "max_tokens": SERVER_TOKENS})}

        # A request whose deadline has passed: shed, engine untouched.
        stats, counter = dict(srv.engine.stats), repr(srv.engine._req_counter)
        token = _request_deadline.set(time.time() - 1.0)
        shed = False
        try:
            srv(completion(100))
        except DeadlineExceededError:
            shed = (srv.engine.stats == stats
                    and repr(srv.engine._req_counter) == counter)
        finally:
            _request_deadline.reset(token)

        # A deadline that runs out mid-generation: 0.5 s for 64 tokens.
        label.name = "deadline"
        token = _request_deadline.set(time.time() + 0.5)
        t0 = time.perf_counter()
        expired_s = None
        try:
            srv({"prompt": ids(100), "max_tokens": 64})
        except DeadlineExceededError:
            expired_s = time.perf_counter() - t0
        finally:
            _request_deadline.reset(token)
        late = handles["deadline"]
        late_out = late.wait(SESSION_DEADLINE_S)      # it runs to its end
        mid_generation = (expired_s is not None and late.ttft_s() is not None
                          and late.ttft_s() < expired_s
                          and len(late_out.token_ids) > 1)
    finally:
        srv.shutdown()
        del srv._loop.submit   # the wrapper holds the loop: free the 8B now
    launches = _counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def streamed(name):
        """The texts and token ids of a stream's token chunks."""
        body = [c["choices"][0] for c in answers[name][:-1]]
        return ([b.get("text", b.get("delta", {}).get("content"))
                 for b in body], [b.get("token_id") for b in body])

    def per_token(ids):
        return [tok.decode([t]) for t in ids]

    equal = {name: answers[name] == solo[name] for name in answers}
    c300 = whole["stream_c300"]["choices"][0]
    chat_ids = whole["stream_chat_a"]["choices"][0]["token_ids"]
    chat = answers["chat_a"]
    # A stream carries each token's own text; joined, it equals the
    # answer's text unless a multi-byte character spans two tokens.
    streams_ok = (
        all(answers[n][-1]["done"] for n in ("stream_c300", "stream_chat_a"))
        and streamed("stream_c300") == (per_token(c300["token_ids"]),
                                        c300["token_ids"])
        and streamed("stream_chat_a")[0] == per_token(chat_ids)
        and chat["choices"][0]["message"]["content"] == tok.decode(chat_ids))
    joined_equal = {
        "stream_c300": "".join(streamed("stream_c300")[0]) == c300["text"],
        "stream_chat_a": "".join(streamed("stream_chat_a")[0])
        == chat["choices"][0]["message"]["content"]}
    usage_ok = all(
        answers[n]["usage"]["prompt_tokens"] == len(render_chat(
            tok, reqs[n]["messages"]))
        and answers[n]["usage"]["total_tokens"]
        == answers[n]["usage"]["prompt_tokens"]
        + answers[n]["usage"]["completion_tokens"]
        for n in ("chat_a", "chat_b")) and (
        chat["usage"]["completion_tokens"] == len(chat_ids))
    usage = {n: answers[n]["usage"] for n in ("chat_a", "chat_b")}
    print(f"server llama3-8b slots 8 chunks 64: {len(answers)} requests from "
          f"{len(plan)} threads in {wall_s:.2f} s; TTFT ms by request "
          f"{json.dumps(ttft)}; equal to alone {json.dumps(equal)}; streams "
          f"carry their answers' tokens {streams_ok}, joined text equal to "
          f"the answer's {json.dumps(joined_equal)}; chat usage "
          f"{json.dumps(usage)} ok {usage_ok}; end_session {ended}; load_signals "
          f"{json.dumps(signals)}; expired deadline shed with the engine "
          f"untouched {shed}; deadline of 0.5 s raised after "
          f"{expired_s if expired_s is None else round(expired_s, 3)} s, "
          f"first token at {late.ttft_s()} s, request ran on to "
          f"{len(late_out.token_ids)} tokens; engine stats "
          f"{json.dumps(srv.engine.stats)}; launches {launches}; peak memory "
          f"{peak_gb:.2f} GB; device_memory_stats "
          f"{json.dumps(device_memory_stats())}", flush=True)
    if not (all(equal.values()) and streams_ok and usage_ok and ended
            and set(signals) == set(srv._loop.METRIC_NAMES) and shed
            and mid_generation):
        raise AssertionError("server phase gates failed")
    if any(launches.values()):
        raise AssertionError(f"the server path launched {launches}, "
                             "expected no flash kernel")
    return launches


def _profile(torch, label, fn, top=6):
    """Where one call's time goes, from a torch.profiler trace: the
    device's busy share of the host wall time, and the ``top`` kernels
    that take most of it.  A trace without device events reports 'not
    measured' and returns None; else returns the kernel time (us) by
    name."""
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
    # Kernel time summed by the first 60 characters of the name (one
    # family of templated kernels).  User annotations that the trace
    # draws on the device timeline (the optimizer step's range) are not
    # kernels and would count their time twice.
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            key = e.name[:60]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device time "
              "not measured (no device events in the trace)", flush=True)
        return None
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}); top kernels "
          + json.dumps({name: round(us / 1e3, 3) for name, us in heaviest}),
          flush=True)
    return by_name


def _print_ptxas(build, lib):
    """Registers and spills of each kernel of ``csrc/<lib>.cu``, from the
    build's -Xptxas=-v log."""
    log = build._library_path(lib).with_suffix(".log")
    if not log.exists():
        print(f"ptxas {lib}: no build log (library built elsewhere)",
              flush=True)
        return
    kernel = None
    for line in log.read_text().splitlines():
        found = re.search(r"Compiling entry function .*?"
                          r"(flash_(?:fwd|bwd)_\w+?_kernel)(?:ILi(\d+)E)?",
                          line)
        if found:
            kernel = found.group(1) + (f"<{found.group(2)}>"
                                       if found.group(2) else "")
        elif kernel and ("spill" in line or "registers" in line):
            print(f"ptxas {kernel}: {line.strip()}", flush=True)
            if "registers" in line:
                kernel = None


def kernels_line(rows, bwd_rows, paths):
    """The {"kernels": [...]} record of the twelve kernels from the kernel
    phases' rows and the launches of every path; raises if a kernel that
    a main path should run was not launched on one."""
    by_path = {path: _by_kernel(c) for path, c in paths.items()}
    main_paths = [p for p in paths if not p.startswith("grad_check")]

    # Forward: S=4096, the largest prefill of the serving slice, for sm90,
    # where the CUDA-core kernel was also timed; GPT-2's fp32 shape for
    # tf32x3, where it was too; Gemma-7B's attention for sm90_d256, where
    # it was too; SIMT_FWD_ATTN in fp32 for the CUDA-core kernel (its own
    # route, on no main path).  Backward: the training slice's shape (the
    # first backward case) for sm90 and the CUDA-core pair, also timed
    # there; GPT-2's fp32 shape for tf32x3, where the CUDA-core pair was
    # too; Gemma-7B's attention for sm90_d256, where it was too.  The
    # sm90_d256 kernels also give their times at Gemma-2B's attention and
    # at the d256 path's own.
    main_row = next(r for r in rows if r["shape"].startswith("B=1 Sq=4096 "))
    train_row = next(r for r in rows if r["shape"].startswith("B=8 Sq=2048 "))
    simt_row = next(r for r in rows if r["shape"] == _shape(
        *SIMT_FWD_ATTN, "float32", True))
    bwd_row = bwd_rows[0]
    gemma = {name: _shape(*attn, "bfloat16", True) for name, attn in
             (("gemma7b", GEMMA7B_ATTN), ("gemma2b", GEMMA2B_ATTN),
              ("d256_path", _d256_attn()))}
    gemma_rows = {name: next(r for r in rows if r["shape"] == shape)
                  for name, shape in gemma.items()}
    gemma_bwd_rows = {name: next(r for r in bwd_rows if r["shape"] == shape)
                      for name, shape in gemma.items()}
    # GPT-2's shape, the main path of the tf32x3 kernels (fp32) and of
    # the sm90 kernels at head_dim 64 without GQA (bf16).
    gpt2_shape = "B=8 Sq=1024 Skv=1024 H=12 KVH=12 D=64 {} causal"
    gpt2_rows = {dtype: next(r for r in rows
                             if r["shape"] == gpt2_shape.format(dtype))
                 for dtype in ("float32", "bfloat16")}
    gpt2_bwd_rows = {dtype: next(r for r in bwd_rows
                                 if r["shape"] == gpt2_shape.format(dtype))
                     for dtype in ("float32", "bfloat16")}

    def _gpt2_keys(dtype, timed, bound_ms, plain_ms, library_ms):
        return {"gpt2_shape": gpt2_shape.format(dtype),
                "gpt2_shape_ms": timed["ms"],
                "gpt2_shape_share_of_bound": timed["share_of_bound"],
                "gpt2_shape_bound_ms": bound_ms,
                "gpt2_shape_plain_ms": plain_ms,
                "gpt2_shape_library_ms": library_ms}

    def launches(name):
        return {"launches": sum(by_path[p][name] for p in main_paths),
                "launches_by_path": {p: by_path[p][name] for p in by_path}}

    def gemma_keys(other, row, timed, bound_ms):
        return {f"{other}_shape": row["shape"],
                f"{other}_shape_ms": timed["ms"],
                f"{other}_shape_share_of_bound": timed["share_of_bound"],
                f"{other}_shape_bound_ms": bound_ms,
                f"{other}_shape_plain_ms": row["plain_ms"],
                f"{other}_shape_library_ms": row["library_ms"]}

    def fwd_entry(name, route, source):
        g32 = gpt2_rows["float32"]
        extra = {}
        gpt2 = None
        if route == "sm90":
            at = timed = main_row
            err_rows = [r for r in rows if r["route"] == "sm90"]
            b16 = gpt2_rows["bfloat16"]
            gpt2 = ("bfloat16", b16, b16["bound_ms"])
            extra = {"train_shape_ms": train_row["ms"],
                     "train_shape_share_of_bound": train_row["share_of_bound"]}
        elif route == "tf32x3":
            # Its main shape is GPT-2's fp32 one.
            at = timed = g32
            err_rows = [r for r in rows if r["route"] == "tf32x3"]
            gpt2 = ("float32", g32, g32["bound_ms"])
            extra = {"bound_ms_fp32_fma": g32["fp32_fma_bound_ms"],
                     "share_of_fp32_fma_bound": g32["share_of_fp32_fma_bound"],
                     "simt_ms_same_inputs": g32["simt"]["ms"]}
        elif route == "sm90_d256":
            # Its main shape is Gemma-7B's attention; also Gemma-2B's and
            # the d256 path's, each beside the CUDA-core kernel's time on
            # the same inputs.
            at = timed = gemma_rows["gemma7b"]
            err_rows = [r for r in rows if r["route"] == "sm90_d256"]
            extra = {"simt_ms_same_inputs": at["simt"]["ms"]}
            for other in ("gemma2b", "d256_path"):
                row = gemma_rows[other]
                extra.update(gemma_keys(other, row, row, row["bound_ms"]))
                extra[f"{other}_shape_simt_ms_same_inputs"] = \
                    row["simt"]["ms"]
        else:
            # Its main shape is SIMT_FWD_ATTN in fp32, the only inputs
            # routed to it; also its times on the other kernels' inputs,
            # launched directly (bf16 at S=4096, the training shape and
            # the head_dim-256 shapes; GPT-2's fp32 shape).
            at = timed = simt_row
            err_rows = [r["simt"] for r in rows if "simt" in r] + [
                r for r in rows if r["route"] == "simt"]
            gpt2 = ("float32", g32["simt"], g32["fp32_fma_bound_ms"])
            extra = {"s4096_ms": main_row["simt"]["ms"],
                     "train_shape_ms": train_row["simt"]["ms"]}
            for other, row in gemma_rows.items():
                extra[f"{other}_shape"] = row["shape"]
                extra[f"{other}_shape_ms"] = row["simt"]["ms"]
        if gpt2 is not None:
            dtype, gpt2_timed, gpt2_bound_ms = gpt2
            extra.update(_gpt2_keys(dtype, gpt2_timed, gpt2_bound_ms,
                                    gpt2_rows[dtype]["plain_ms"],
                                    gpt2_rows[dtype]["library_ms"]))
        return {
            "name": name,
            "route": "cuda",
            "fwd_route": route,
            "source": f"ant_ray_tpu_torch/ops/csrc/{source}",
            "replaces": "ant_ray_tpu/ops/pallas/flash_attention.py:56",
            **launches(name),
            "max_abs_err": max(r["max_abs_err"] for r in err_rows),
            "max_lse_err": max(r["lse_err"] for r in err_rows),
            "ms": timed["ms"],
            "tflops": timed["tflops"],
            "share_of_bound": timed["share_of_bound"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            **extra,
            "library_ms": at["library_ms"],
            "shape": at["shape"],
        }

    def bwd_entry(name, key, grads, route, source, line):
        g32 = gpt2_bwd_rows["float32"]
        g7 = gemma_bwd_rows["gemma7b"]
        extra = {}
        if route == "sm90_d256":
            # Its main shape is Gemma-7B's attention; also Gemma-2B's and
            # the d256 path's.
            at, timed = g7, g7["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "sm90_d256"]
            gpt2 = None
            extra = {"simt_pair_ms_same_inputs": g7["simt"]["dq"]["ms"]
                     + g7["simt"]["dkv"]["ms"]}
            for other in ("gemma2b", "d256_path"):
                row = gemma_bwd_rows[other]
                extra.update(gemma_keys(other, row, row["kernels"][key],
                                        row["bounds"][key][0]))
        elif route == "sm90":
            at, timed = bwd_row, bwd_row["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "sm90"]
            gpt2 = ("bfloat16", gpt2_bwd_rows["bfloat16"]["kernels"][key],
                    gpt2_bwd_rows["bfloat16"])
        elif route == "tf32x3":
            # Its main shape is GPT-2's fp32 one.
            at, timed = g32, g32["kernels"][key]
            err_rows = [r for r in bwd_rows if r["route"] == "tf32x3"]
            gpt2 = ("float32", timed, g32)
            extra = {"bound_ms_fp32_fma": timed["fp32_fma_bound_ms"],
                     "share_of_fp32_fma_bound":
                         timed["share_of_fp32_fma_bound"],
                     "simt_pair_ms_same_inputs": g32["simt"]["dq"]["ms"]
                     + g32["simt"]["dkv"]["ms"]}
        else:
            at, timed = bwd_row, bwd_row["simt"][key]
            err_rows = [bwd_row["simt"], g32["simt"], g7["simt"]] + [
                r for r in bwd_rows if r["route"] == "simt"]
            gpt2 = ("float32", g32["simt"][key], g32)
            extra = {"gemma7b_shape": g7["shape"],
                     "gemma7b_shape_ms": g7["simt"][key]["ms"]}
        bounds_key = "fma_bounds" if route == "simt" else "bounds"
        bound_ms, bound_by, _flops = at[bounds_key][key]
        if gpt2 is not None:
            dtype, gpt2_timed, gpt2_row = gpt2
            extra.update(_gpt2_keys(dtype, gpt2_timed,
                                    gpt2_row[bounds_key][key][0],
                                    gpt2_row["plain_ms"],
                                    gpt2_row["library_ms"]))
        return {
            "name": name,
            "route": "cuda",
            "bwd_route": route,
            "source": f"ant_ray_tpu_torch/ops/csrc/{source}",
            "replaces": f"ant_ray_tpu/ops/pallas/flash_attention.py:{line}",
            **launches(name),
            "max_abs_err": max(r["abs_err"][g] for r in err_rows
                               for g in grads),
            "max_rel_err": max(r["rel_err"][g] for r in err_rows
                               for g in grads),
            "ms": timed["ms"],
            "tflops": timed["tflops"],
            "share_of_bound": timed["share_of_bound"],
            "plain_ms": at["plain_ms"],
            "plain": "flash_attention_backward_ref: dq, dk and dv in one call",
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **extra,
            "library_ms": at["library_ms"],
            "library": "scaled_dot_product_attention backward (fwd+bwd "
                       "minus fwd): dq, dk and dv",
            "shape": at["shape"],
        }

    # The CUDA-core kernels take only fp32 at head_dim 256 now, which no
    # main path uses; every other kernel must run on one.
    off_main_paths = {"flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"}
    for name in next(iter(by_path.values())):
        if name not in off_main_paths and not launches(name)["launches"]:
            raise AssertionError(f"{name} was not launched on the main path")
    return {"kernels": [
        fwd_entry("flash_attention_fwd_sm90", "sm90",
                  "flash_attention_fwd_sm90.cu"),
        fwd_entry("flash_attention_fwd_tf32x3", "tf32x3",
                  "flash_attention_fwd_tf32x3.cu"),
        fwd_entry("flash_attention_fwd_sm90_d256", "sm90_d256",
                  "flash_attention_fwd_sm90_d256.cu"),
        fwd_entry("flash_attention_fwd", "simt", "flash_attention_fwd.cu"),
        bwd_entry("flash_attention_bwd_dq_sm90", "dq", ("dq",), "sm90",
                  "flash_attention_bwd_sm90.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_sm90", "dkv", ("dk", "dv"),
                  "sm90", "flash_attention_bwd_sm90.cu", 301),
        bwd_entry("flash_attention_bwd_dq_tf32x3", "dq", ("dq",), "tf32x3",
                  "flash_attention_bwd_tf32x3.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_tf32x3", "dkv", ("dk", "dv"),
                  "tf32x3", "flash_attention_bwd_tf32x3.cu", 301),
        bwd_entry("flash_attention_bwd_dq_sm90_d256", "dq", ("dq",),
                  "sm90_d256", "flash_attention_bwd_sm90_d256.cu", 196),
        bwd_entry("flash_attention_bwd_dkv_sm90_d256", "dkv", ("dk", "dv"),
                  "sm90_d256", "flash_attention_bwd_sm90_d256.cu", 301),
        bwd_entry("flash_attention_bwd_dq", "dq", ("dq",), "simt",
                  "flash_attention_bwd.cu", 196),
        bwd_entry("flash_attention_bwd_dkv", "dkv", ("dk", "dv"), "simt",
                  "flash_attention_bwd.cu", 301)]}


# Faults that --plant-d256-fault writes into a copy of
# ops/csrc/flash_attention_bwd_sm90_d256.cu, as (this text, that text):
# block 0 of a dK/dV cluster skips rank 1's partial (at one KV head, a
# quarter of the query heads go missing from dK and dV); each dK/dV
# warpgroup takes its own P^T / dS^T fragments for the other's q columns;
# dK/dV's or dQ's causal mask also drops the diagonal.
D256_FAULTS = {
    "dkv_rank_dropped": ("for (int r = 1; r < splits; ++r) {",
                         "for (int r = 2; r < splits; ++r) {"),
    "dkv_no_trade": ("const uint4* from = w == wg ? mine : theirs;",
                     "const uint4* from = mine;"),
    "dkv_diagonal_masked": (
        "if (causal && row0 + 8 * (e >> 1) > q0 + 32 * wg + col + (e & 1))",
        "if (causal && row0 + 8 * (e >> 1) >= q0 + 32 * wg + col + (e & 1))"),
    "dq_diagonal_masked": (
        "if (causal && col + (e & 1) > row0 + 8 * (e >> 1)) p = 0.f;",
        "if (causal && col + (e & 1) >= row0 + 8 * (e >> 1)) p = 0.f;"),
}


def plant_d256_fault(fault, target):
    """A copy of this script and the package in ``target`` (new), without
    built libraries, with ``D256_FAULTS[fault]`` planted."""
    import shutil  # noqa: PLC0415

    old, new = D256_FAULTS[fault]
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(target)
    shutil.copy2(os.path.join(here, "chip_smoke.py"), target)
    shutil.copytree(os.path.join(here, "ant_ray_tpu_torch"),
                    os.path.join(target, "ant_ray_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(target, "ant_ray_tpu_torch", "ops", "csrc",
                        "flash_attention_bwd_sm90_d256.cu")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{fault}: {old!r} is not in {path} once")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text.replace(old, new))


def d256_gate_readings(checkout):
    """What CHECKOUT's bf16 head_dim-256 gates read, ungated (the
    module docstring's --d256-gate-readings)."""
    import math  # noqa: PLC0415

    sys.path.insert(0, os.path.abspath(checkout))
    import torch  # noqa: PLC0415

    import chip_smoke as cs  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import _build  # noqa: PLC0415
    from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    cs.BWD_TOL["bfloat16"] = dict.fromkeys(cs.BWD_TOL["bfloat16"], math.inf)
    cs.D256_GRAD_TOL = cs.BF16_LOSS_TOL = math.inf
    rows = cs.bwd_kernel_phase(torch, fa)
    torch.cuda.empty_cache()
    cfg, params, tokens = cs._llama_d256(torch, llama)

    def grad_check():
        loss, ref_loss, err, launches = cs._d256_grad_check(
            torch, fa, llama, cfg, params, tokens)
        return {"loss_err": abs(loss - ref_loss),
                "max_grad_err": max(err.values()), "grad_err": err,
                "launches": launches}

    out = {"checkout": os.path.abspath(checkout),
           "backward": {r["shape"]: r["rel_err"] for r in rows
                        if r["route"] == "sm90_d256"},
           "grad_check": grad_check()}
    # The custom ops look the wrappers up at call time.
    kernels = fa.flash_attention_fwd_lse, fa.flash_attention_backward
    try:
        fa.flash_attention_backward = fa.flash_attention_backward_ref
        out["plain_backward"] = grad_check()
        fa.flash_attention_fwd_lse = fa.flash_attention_fwd_lse_ref
        out["plain"] = grad_check()
    finally:
        fa.flash_attention_fwd_lse, fa.flash_attention_backward = kernels
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # LLMEngine(<dir>) asks transformers, where it is installed, for the
    # directory's tokenizer: from local files only.
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"
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

    for lib in ("flash_attention_fwd_sm90", "flash_attention_bwd_sm90",
                "flash_attention_fwd_tf32x3", "flash_attention_bwd_tf32x3",
                "flash_attention_fwd_sm90_d256",
                "flash_attention_bwd_sm90_d256"):
        _print_ptxas(_build, lib)

    rows = kernel_phase(torch, fa)
    bwd_rows = bwd_kernel_phase(torch, fa)
    model_check_phase(torch, llama)
    paths = {"grad_check_fp32": grad_check_phase(torch, fa, llama)[0],
             "grad_check_bf16": bf16_grad_check_phase(torch, fa, llama)}
    paths["serve"], params = slice_phase(torch, fa, llama)
    paths["sessions"] = sessions_phase(torch, fa, llama, params)
    paths["loop"] = loop_phase(torch, fa, llama, params)
    del params
    paths["checkpoint"] = checkpoint_phase(torch, fa, llama)
    paths["server"] = server_phase(torch, fa, llama)
    paths["train"] = train_phase(torch, fa, llama)
    paths.update(remat_phase(torch, fa, llama))
    paths["gpt2_fp32"] = gpt2_phase(torch, fa, "float32")[0]
    paths["gpt2_bf16"] = gpt2_phase(torch, fa, "bfloat16")[0]
    paths["d256"] = d256_phase(torch, fa, llama)
    print(json.dumps(kernels_line(rows, bwd_rows, paths)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plant-d256-fault"]:
        plant_d256_fault(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--d256-gate-readings"]:
        print(json.dumps(d256_gate_readings(
            sys.argv[2] if len(sys.argv) > 2 else
            os.path.dirname(os.path.abspath(__file__)))), flush=True)
        sys.exit(0)
    sys.exit(main())
