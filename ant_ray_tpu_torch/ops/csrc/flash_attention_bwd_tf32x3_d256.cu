// Flash-attention backward in fp32 on Hopper's tensor cores (sm_90a), at
// head_dim 256, bound to PyTorch through plain C entry points (ctypes).
// Two kernels, launched one after the other by `flash_attention_backward`
// in ant_ray_tpu_torch/ops/flash_attention.py for the inputs that `_route`
// sends to its "tf32x3_d256" route (the 3xTF32 product, cp.async and the
// fragment loads are in flash_attention_tf32x3.cuh):
//
//   flash_attention_bwd_dq_tf32x3_d256   replaces `_dq_kernel` of
//       ant_ray_tpu/ops/pallas/flash_attention.py (lines 196-236);
//   flash_attention_bwd_dkv_tf32x3_d256  replaces `_dkv` of the same file
//       (lines 301-348).
//
// They compute what flash_attention_bwd_tf32x3.cu computes at head_dim 64
// and 128, with the same rounding points:
//   s  = q.k^T * scale,  p = exp(s - lse), 0 where k_pos > q_pos
//        (top-left causal alignment, as the forward),
//   dp = dO.v^T,  ds = p * (dp - delta) * scale,
//   dq = sum_k round(ds) . k,
//   dv = sum_{heads of the group, q} round(p)^T . dO,
//   dk = sum_{heads of the group, q} round(ds)^T . q,
// round() being the cast to the input type, a no-op in fp32 kept for the
// reader.  delta = rowsum(dO * O) and lse (B, H, Sq) are fp32 from the
// wrapper.  Layouts: q, dO (B, Sq, H, D); k, v (B, Skv, KVH, D); every
// tensor fp32 and 16-byte aligned (the wrapper checks).
//
// What bounds them.  At the fp32 head_dim-256 Llama's attention (B=2,
// S=2048, H=8, KVH=1, causal) dQ does 6*D FLOPs per (q, k) pair, 51.6
// GFLOP, and dK/dV 8*D, 68.8 GFLOP, against ~0.1 GB of traffic each:
// bound by operations, 0.31 and 0.42 ms at 3xTF32's 165 TFLOP/s (the
// CUDA-core pair of flash_attention_bwd.cu peaks at fp32 FMAs' 67).
//
// Why the head_dim 64/128 design does not simply take D = 256.  There a
// warp owns 16 rows of the block's output at every column: at D = 256
// that is a 16 x 256 fp32 accumulator, 128 registers a thread, and
// dK/dV holds two (256).  And a padded fp32 row is 1040 bytes, so a
// 64-row tile takes 66.5 KB: 64-row resident tiles (two of them) and two
// stages of a streamed pair of 32 rows need 266 KB, over the 227 KB
// (232,448 bytes) a block may use.
//
// The choice: 32-row resident tiles and two 32-row stages.  Each kernel
// keeps two 32-row tiles (66,560 bytes) and streams two stages of a
// 32-row pair (133,120 bytes), with each warp's partial scores beside
// them (32,768): 232,448 bytes, all a block may use, one block an SM.
// (One stage of a pair beside 64-row resident tiles would fit too, but
// then no copy overlaps the products.)  dK/dV reads lse and delta from
// device memory, ahead of each stage's products.
//
// The design, the same in both kernels:
//   * 8 warps.  Warp w owns row slice r = w % 2 (16 rows of the resident
//     tile) and column quarter c = w / 2: columns [64c, 64c + 64) of the
//     block's output, 32 accumulator registers a thread (dK/dV: 64).
//   * Per stage, warp (r, c) computes the score block S (dQ: Q.K^T) or
//     S^T (dK/dV: K.Q^T), and dP or dP^T, for its 16 rows and all 32 of
//     the stage's columns, but over the inputs' columns of its quarter
//     only: partial sums, eight independent mma chains, each A fragment
//     split once for four products.  The four warps of a row slice add
//     their partials through shared memory, in quarter order, so all
//     four hold the same sums.  (Warps that each summed all 256 columns
//     for 8 of the 32 score columns, and traded P and dS instead, split
//     every A fragment four times over and took 1.03-1.10x as long on an
//     H100 80GB HBM3 at 700 W.)
//   * Each turns them into dS (dQ) or P^T and dS^T (dK/dV) in the
//     accumulator layout: the A operand, in the permuted k order of
//     a_from_acc, of dQ += dS.K, or of dV += P^T.dO and dK += dS^T.Q,
//     whose B operand (K, dO, Q) is read MN-major at the warp's 64
//     columns.
//   * Every product is mma.sync.m16n8k8 issued three times (mma_3xtf32):
//     wgmma's tf32 form takes only K-major operands from shared memory,
//     and three of the five products read B MN-major.  A single TF32
//     product is never used.
//   * Operands split into TF32 hi and lo on the integer pipe (the
//     header's split: the same products as cvt.rna's, a NaN kept).  A
//     warp here splits about one fp32 value per mma, and with cvt, whose
//     unit gives 16 results a clock an SM, the pair took 1.2x as long at
//     the fp32 path's attention (same card).
//   * dQ: one block per (32-row q tile, head, batch), heaviest first (the
//     last q tiles under a causal mask); Q and dO stay, K and V stream
//     up to the causal diagonal.
//   * dK/dV: one block per (32-row KV tile, KV head, batch), heaviest
//     (the first) first; K and V stay, and Q and dO of every query head
//     of the group stream from the causal diagonal on (the TPU kernel's
//     GQA design: no head repeat, no atomics).
//   * Few KV heads.  At one KV head (Gemma-2B's layout, B=2, S=2048)
//     there are 128 KV tiles for 132 SMs, and under a causal mask tile 0
//     walks 64 q tiles a head where the last walks one.  So when the grid
//     would fill fewer than two waves, `splits` blocks of a thread block
//     cluster (2 or 4, dividing the group) share a KV tile, each walking
//     its share of the group's query heads; at the end each leaves its
//     fp32 dK and dV in its own shared memory and block 0 adds them
//     through distributed shared memory, rank by rank: a fixed order, so
//     results stay deterministic (as flash_attention_bwd_sm90_d256.cu
//     does in bf16).
//   * Shared-memory rows are padded to 260 floats: fragment loads in
//     either orientation hit 32 distinct banks (see the header).
// Lengths must be multiples of 64 (so of the 32-row tiles); the wrapper
// rejects anything else and the entry points return
// cudaErrorInvalidValue for it.

#include <cstddef>
#include <cstdint>

#include "flash_attention_common.cuh"
#include "flash_attention_tf32x3.cuh"

namespace {

using flash::round_to;
using namespace tf32x3;  // NOLINT(build/namespaces)

constexpr int kD = 256;
constexpr int kP = kD + kPad;        // floats a padded shared-memory row
constexpr int kBlock = 256;          // threads: 8 warps
constexpr int kRows = 32;            // resident tiles and streamed stages
constexpr int kTile = kRows * kP;    // floats of one 32-row tile
constexpr int kLengthMultiple = 64;
constexpr int kMaxSplits = 4;        // blocks a cluster may share a KV tile
constexpr size_t kMaxSmem = 232448;  // what a block may use on sm_90

// Both kernels: two resident tiles, two stages of a streamed pair of
// tiles, and each warp's partial scores (two 16 x 32 blocks, eight
// float4 a thread).
constexpr int kStage = 2 * kTile;  // floats
constexpr size_t kSmem =
    sizeof(float) * (2 * kTile + 2 * kStage + 32 * kBlock);
static_assert(kSmem <= kMaxSmem,
              "layout over the shared memory a block may use");
// dK/dV's partials (16 float4 a thread) reuse K and V after the loop.
static_assert(16 * 4 * kBlock <= 2 * kTile, "partials overrun K and V");

// Thread block clusters: this block's rank, a barrier of the whole
// cluster (release / acquire), and a float4 of another block's shared
// memory (at this block's shared address `addr`, in block `rank`).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// This warp's quarter of two score blocks: s = A.B^T and dp = A2.B2^T
// for 16 rows m0.. of A and A2 and the stage's 32 rows of B and B2, over
// the inputs' columns [d0, d0 + 64) only: partial sums, eight
// independent mma chains.
__device__ __forceinline__ void score_quarter(float (&s)[4][4],
                                              float (&dp)[4][4],
                                              const float* sA,
                                              const float* sA2, int m0,
                                              const float* sB,
                                              const float* sB2, int d0,
                                              int g, int t) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < 8; ++kk) {
    const int k0 = d0 + 8 * kk;
    const Split<4> a = load_a<kP>(sA, m0, k0, g, t);
    const Split<4> a2 = load_a<kP>(sA2, m0, k0, g, t);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      mma_3xtf32(s[n], a, load_b_kmajor<kP>(sB, 8 * n, k0, g, t));
      mma_3xtf32(dp[n], a2, load_b_kmajor<kP>(sB2, 8 * n, k0, g, t));
    }
  }
}

// The whole score blocks of this warp's row slice r: its partials go to
// shared memory, and every warp of the slice adds the slice's four
// quarters, in quarter order, so each gets the same sums.  The caller's
// next barrier must pass before the partials are written again.
__device__ __forceinline__ void sum_quarters(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             float4* part, int warp, int r,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    part[(8 * warp + n) * 32 + lane] =
        make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    part[(8 * warp + 4 + n) * 32 + lane] =
        make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
  }
  __syncthreads();  // the slice's four quarters are in
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int quarter = 0; quarter < 4; ++quarter) {
    const int from = 8 * ((quarter << 1) | r);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 x = part[(from + n) * 32 + lane];
      const float4 y = part[(from + 4 + n) * 32 + lane];
      s[n][0] += x.x, s[n][1] += x.y, s[n][2] += x.z, s[n][3] += x.w;
      dp[n][0] += y.x, dp[n][1] += y.y, dp[n][2] += y.z, dp[n][3] += y.w;
    }
  }
}

// --------------------------------------------------------------- dQ

__global__ void __launch_bounds__(kBlock, 1)
    flash_bwd_dq_tf32x3_d256_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    float* __restrict__ dq, int q_len,
                                    int kv_len, int heads, int kv_heads,
                                    float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kTile;
  float* sKV = sdO + kTile;  // stage s: K at s * kStage, V after it
  float4* part = reinterpret_cast<float4*>(sKV + 2 * kStage);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp & 1, c = warp >> 1;  // row slice, column quarter
  const int m0 = 16 * r;
  const int h = blockIdx.x, b = blockIdx.y;
  // Heaviest first: under a causal mask the last q tiles see most.
  const int q0 = (q_len / kRows - 1 - static_cast<int>(blockIdx.z)) * kRows;
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * kD;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * kD;
  const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                       static_cast<size_t>(h) * kD;
  const float* kb = k + static_cast<size_t>(b) * kv_len * kv_stride +
                    static_cast<size_t>(kvh) * kD;
  const float* vb = v + static_cast<size_t>(b) * kv_len * kv_stride +
                    static_cast<size_t>(kvh) * kD;
  const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;

  // Causal: K/V stages wholly after the q tile's last row contribute
  // nothing (the first stage always counts: q0 >= 0, kv_len >= 64).
  const int kv_end =
      causal ? (kv_len < q0 + kRows ? kv_len : q0 + kRows) : kv_len;
  const int n_tiles = kv_end / kRows;

  auto load_kv = [&](int tile) {
    float* sK = sKV + (tile & 1) * kStage;
    const size_t off = static_cast<size_t>(tile) * kRows * kv_stride;
    copy_tile<kRows, kD, kBlock>(sK, kb + off, kv_stride);
    copy_tile<kRows, kD, kBlock>(sK + kTile, vb + off, kv_stride);
  };
  copy_tile<kRows, kD, kBlock>(sQ, q + q_off, q_stride);
  copy_tile<kRows, kD, kBlock>(sdO, dout + q_off, q_stride);
  load_kv(0);
  cp_async_commit();

  // This thread's rows of the q tile: m0 + g and m0 + g + 8.
  const float lse_r[2] = {lse[row_off + m0 + g], lse[row_off + m0 + g + 8]};
  const float delta_r[2] = {delta[row_off + m0 + g],
                            delta[row_off + m0 + g + 8]};
  const int q_pos0 = q0 + m0 + g;
  float acc[8][4] = {};  // dq: rows m0.., columns 64c + 8n..

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and Q, dO) landed for every thread
    const float* sK = sKV + (it & 1) * kStage;
    const float* sV = sK + kTile;
    const int k0 = it * kRows;

    // S = Q.K^T and dP = dO.V^T: this warp's 16 q rows and the stage's
    // 32 KV columns.
    float s[4][4], dp[4][4];
    score_quarter(s, dp, sQ, sdO, m0, sK, sV, 64 * c, g, t);
    sum_quarters(s, dp, part, warp, r, lane);

    // dS, rounded to the input type before dS.K as the reference does;
    // it replaces S in place.
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        float p = expf(s[n][e] * scale - lse_r[rr]);
        if (causal && k0 + 8 * n + 2 * t + (e & 1) > q_pos0 + 8 * rr)
          p = 0.f;
        s[n][e] = round_to<float>(p * (dp[n][e] - delta_r[rr]) * scale);
      }

    // dq += dS.K: k runs over the stage's 32 KV rows, permuted; n over
    // this warp's 64 columns.
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      const Split<4> da = a_from_acc(s[kk]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mma_3xtf32(acc[n], da,
                   load_b_mnmajor_permuted<kP>(sK, 8 * kk,
                                                     64 * c + 8 * n, g, t));
    }
    __syncthreads();  // every warp is done with this stage and the partials
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* row = dq + q_off + (m0 + g + 8 * rr) * q_stride + 64 * c + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * rr], acc[n][2 * rr + 1]);
  }
}

// ------------------------------------------------------------- dK/dV

__global__ void __launch_bounds__(kBlock, 1)
    flash_bwd_dkv_tf32x3_d256_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dk,
                                     float* __restrict__ dv, int q_len,
                                     int kv_len, int heads, int kv_heads,
                                     float scale, int causal, int splits) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile;
  float* sStages = sV + kTile;  // stage s: Q, then dO
  float4* part = reinterpret_cast<float4*>(sStages + 2 * kStage);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp & 1, c = warp >> 1;  // row slice, column quarter
  const int m0 = 16 * r;
  // The `splits` blocks of a cluster share one KV tile, each walking
  // groups / splits of its query heads; block 0 of the cluster sums them.
  const int rank = static_cast<int>(cluster_rank());
  const int kvh = blockIdx.x / splits, b = blockIdx.y;
  const int k0 = blockIdx.z * kRows;  // tile 0, the heaviest, first
  const int groups = heads / kv_heads;
  const int my_heads = groups / splits;
  const int h0 = kvh * groups + rank * my_heads;
  const size_t q_stride = static_cast<size_t>(heads) * kD;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * kD;
  const size_t kv_off = (static_cast<size_t>(b) * kv_len + k0) * kv_stride +
                        static_cast<size_t>(kvh) * kD;

  // Causal: q tiles wholly before row k0 see none of this KV tile, so the
  // walk starts at q = k0 (a KV tile with k0 >= Sq sees no query).
  const int q_begin = causal ? k0 : 0;
  const int n_q = q_begin < q_len ? (q_len - q_begin) / kRows : 0;
  const int n_tiles = my_heads * n_q;  // (head, q tile) pairs

  // lse and delta of a (head, q tile) pair start at row_of(tile).
  auto row_of = [&](int tile) {
    const int h = h0 + tile / n_q;
    const int q0 = q_begin + (tile % n_q) * kRows;
    return (static_cast<size_t>(b) * heads + h) * q_len + q0;
  };
  auto load_q = [&](int tile) {
    float* st = sStages + (tile & 1) * kStage;
    const int h = h0 + tile / n_q;
    const int q0 = q_begin + (tile % n_q) * kRows;
    const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                         static_cast<size_t>(h) * kD;
    copy_tile<kRows, kD, kBlock>(st, q + q_off, q_stride);
    copy_tile<kRows, kD, kBlock>(st + kTile, dout + q_off, q_stride);
  };
  if (n_tiles > 0) {
    copy_tile<kRows, kD, kBlock>(sK, k + kv_off, kv_stride);
    copy_tile<kRows, kD, kBlock>(sV, v + kv_off, kv_stride);
    load_q(0);
    cp_async_commit();
  }

  const int k_pos0 = k0 + m0 + g;  // this thread's KV rows: +0 and +8
  float dk_acc[8][4] = {}, dv_acc[8][4] = {};  // columns 64c + 8n..

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_q(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // This thread's lse and delta: q columns 8n + 2t and 8n + 2t + 1 of
    // the stage (read before the barrier, used after the products).
    float2 lse_c[4], delta_c[4];
    const size_t row_off = row_of(it);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      lse_c[n] = *reinterpret_cast<const float2*>(lse + row_off + 8 * n +
                                                  2 * t);
      delta_c[n] = *reinterpret_cast<const float2*>(delta + row_off +
                                                    8 * n + 2 * t);
    }
    __syncthreads();  // this stage (and K, V) landed for every thread
    const float* sQ = sStages + (it & 1) * kStage;
    const float* sdO = sQ + kTile;
    const int q0 = q_begin + (it % n_q) * kRows;

    // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 KV rows and the
    // stage's 32 q columns.
    float st[4][4], dpt[4][4];
    score_quarter(st, dpt, sK, sV, m0, sQ, sdO, 64 * c, g, t);
    sum_quarters(st, dpt, part, warp, r, lane);

    // P^T and dS^T, rounded to the input type before the products as the
    // reference does; they replace S^T and dP^T in place.
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        const float l = (e & 1) ? lse_c[n].y : lse_c[n].x;
        const float dl = (e & 1) ? delta_c[n].y : delta_c[n].x;
        float p = expf(st[n][e] * scale - l);
        if (causal && k_pos0 + 8 * (e >> 1) > q0 + qc) p = 0.f;
        st[n][e] = round_to<float>(p);
        dpt[n][e] = round_to<float>(p * (dpt[n][e] - dl) * scale);
      }

    // dv += P^T.dO and dk += dS^T.Q: k runs over the stage's 32 q rows,
    // permuted; n over this warp's 64 columns.
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      const Split<4> pa = a_from_acc(st[kk]);
      const Split<4> dsa = a_from_acc(dpt[kk]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma_3xtf32(dv_acc[n], pa,
                   load_b_mnmajor_permuted<kP>(sdO, 8 * kk,
                                                     64 * c + 8 * n, g, t));
        mma_3xtf32(dk_acc[n], dsa,
                   load_b_mnmajor_permuted<kP>(sQ, 8 * kk,
                                                     64 * c + 8 * n, g, t));
      }
    }
    __syncthreads();  // every warp is done with this stage and the partials
  }

  if (splits > 1) {
    // Every block but 0 leaves its accumulators in its own shared memory
    // (over K and V, done with); block 0 adds the others', rank by rank,
    // so the sum's order is fixed; the second barrier keeps them alive
    // until it has read them.
    if (rank != 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        smem4[n * kBlock + threadIdx.x] = make_float4(
            dk_acc[n][0], dk_acc[n][1], dk_acc[n][2], dk_acc[n][3]);
        smem4[(8 + n) * kBlock + threadIdx.x] = make_float4(
            dv_acc[n][0], dv_acc[n][1], dv_acc[n][2], dv_acc[n][3]);
      }
    }
    cluster_sync();
    if (rank == 0) {
      const uint32_t part = smem_addr(smem4) + 16 * threadIdx.x;
      for (int from = 1; from < splits; ++from) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 k4 = ld_cluster(part + 16 * n * kBlock, from);
          const float4 v4 = ld_cluster(part + 16 * (8 + n) * kBlock, from);
          dk_acc[n][0] += k4.x;
          dk_acc[n][1] += k4.y;
          dk_acc[n][2] += k4.z;
          dk_acc[n][3] += k4.w;
          dv_acc[n][0] += v4.x;
          dv_acc[n][1] += v4.y;
          dv_acc[n][2] += v4.z;
          dv_acc[n][3] += v4.w;
        }
      }
    }
    cluster_sync();
    if (rank != 0) return;
  }

  // A KV tile that no query reaches (causal, k0 >= Sq) writes zeros.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const size_t off =
        kv_off + (m0 + g + 8 * rr) * kv_stride + 64 * c + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_acc[n][2 * rr], dk_acc[n][2 * rr + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dv_acc[n][2 * rr], dv_acc[n][2 * rr + 1]);
    }
  }
}

// ------------------------------------------------------------- launch

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *out0, *out1;  // dq; or dk and dv
  int batch, q_len, kv_len, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

cudaError_t launch_dq(const Args& a) {
  // Above 48 KB, dynamic shared memory has to be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, a.batch, a.q_len / kRows);
  flash_bwd_dq_tf32x3_d256_kernel<<<grid, kBlock, kSmem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.out0, a.q_len, a.kv_len,
      a.heads, a.kv_heads, a.scale, a.causal);
  return cudaGetLastError();
}

// Blocks of a cluster that share one KV tile: doubled (up to kMaxSplits,
// dividing the group) while the grid would fill fewer than two waves of
// the current device's SMs, as at one KV head.
cudaError_t dkv_splits(const Args& a, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int groups = a.heads / a.kv_heads;
  const long blocks =
      static_cast<long>(a.kv_heads) * a.batch * (a.kv_len / kRows);
  *splits = 1;
  while (2 * *splits <= kMaxSplits && groups % (2 * *splits) == 0 &&
         blocks * *splits < 2L * sms)
    *splits *= 2;
  return cudaSuccess;
}

cudaError_t launch_dkv(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  int splits;
  if ((err = dkv_splits(a, &splits)) != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.kv_heads * splits, a.batch, a.kv_len / kRows);
  config.blockDim = dim3(kBlock);
  config.dynamicSmemBytes = kSmem;
  config.stream = a.stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, flash_bwd_dkv_tf32x3_d256_kernel, a.q,
                           a.k, a.v, a.dout, a.lse, a.delta, a.out0, a.out1,
                           a.q_len, a.kv_len, a.heads, a.kv_heads, a.scale,
                           a.causal, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Runs launch() for what the kernels take (fp32, head_dim 256, lengths
// multiples of 64); anything else is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(const Args& a, int head_dim, int dtype, F&& launch) {
  if (dtype != 0 || head_dim != kD || a.batch <= 0 || a.q_len <= 0 ||
      a.kv_len <= 0 || a.heads <= 0 || a.kv_heads <= 0 ||
      a.heads % a.kv_heads != 0 || a.q_len % kLengthMultiple != 0 ||
      a.kv_len % kLengthMultiple != 0)
    return cudaErrorInvalidValue;
  return launch(a);
}

}  // namespace

// Returns a cudaError_t (0 = success).  dtype must be 0 (float32).
extern "C" int flash_attention_bwd_dq_tf32x3_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int q_len,
    int kv_len, int heads, int kv_heads, int head_dim, int dtype, float scale,
    int causal, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<float*>(dq),
               nullptr, batch, q_len, kv_len, heads, kv_heads, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, launch_dq));
}

extern "C" int flash_attention_bwd_dkv_tf32x3_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int q_len, int kv_len, int heads, int kv_heads, int head_dim, int dtype,
    float scale, int causal, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<float*>(dk),
               static_cast<float*>(dv), batch, q_len, kv_len, heads, kv_heads,
               scale, causal, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, launch_dkv));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
