// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 at
// head_dim 256, bound to PyTorch through plain C entry points (ctypes).
// Two kernels, launched one after the other by `flash_attention_backward`
// in ant_ray_tpu_torch/ops/flash_attention.py for the inputs that `_route`
// sends here (route "sm90_d256"; the PTX, tile and tensor-map helpers are
// in flash_attention_sm90.cuh):
//
//   flash_attention_bwd_dq_sm90_d256   replaces `_dq_kernel` of
//       ant_ray_tpu/ops/pallas/flash_attention.py (lines 196-236);
//   flash_attention_bwd_dkv_sm90_d256  replaces `_dkv` of the same file
//       (lines 301-348).
//
// They compute what flash_attention_bwd_sm90.cu computes at head_dim 64
// and 128, with the same rounding points:
//   s  = q.k^T * scale (fp32),  p = exp(s - lse), 0 where k_pos > q_pos
//        (top-left causal alignment, as the forward),
//   dp = dO.v^T (fp32),  ds = p * (dp - delta) * scale,
//   dq = sum_k bf16(ds) . k,
//   dv = sum_{heads of the group, q} bf16(p)^T . dO,
//   dk = sum_{heads of the group, q} bf16(ds)^T . q,
// every product a bf16 x bf16 wgmma with fp32 sums; dq, dk and dv are
// written in bf16.  delta = rowsum(dO * O) and lse (B, H, Sq) are fp32
// from the wrapper.  Layouts: q, dO (B, Sq, H, D); k, v (B, Skv, KVH, D).
//
// What bounds them.  At Gemma-7B's attention (B=4, S=2048, H=KVH=16,
// D=256, causal) dQ does 6*D FLOPs per (q, k) pair, 206 GFLOP (0.209 ms
// at 989 TFLOP/s), and dK/dV 8*D, 275 GFLOP (0.278 ms), against ~0.3 GB
// of traffic each (~0.09 ms at 3.35 TB/s): bound by operations, which
// only wgmma reaches.
//
// Why the head_dim 64/128 design does not simply take D=256.  A
// warpgroup's 64 x 256 fp32 accumulator is 128 registers a thread: the
// D<=128 dK/dV design keeps dK and dV of its 64 rows in one warpgroup,
// 256 registers before S^T and dP^T, over the limit of 255.  And its
// shared-memory layouts at D=256 need 256 KB a block (128-row K and V
// and two 64-row stages of Q and dO; 128-row Q and dO and two 64-row
// stages of K and V), over the 227 KB (232,448 bytes) a block may use.
//
// The design (every operand in the 128-byte swizzled layout that TMA
// writes and wgmma descriptors read; see the header):
//   * dK/dV: one block of two warpgroups per (64-row KV tile, KV head,
//     batch), heaviest tile first.  Both warpgroups own the same 64 KV
//     rows; warpgroup w owns columns [128w, 128w + 128) of dK and dV, 64
//     + 64 accumulator registers (m64n128k16).  Per 64-row q tile,
//     warpgroup w computes S^T = K.Q^T and dP^T = V.dO^T for q columns
//     [32w, 32w + 32) (m64n32k16, over all 256 columns), so P^T and dS^T
//     come out in the accumulator layout of wgmma's register A operand:
//     its two k-steps of the 64.  It rounds them to bf16, packs them,
//     and trades them for the other warpgroup's two through shared memory
//     (thread t to thread t, 8 KB a warpgroup); then dV += P^T.dO and dK
//     += dS^T.Q read dO and Q MN-major at its 128 columns.  Each P and dS
//     value is computed once, so both halves of dK and dV see the same
//     ones.  (Each warpgroup computing all 64 columns, twice the products
//     and no trade, took 0.82 ms at Gemma-7B's attention on an H100 80GB
//     HBM3, against 0.78.)  The block walks its query heads and every
//     64-row q tile from the causal diagonal on (the TPU kernel's GQA
//     design: no atomics, no head repeat).  Shared memory: K and V, 32
//     KB each, two stages of Q and dO, 32 KB each, their lse and delta
//     rows and the trade: 209 KB, one block per SM.
//   * Few KV heads.  At Gemma-2B's attention (KVH=1, B=4, S=2048) there
//     are 128 KV tiles for 132 SMs, and under a causal mask tile 0 walks
//     32 q tiles a head where the last walks one.  So when the grid would
//     fill fewer than two waves, `splits` blocks of a thread block
//     cluster (2 or 4, dividing the group) share a KV tile, each walking
//     its share of the group's query heads; at the end each leaves its
//     fp32 dK and dV in its own shared memory and block 0 adds them
//     through distributed shared memory, rank by rank: a fixed order, so
//     results stay deterministic.
//   * dQ: one block of two warpgroups per (128-row q tile, head, batch),
//     heaviest first; each warpgroup holds 64 q rows of dQ (128
//     registers, as two m64n128 halves) beside S and dP (16 each).  Q and
//     dO (64 KB each) stay; K and V stream in 32-row stages (16 KB each,
//     two stages: 64 KB), which keeps the block at 192 KB.  S = Q.K^T and
//     dP = dO.V^T are m64n32k16 products over 256 columns; dQ += dS.K
//     takes dS from registers and reads the K stage MN-major, two k16
//     steps per stage.
//   * 256 threads; thread 0 issues every copy between its products, the
//     next stage loading while the tensor cores work on this one.
//   * Ragged lengths.  Lengths are multiples of 64.  A 64-row KV tile is
//     never ragged.  A 128-row q tile that runs past q_len leaves warpgroup
//     1 with rows past the end: TMA fills them with zeros and that
//     warpgroup computes and stores nothing, so no zero row enters a
//     product.  A warpgroup whose q rows all lie before a K stage's first
//     key (causal) skips that stage.  A KV tile that no query reaches
//     (causal, k0 >= Sq) writes zeros.
//
// Takes bf16, D = 256, Sq and Skv multiples of 64, base addresses on
// 16-byte boundaries; the Python wrapper checks all of these and the
// entry points return cudaErrorInvalidValue for anything else.

#include <cstddef>
#include <cstdint>

#include "flash_attention_sm90.cuh"

namespace {

using namespace flash_sm90;  // NOLINT(build/namespaces)

constexpr int kD = 256;
constexpr int kKvTile = 64;    // dK/dV: a block's KV rows (both warpgroups)
constexpr int kKvStage = 32;   // dQ: K and V rows per ring stage
constexpr int kDqStages = 2;
constexpr int kMaxSmem = 232448;  // what a block may use on sm_90

#define ACC16(C)                                                           \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
      C(d[15])

// d (64 x 32) = A (64 x 16) . B (16 x 32), both K-major in shared memory,
// adding to d's contents when `accumulate` (scale-d).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC16("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef ACC16

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

// ------------------------------------------------------------ dK / dV

struct DkvSmem {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + tile_bytes<kD, kKvTile>();
  static constexpr uint32_t kStage = tile_bytes<kD, kRingRows>();
  static constexpr uint32_t kQ = kV + tile_bytes<kD, kKvTile>();
  static constexpr uint32_t kdO = kQ + 2 * kStage;
  static constexpr uint32_t kLse = kdO + 2 * kStage;  // [2][64] fp32
  static constexpr uint32_t kDelta = kLse + 2 * kRingRows * 4;
  // bf16(P^T) and bf16(dS^T) of each warpgroup's 32 q columns, as
  // register A fragments: [warpgroup][P, dS][2 uint4][128 threads].
  static constexpr uint32_t kSwap = kDelta + 2 * kRingRows * 4;
  // Barriers: K/V, then one per stage.
  static constexpr uint32_t kBar = kSwap + 2 * 2 * 2 * 128 * 16;
  static constexpr uint32_t kBytes = kBar + 3 * 8;
  // After the main loop: a block's fp32 dK and dV accumulators, [2][16]
  // [256 threads] float4, over K, V and the Q stages.
  static constexpr uint32_t kPartial = 0;
};
static_assert(DkvSmem::kBytes + kAlignSlack <= kMaxSmem,
              "dK/dV layout over the shared memory a block may use");
static_assert(2 * kKvTile * kD * 4 <= DkvSmem::kLse,
              "dK/dV partials overrun the tiles they reuse");
constexpr int kMaxSplits = 4;  // blocks a cluster may split a KV tile over

__global__ void __launch_bounds__(kThreadsSm90, 1)
    flash_bwd_dkv_sm90_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int q_len,
                                   int kv_len, int heads, int kv_heads,
                                   float scale, int causal, int splits) {
  using L = DkvSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const float* s_lse = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                      L::kLse);
  const float* s_delta = reinterpret_cast<const float*>(
      smem_raw + (base - raw) + L::kDelta);
  uint4* swap = reinterpret_cast<uint4*>(smem_raw + (base - raw) + L::kSwap);
  const uint32_t bar_kv = base + L::kBar;  // then one per ring stage

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // The `splits` blocks of a cluster share one KV tile, each walking
  // groups / splits of its query heads; block 0 of the cluster sums them.
  const int rank = static_cast<int>(cluster_rank());
  const int kvh = blockIdx.x / splits, b = blockIdx.y;
  const int k0 = blockIdx.z * kKvTile;  // tile 0, the heaviest, first
  const int groups = heads / kv_heads;
  const int my_heads = groups / splits;
  const int h0 = kvh * groups + rank * my_heads;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * kD;

  // Causal: q tiles wholly before row k0 see none of this KV tile; the
  // first q tile walked, at row k0, holds the diagonal.
  const int n_qt = q_len / kRingRows;
  const int qt_begin = causal ? min(k0 / kRingRows, n_qt) : 0;
  const int per_head = n_qt - qt_begin;
  const int n_iter = my_heads * per_head;

  // Thread 0 issues every copy: Q, dO, lse and delta of one q tile.
  auto issue_stage = [&](int it, int stage) {
    const int h = h0 + it / per_head;
    const int q0 = (qt_begin + it % per_head) * kRingRows;
    const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;
    const uint32_t bar = bar_kv + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * L::kStage + 2 * kRingRows * 4);
    tma_tile<kD, kRingRows>(base + L::kQ + stage * L::kStage, &tm_q, bar, h,
                            q0, b);
    tma_tile<kD, kRingRows>(base + L::kdO + stage * L::kStage, &tm_do, bar,
                            h, q0, b);
    bulk_load(base + L::kLse + stage * kRingRows * 4, lse + row_off,
              kRingRows * 4, bar);
    bulk_load(base + L::kDelta + stage * kRingRows * 4, delta + row_off,
              kRingRows * 4, bar);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_kv + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_iter > 0) {
    // K and V stay for the block's life.
    mbar_expect_tx(bar_kv, 2 * tile_bytes<kD, kKvTile>());
    tma_tile<kD, kKvTile>(base + L::kK, &tm_k, bar_kv, kvh, k0, b);
    tma_tile<kD, kKvTile>(base + L::kV, &tm_v, bar_kv, kvh, k0, b);
    issue_stage(0, 0);
  }

  float dk_acc[64], dv_acc[64];  // 64 KV rows x this warpgroup's 128 columns
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  // This warpgroup's 128 columns of a 64-row stage: 64-column blocks 2w
  // and 2w + 1.
  const uint32_t cols = wg * 2 * tile_bytes<64, kRingRows>();
  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    // The other stage was freed by the last iteration's closing barrier.
    if (threadIdx.x == 0 && it + 1 < n_iter) issue_stage(it + 1, stage ^ 1);
    if (it == 0) mbar_wait(bar_kv, 0);
    mbar_wait(bar_kv + 8 * (1 + stage), (it >> 1) & 1);

    const int q0 = (qt_begin + it % per_head) * kRingRows;
    const uint32_t sQ = base + L::kQ + stage * L::kStage;
    const uint32_t sdO = base + L::kdO + stage * L::kStage;

    // S^T = K.Q^T and dP^T = V.dO^T for this warpgroup's 32 q columns
    // [32w, 32w + 32) of the tile: 64 KV rows x 32, over all 256 columns.
    float s[16], dp[16];
    const uint32_t q_half = wg * 32 * 128;  // row 32w of each 64-row block
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n32(s, kmajor<kKvTile>(sK, kk),
                   kmajor<kRingRows>(sQ + q_half, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n32(dp, kmajor<kKvTile>(sV, kk),
                   kmajor<kRingRows>(sdO + q_half, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T.  Element 4j + e of a thread: KV row
    // row0 + 8 * (e / 2), q column 32w + 8j + 2 * (lane % 4) + e % 2.
    const int row0 = k0 + 16 * warp + lane / 4;
    const float* lse_t = s_lse + stage * kRingRows + 32 * wg;
    const float* delta_t = s_delta + stage * kRingRows + 32 * wg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = exp2f(s[i] * scale_log2 - l * kLog2e);
        if (causal && row0 + 8 * (e >> 1) > q0 + 32 * wg + col + (e & 1))
          p = 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - dl) * scale;
      }
    }
    // Accumulator layout -> register A operand: k-step kk holds q columns
    // 16kk..16kk+15, i.e. elements 8kk..8kk+7, paired low/high.  This
    // warpgroup's columns are k-steps 2w and 2w + 1 of the 64; it hands
    // them to the other through shared memory (thread t to thread t) and
    // takes the other two.
    uint32_t pa[16], dsa[16];
    uint4* mine = swap + wg * 4 * 128 + threadIdx.x % 128;
    const uint4* theirs = swap + (1 - wg) * 4 * 128 + threadIdx.x % 128;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      mine[v * 128] = make_uint4(pack_bf16(s[8 * v], s[8 * v + 1]),
                                 pack_bf16(s[8 * v + 2], s[8 * v + 3]),
                                 pack_bf16(s[8 * v + 4], s[8 * v + 5]),
                                 pack_bf16(s[8 * v + 6], s[8 * v + 7]));
      mine[(2 + v) * 128] = make_uint4(
          pack_bf16(dp[8 * v], dp[8 * v + 1]),
          pack_bf16(dp[8 * v + 2], dp[8 * v + 3]),
          pack_bf16(dp[8 * v + 4], dp[8 * v + 5]),
          pack_bf16(dp[8 * v + 6], dp[8 * v + 7]));
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const uint4* from = w == wg ? mine : theirs;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint4 p4 = from[v * 128], d4 = from[(2 + v) * 128];
        const int r = 8 * w + 4 * v;
        pa[r] = p4.x, pa[r + 1] = p4.y, pa[r + 2] = p4.z, pa[r + 3] = p4.w;
        dsa[r] = d4.x, dsa[r + 1] = d4.y, dsa[r + 2] = d4.z,
        dsa[r + 3] = d4.w;
      }
    }

    // dV += P^T.dO and dK += dS^T.Q: 64 KV rows x this warpgroup's 128
    // columns, over 64 q.
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRingRows / 16; ++kk)
      wgmma_rs(dv_acc, pa + 4 * kk, mnmajor(sdO + cols, kk));
#pragma unroll
    for (int kk = 0; kk < kRingRows / 16; ++kk)
      wgmma_rs(dk_acc, dsa + 4 * kk, mnmajor(sQ + cols, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(dsa);
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (splits > 1) {
    // Every block leaves its accumulators in its own shared memory (the
    // tiles are done with); block 0 adds the others', rank by rank, so
    // the sum's order is fixed; the second barrier keeps them alive until
    // it has read them.
    float4* part =
        reinterpret_cast<float4*>(smem_raw + (base - raw) + L::kPartial);
    const uint32_t part_addr = base + L::kPartial;
    if (rank != 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        part[j * kThreadsSm90 + threadIdx.x] = make_float4(
            dk_acc[4 * j], dk_acc[4 * j + 1], dk_acc[4 * j + 2],
            dk_acc[4 * j + 3]);
        part[(16 + j) * kThreadsSm90 + threadIdx.x] = make_float4(
            dv_acc[4 * j], dv_acc[4 * j + 1], dv_acc[4 * j + 2],
            dv_acc[4 * j + 3]);
      }
    }
    cluster_sync();
    if (rank == 0) {
      for (int r = 1; r < splits; ++r) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float4 k4 = ld_cluster(
              part_addr + 16 * (j * kThreadsSm90 + threadIdx.x), r);
          const float4 v4 = ld_cluster(
              part_addr + 16 * ((16 + j) * kThreadsSm90 + threadIdx.x), r);
          dk_acc[4 * j] += k4.x;
          dk_acc[4 * j + 1] += k4.y;
          dk_acc[4 * j + 2] += k4.z;
          dk_acc[4 * j + 3] += k4.w;
          dv_acc[4 * j] += v4.x;
          dv_acc[4 * j + 1] += v4.y;
          dv_acc[4 * j + 2] += v4.z;
          dv_acc[4 * j + 3] += v4.w;
        }
      }
    }
    cluster_sync();
    if (rank != 0) return;
  }

  const size_t off = (static_cast<size_t>(b) * kv_len + k0) * kv_stride +
                     static_cast<size_t>(kvh) * kD + 128 * wg;
  store_rows<128>(dk + off, kv_stride, dk_acc);
  store_rows<128>(dv + off, kv_stride, dv_acc);
}

// ------------------------------------------------------------ dQ

struct DqSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kdO = kQ + tile_bytes<kD, kTileRows>();
  static constexpr uint32_t kStage = tile_bytes<kD, kKvStage>();
  static constexpr uint32_t kK = kdO + tile_bytes<kD, kTileRows>();
  static constexpr uint32_t kV = kK + kDqStages * kStage;
  static constexpr uint32_t kBar = kV + kDqStages * kStage;  // Q/dO, stages
  static constexpr uint32_t kBytes = kBar + (1 + kDqStages) * 8;
};
static_assert(DqSmem::kBytes + kAlignSlack <= kMaxSmem,
              "dQ layout over the shared memory a block may use");

__global__ void __launch_bounds__(kThreadsSm90, 1)
    flash_bwd_dq_sm90_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_do,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  bf16* __restrict__ dq, int q_len,
                                  int kv_len, int heads, int kv_heads,
                                  float scale, int causal) {
  using L = DqSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + L::kBar;  // then one per ring stage

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (q_len + kTileRows - 1) / kTileRows;
  // Heaviest first: under a causal mask the last q tiles see most.
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kTileRows;
  const int qw0 = q0 + kWgRows * wg;  // this warpgroup's first q row
  const bool wg_active = qw0 < q_len;
  const int q_rows = min(kTileRows, q_len - q0);
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * kD;

  // Causal: K stages wholly after the q tile's last row contribute nothing.
  const int kv_end = causal ? min(kv_len, q0 + q_rows) : kv_len;
  const int n_kt = kv_end / kKvStage;

  // Thread 0 issues every copy: K and V of one 32-row stage.
  auto issue_stage = [&](int it) {
    const int stage = it % kDqStages;
    const uint32_t bar = bar_q + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * L::kStage);
    tma_tile<kD, kKvStage>(base + L::kK + stage * L::kStage, &tm_k, bar, kvh,
                           it * kKvStage, b);
    tma_tile<kD, kKvStage>(base + L::kV + stage * L::kStage, &tm_v, bar, kvh,
                           it * kKvStage, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kDqStages; ++i) mbar_init(bar_q + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_kt > 0) {
    // Q and dO stay (rows past q_len arrive as zeros; their warpgroup
    // computes nothing).
    mbar_expect_tx(bar_q, 2 * tile_bytes<kD, kTileRows>());
    tma_tile<kD, kTileRows>(base + L::kQ, &tm_q, bar_q, h, q0, b);
    tma_tile<kD, kTileRows>(base + L::kdO, &tm_do, bar_q, h, q0, b);
    for (int it = 0; it < kDqStages - 1 && it < n_kt; ++it) issue_stage(it);
  }

  // This thread's rows: row0 and row0 + 8 of its warpgroup's 64.
  const int row0 = qw0 + 16 * warp + lane / 4;
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if (wg_active) {
    const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_r[r] = lse[row_off + row0 + 8 * r] * kLog2e;
      delta_r[r] = delta[row_off + row0 + 8 * r];
    }
  }

  // dQ's 64 x 256 as two 64 x 128 halves (columns 0-127, 128-255).
  float dq_lo[64], dq_hi[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_lo[i] = dq_hi[i] = 0.f;

  const uint32_t sQ = base + L::kQ + wg * kWgRows * 128;
  const uint32_t sdO = base + L::kdO + wg * kWgRows * 128;
  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_kt; ++it) {
    const int stage = it % kDqStages;
    // The stage of iteration it + kDqStages - 1 was last read in
    // iteration it - 1, freed by its closing barrier.
    if (threadIdx.x == 0 && it + kDqStages - 1 < n_kt)
      issue_stage(it + kDqStages - 1);
    if (it == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_q + 8 * (1 + stage), (it / kDqStages) & 1);

    const int k0 = it * kKvStage;
    if (wg_active && !(causal && k0 > qw0 + kWgRows - 1)) {
      const uint32_t sK = base + L::kK + stage * L::kStage;
      const uint32_t sV = base + L::kV + stage * L::kStage;

      // S = Q.K^T and dP = dO.V^T: 64 q rows x 32 KV columns.
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n32(s, kmajor<kTileRows>(sQ, kk), kmajor<kKvStage>(sK, kk),
                     kk);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n32(dp, kmajor<kTileRows>(sdO, kk),
                     kmajor<kKvStage>(sV, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // dS.  Element 4j + e: q row row0 + 8 * (e / 2), KV column
      // k0 + 8j + 2 * (lane % 4) + e % 2.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = exp2f(s[i] * scale_log2 - lse_r[e >> 1]);
          if (causal && col + (e & 1) > row0 + 8 * (e >> 1)) p = 0.f;
          dp[i] = p * (dp[i] - delta_r[e >> 1]) * scale;
        }
      }
      uint32_t dsa[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

      // dQ += dS.K: 64 q rows x 256, over 32 KV rows (K read MN-major;
      // columns 128-255 start at its third 64-column block).
      fence_regs(dsa);
      fence_regs(dq_lo);
      fence_regs(dq_hi);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvStage / 16; ++kk) {
        wgmma_rs(dq_lo, dsa + 4 * kk, mnmajor<kKvStage>(sK, kk));
        wgmma_rs(dq_hi, dsa + 4 * kk,
                 mnmajor<kKvStage>(sK + 2 * tile_bytes<64, kKvStage>(),
                                        kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_lo);
      fence_regs(dq_hi);
      fence_regs(dsa);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (wg_active) {
    bf16* out = dq + (static_cast<size_t>(b) * q_len + qw0) * q_stride +
                static_cast<size_t>(h) * kD;
    store_rows<128>(out, q_stride, dq_lo);
    store_rows<128>(out + 128, q_stride, dq_hi);
  }
}

// ------------------------------------------------------------ launch

cudaError_t launch_dq(const BwdArgs& a) {
  constexpr int smem = DqSmem::kBytes + kAlignSlack;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps(a, kD, kTileRows, kKvStage, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_d256_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, a.batch, (a.q_len + kTileRows - 1) / kTileRows);
  flash_bwd_dq_sm90_d256_kernel<<<grid, kThreadsSm90, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
      a.q_len, a.kv_len, a.heads, a.kv_heads, a.scale, a.causal);
  return cudaGetLastError();
}

// Blocks of a cluster that share one KV tile: doubled (up to kMaxSplits,
// dividing the group) while the grid would fill fewer than two waves of
// the current device's SMs, as at Gemma-2B's attention (one KV head).
cudaError_t dkv_splits(const BwdArgs& a, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int groups = a.heads / a.kv_heads;
  const long blocks =
      static_cast<long>(a.kv_heads) * a.batch * (a.kv_len / kKvTile);
  *splits = 1;
  while (2 * *splits <= kMaxSplits && groups % (2 * *splits) == 0 &&
         blocks * *splits < 2L * sms)
    *splits *= 2;
  return cudaSuccess;
}

cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr int smem = DkvSmem::kBytes + kAlignSlack;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps(a, kD, kRingRows, kKvTile, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_d256_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int splits;
  if ((err = dkv_splits(a, &splits)) != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.kv_heads * splits, a.batch, a.kv_len / kKvTile);
  config.blockDim = dim3(kThreadsSm90);
  config.dynamicSmemBytes = smem;
  config.stream = a.stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, flash_bwd_dkv_sm90_d256_kernel, maps[0], maps[1], maps[2],
      maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), a.q_len, a.kv_len, a.heads, a.kv_heads,
      a.scale, a.causal, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Runs launch() for what the kernels take (shape_ok, head_dim 256);
// anything else is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(const BwdArgs& a, int head_dim, int dtype, F&& launch) {
  if (head_dim != kD || !bwd_shape_ok(a, dtype))
    return cudaErrorInvalidValue;
  return launch(a);
}

}  // namespace

// Returns a cudaError_t (0 = success).  dtype: 1 = bfloat16 (the only one).
extern "C" int flash_attention_bwd_dq_sm90_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int q_len,
    int kv_len, int heads, int kv_heads, int head_dim, int dtype, float scale,
    int causal, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr,
                  batch, q_len, kv_len, heads, kv_heads, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, launch_dq));
}

extern "C" int flash_attention_bwd_dkv_sm90_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int q_len, int kv_len, int heads, int kv_heads, int head_dim, int dtype,
    float scale, int causal, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, dk, dv,
                  batch, q_len, kv_len, heads, kv_heads, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, launch_dkv));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
