// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 with
// head_dim 64 or 128, bound to PyTorch through plain C entry points
// (ctypes).  Two kernels, launched one after the other by
// `flash_attention_backward` in ant_ray_tpu_torch/ops/flash_attention.py
// for the inputs that `_bwd_route` sends here:
//
//   flash_attention_bwd_dq_sm90   replaces `_dq_kernel` of
//       ant_ray_tpu/ops/pallas/flash_attention.py (lines 196-236);
//   flash_attention_bwd_dkv_sm90  replaces `_dkv` of the same file
//       (lines 301-348).
//
// They compute what the TPU kernels compute, with the same rounding
// points (those of flash_attention_bwd.cu, which keeps fp32 and bf16 at
// head_dim 256):
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
// What bounds them.  At the training slice's shape (Llama-400M: B=8, H=8,
// KVH=4, D=128, S=2048, causal) the backward's five products need 10*D
// FLOPs per (q, k) pair, ~172 GFLOP per layer: 0.174 ms at the H100's 989
// TFLOP/s bf16 tensor-core peak, against ~0.06 ms for its ~0.2 GB of
// traffic.  So they are bound by operations, and only `wgmma` reaches
// that rate.  Two kernels with no atomics (deterministic results) redo
// S and dP in each: 14*D FLOPs per pair against the 10*D of one fused
// pass.  That is the price of the design.
//
// What the design does about the bound:
//   * Every product is a warpgroup MMA (wgmma m64nNk16, bf16 in, fp32
//     accumulators).  Operands in shared memory are in the 128-byte
//     swizzled layout that wgmma descriptors read: a tile of R rows and D
//     columns is stored as D/64 blocks of R rows of 128 bytes, 16-byte
//     chunk c of row r at chunk c ^ (r % 8).  TMA fills them: one thread
//     issues each tile as boxes of R rows x 64 columns of a 4-D tensor map
//     (D, heads, length, batch), which the copy engine swizzles on the way
//     in, and an mbarrier per buffer reports the bytes' arrival.  The
//     streamed tiles go through a two-stage ring, so the next tile loads
//     while the tensor cores work on this one.
//   * dK/dV: one block of two warpgroups per (128-row KV tile, KV head,
//     batch); each warpgroup owns 64 KV rows.  K and V stay in shared
//     memory; the block walks every query head of its group and every
//     64-row q tile from the causal diagonal on (the TPU kernel's GQA
//     design: no atomics, no head repeat).  It computes the transposed
//     products S^T = K.Q^T and dP^T = V.dO^T, so P^T and dS^T come out in
//     the accumulator layout, which after packing to bf16x2 is the layout
//     of wgmma's register A operand: dV += P^T.dO and dK += dS^T.Q take A
//     from registers and B (dO, Q) from shared memory read MN-major (the
//     descriptor's transpose bit).  P and dS never touch shared memory.
//     Tiles run heaviest first (KV tile 0 sees every q tile).
//   * dQ: one block of two warpgroups per (128-row q tile, head, batch);
//     Q and dO stay, a ring of 64-row K and V tiles up to the causal
//     diagonal feeds S = Q.K^T, dP = dO.V^T (both operands from shared
//     memory) and dQ += dS.K (dS from registers, the same K tile read
//     MN-major).  Heaviest q tiles first.
//   * 256 threads and no separate producer warp (thread 0 issues the
//     copies between its products): with two warpgroups a thread may hold
//     255 registers, enough for the dK and dV accumulators (128 fp32 at
//     D=128) beside S^T and dP^T (64), so no setmaxnreg is needed.
//   * Ragged lengths.  Lengths are multiples of 64 and a warpgroup owns
//     64 rows, so a 128-row tile that runs past the end leaves one whole
//     warpgroup with rows past q_len (dQ) or kv_len (dK/dV).  TMA fills
//     those rows with zeros (the map's length dimension ends there), and
//     that warpgroup computes nothing and stores nothing, so no zero row
//     ever enters a product (a zero K row would give p = exp(-lse) != 0).
//     A warpgroup whose rows all lie after a q tile's last row (causal)
//     skips that tile: its p would be 0.  A KV tile that no query reaches
//     (causal, k0 >= Sq) writes zeros.
//
// Takes bf16, D in {64, 128}, Sq and Skv multiples of 64, base addresses
// on 16-byte boundaries; the Python wrapper checks all of these and the
// entry points return cudaErrorInvalidValue for anything else.

#include <cuda.h>  // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLengthMultiple = 64;
constexpr int kThreadsSm90 = 256;  // two warpgroups
constexpr int kWgRows = 64;        // rows a warpgroup owns (wgmma's M)
constexpr int kTileRows = 128;     // the block's own tile: two warpgroups
constexpr int kRingRows = 64;      // the tiles that stream through the ring
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of this phase, and the bytes the copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory
// at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Bulk copy of `bytes` contiguous bytes (a multiple of 16, 16-byte
// aligned at both ends), completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading or writing wgmma's registers across the
// asynchronous window (between issue and wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats rounded to bf16 and packed, lo in the low half (the lower
// column of a wgmma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (128B swizzle) in bits 62-63.  K-major (a row holds K): stride = 1024
// bytes between groups of 8 rows, leading offset unused (1).  MN-major (a
// row holds 64 MN values of one k): stride = 1024 bytes between groups of
// 8 k, leading = bytes between blocks of 64 MN columns.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead_bytes,
                                         uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (1ull << 62);
}

#define ACC4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define ACC16(C, i) ACC4(C, i), ACC4(C, i + 4), ACC4(C, i + 8), ACC4(C, i + 12)
#define ACC32(C) ACC16(C, 0), ACC16(C, 16)
#define ACC64(C) ACC16(C, 0), ACC16(C, 16), ACC16(C, 32), ACC16(C, 48)
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64) = A (64 x 16) . B (16 x 64), both K-major in shared memory;
// d's earlier contents are ignored (scale-d = 0).
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32("=f")
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 64) += A (64 x 16) . B (16 x 64), both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32("+f")
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x N) += A (64 x 16, bf16x2 registers) . B (16 x N), B MN-major in
// shared memory (transpose bit set).  N = 64 or 128.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC4
#undef ACC16
#undef ACC32
#undef ACC64
#undef REGS32
#undef REGS64

// ------------------------------------------------------------ tiles

// Bytes of an R x D bf16 tile.
template <int D, int R>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return static_cast<uint32_t>(R) * D * 2;
}

// Rows row0 .. row0 + R - 1 of head `head` of batch `b` of a (B, S, NH, D)
// tensor into the swizzled layout at dst (1024-byte aligned), one TMA box
// of R rows x 64 columns per 64-column block.  The map's box is R rows;
// rows past S arrive as zeros and still count their bytes.
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row0,
                                         int b) {
#pragma unroll
  for (int blk = 0; blk < D / 64; ++blk)
    tma_load(dst + blk * (R * 128), map, bar, 64 * blk, head, row0, b);
}

// Descriptor of k-step kk (16 columns) of a K-major R-row tile at `tile`.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * (R * 128) + (kk % 4) * 32, 16, 1024);
}

// Descriptor of k-step kk (16 rows) of a 64-row tile read MN-major: its
// rows are the k dimension, its D columns the N dimension.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, kRingRows * 128, 1024);
}

// 64 x D fp32 accumulator rows (row0, row0 + 8 of each thread) as bf16
// into a (.., stride)-strided tensor at out.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, size_t stride,
                                           const float (&d)[D / 2]) {
  const int lane = threadIdx.x % 32;
  bf16* row = out + static_cast<size_t>(16 * ((threadIdx.x % 128) / 32) +
                                        lane / 4) * stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(row + 8 * stride + col) =
        pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// ------------------------------------------------------------ dK / dV

template <int D>
struct DkvSmem {
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + tile_bytes<D, kTileRows>();
  static constexpr uint32_t kStage = tile_bytes<D, kRingRows>();
  static constexpr uint32_t kQ = kV + tile_bytes<D, kTileRows>();
  static constexpr uint32_t kdO = kQ + 2 * kStage;
  static constexpr uint32_t kLse = kdO + 2 * kStage;  // [2][64] fp32
  static constexpr uint32_t kDelta = kLse + 2 * kRingRows * 4;
  static constexpr uint32_t kBar = kDelta + 2 * kRingRows * 4;  // K/V, 2 stages
  static constexpr uint32_t kBytes = kBar + 3 * 8;
};

template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int q_len, int kv_len, int heads, int kv_heads,
                              float scale, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms: 1024 B
  const float* s_lse = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                      L::kLse);
  const float* s_delta = reinterpret_cast<const float*>(
      smem_raw + (base - raw) + L::kDelta);
  const uint32_t bar_kv = base + L::kBar;  // then one per ring stage

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTileRows;  // tile 0, the heaviest, first
  const int kw0 = k0 + kWgRows * wg;      // this warpgroup's first KV row
  const bool wg_active = kw0 < kv_len;
  const int groups = heads / kv_heads;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;

  // Causal: q tiles wholly before row k0 see none of this KV tile.
  const int n_qt = q_len / kRingRows;
  const int qt_begin = causal ? min(k0 / kRingRows, n_qt) : 0;
  const int per_head = n_qt - qt_begin;
  const int n_iter = groups * per_head;

  // Thread 0 issues every copy: Q, dO, lse and delta of one q tile.
  auto issue_stage = [&](int it, int stage) {
    const int h = kvh * groups + it / per_head;
    const int q0 = (qt_begin + it % per_head) * kRingRows;
    const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;
    const uint32_t bar = bar_kv + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * L::kStage + 2 * kRingRows * 4);
    tma_tile<D, kRingRows>(base + L::kQ + stage * L::kStage, &tm_q, bar, h,
                           q0, b);
    tma_tile<D, kRingRows>(base + L::kdO + stage * L::kStage, &tm_do, bar, h,
                           q0, b);
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
    // K and V stay for the block's life (rows past kv_len arrive as zeros;
    // their warpgroup computes nothing).
    mbar_expect_tx(bar_kv, 2 * tile_bytes<D, kTileRows>());
    tma_tile<D, kTileRows>(base + L::kK, &tm_k, bar_kv, kvh, k0, b);
    tma_tile<D, kTileRows>(base + L::kV, &tm_v, bar_kv, kvh, k0, b);
    issue_stage(0, 0);
  }

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t sK = base + L::kK + wg * kWgRows * 128;
  const uint32_t sV = base + L::kV + wg * kWgRows * 128;
  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    // The other stage was freed by the last iteration's closing barrier.
    if (threadIdx.x == 0 && it + 1 < n_iter) issue_stage(it + 1, stage ^ 1);
    if (it == 0) mbar_wait(bar_kv, 0);
    mbar_wait(bar_kv + 8 * (1 + stage), (it >> 1) & 1);

    const int q0 = (qt_begin + it % per_head) * kRingRows;
    if (wg_active && !(causal && kw0 > q0 + kRingRows - 1)) {
      const uint32_t sQ = base + L::kQ + stage * L::kStage;
      const uint32_t sdO = base + L::kdO + stage * L::kStage;

      // S^T = K.Q^T and dP^T = V.dO^T: 64 KV rows x 64 q columns.
      float s[32], dp[32];
      wgmma_fence();
      wgmma_ss_first(s, kmajor<kTileRows>(sK, 0), kmajor<kRingRows>(sQ, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(s, kmajor<kTileRows>(sK, kk), kmajor<kRingRows>(sQ, kk));
      wgmma_ss_first(dp, kmajor<kTileRows>(sV, 0), kmajor<kRingRows>(sdO, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor<kTileRows>(sV, kk), kmajor<kRingRows>(sdO, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T.  Element 4j + e of a thread: KV row
      // row0 + 8 * (e / 2), q column 8j + 2 * (lane % 4) + e % 2.
      const int row0 = kw0 + 16 * warp + lane / 4;
      const float* lse_t = s_lse + stage * kRingRows;
      const float* delta_t = s_delta + stage * kRingRows;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float l = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float p = exp2f(s[i] * scale_log2 - l * kLog2e);
          if (causal && row0 + 8 * (e >> 1) > q0 + col + (e & 1)) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dl) * scale;
        }
      }
      // Accumulator layout -> register A operand: k-step kk holds columns
      // 16kk..16kk+15, i.e. elements 8kk..8kk+7, paired low/high.
      uint32_t pa[16], dsa[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }

      // dV += P^T.dO and dK += dS^T.Q: 64 KV rows x D, over 64 q.
      fence_regs(pa);
      fence_regs(dsa);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRingRows / 16; ++kk)
        wgmma_rs(dv_acc, pa + 4 * kk, mnmajor(sdO, kk));
#pragma unroll
      for (int kk = 0; kk < kRingRows / 16; ++kk)
        wgmma_rs(dk_acc, dsa + 4 * kk, mnmajor(sQ, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (wg_active) {
    const size_t off = (static_cast<size_t>(b) * kv_len + kw0) * kv_stride +
                       static_cast<size_t>(kvh) * D;
    store_rows<D>(dk + off, kv_stride, dk_acc);
    store_rows<D>(dv + off, kv_stride, dv_acc);
  }
}

// ------------------------------------------------------------ dQ

template <int D>
struct DqSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kdO = kQ + tile_bytes<D, kTileRows>();
  static constexpr uint32_t kStage = tile_bytes<D, kRingRows>();
  static constexpr uint32_t kK = kdO + tile_bytes<D, kTileRows>();
  static constexpr uint32_t kV = kK + 2 * kStage;
  static constexpr uint32_t kBar = kV + 2 * kStage;  // Q/dO, 2 stages
  static constexpr uint32_t kBytes = kBar + 3 * 8;
};

template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int q_len, int kv_len,
                             int heads, int kv_heads, float scale,
                             int causal) {
  using L = DqSmem<D>;
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
  const size_t q_stride = static_cast<size_t>(heads) * D;

  // Causal: KV tiles wholly after the q tile's last row contribute nothing.
  const int kv_end = causal ? min(kv_len, q0 + q_rows) : kv_len;
  const int n_kt = kv_end / kRingRows;

  // Thread 0 issues every copy: K and V of one KV tile.
  auto issue_stage = [&](int it, int stage) {
    const uint32_t bar = bar_q + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * L::kStage);
    tma_tile<D, kRingRows>(base + L::kK + stage * L::kStage, &tm_k, bar, kvh,
                           it * kRingRows, b);
    tma_tile<D, kRingRows>(base + L::kV + stage * L::kStage, &tm_v, bar, kvh,
                           it * kRingRows, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_kt > 0) {
    // Q and dO stay (rows past q_len arrive as zeros; their warpgroup
    // computes nothing).
    mbar_expect_tx(bar_q, 2 * tile_bytes<D, kTileRows>());
    tma_tile<D, kTileRows>(base + L::kQ, &tm_q, bar_q, h, q0, b);
    tma_tile<D, kTileRows>(base + L::kdO, &tm_do, bar_q, h, q0, b);
    issue_stage(0, 0);
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

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  const uint32_t sQ = base + L::kQ + wg * kWgRows * 128;
  const uint32_t sdO = base + L::kdO + wg * kWgRows * 128;
  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_kt; ++it) {
    const int stage = it & 1;
    if (threadIdx.x == 0 && it + 1 < n_kt) issue_stage(it + 1, stage ^ 1);
    if (it == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_q + 8 * (1 + stage), (it >> 1) & 1);

    const int k0 = it * kRingRows;
    if (wg_active && !(causal && k0 > qw0 + kWgRows - 1)) {
      const uint32_t sK = base + L::kK + stage * L::kStage;
      const uint32_t sV = base + L::kV + stage * L::kStage;

      // S = Q.K^T and dP = dO.V^T: 64 q rows x 64 KV columns.
      float s[32], dp[32];
      wgmma_fence();
      wgmma_ss_first(s, kmajor<kTileRows>(sQ, 0), kmajor<kRingRows>(sK, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(s, kmajor<kTileRows>(sQ, kk), kmajor<kRingRows>(sK, kk));
      wgmma_ss_first(dp, kmajor<kTileRows>(sdO, 0), kmajor<kRingRows>(sV, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor<kTileRows>(sdO, kk), kmajor<kRingRows>(sV, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // dS.  Element 4j + e: q row row0 + 8 * (e / 2), KV column
      // k0 + 8j + 2 * (lane % 4) + e % 2.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = exp2f(s[i] * scale_log2 - lse_r[e >> 1]);
          if (causal && col + (e & 1) > row0 + 8 * (e >> 1)) p = 0.f;
          dp[i] = p * (dp[i] - delta_r[e >> 1]) * scale;
        }
      }
      uint32_t dsa[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

      // dQ += dS.K: 64 q rows x D, over 64 KV rows (K read MN-major).
      fence_regs(dsa);
      fence_regs(dq_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRingRows / 16; ++kk)
        wgmma_rs(dq_acc, dsa + 4 * kk, mnmajor(sK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      fence_regs(dsa);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (wg_active)
    store_rows<D>(dq + (static_cast<size_t>(b) * q_len + qw0) * q_stride +
                      static_cast<size_t>(h) * D,
                  q_stride, dq_acc);
}

// ------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int batch, q_len, kv_len, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

constexpr int kAlignSlack = 1024;  // the kernels align their base to 1024

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; it is fetched through the
// runtime, so the library links no libcuda and stays a plain C library.
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &found, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &found, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || found == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(found);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 4-D map (D, heads, length, batch) of a (B, S, NH, D) bf16 tensor whose
// box is `rows` rows x 64 columns of one head, 128-byte swizzled (the
// layout of tma_tile).  Out-of-bounds rows read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int len,
                     int nheads, int head_dim, int rows) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t row_bytes = 2ull * nheads * head_dim;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(nheads),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {2ull * head_dim, row_bytes,
                                 row_bytes * static_cast<cuuint64_t>(len)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of q, k, v and dO with `q_rows`-row boxes for q and dO and
// `kv_rows`-row boxes for k and v.
cudaError_t make_maps(const Args& a, int head_dim, int q_rows, int kv_rows,
                      CUtensorMap (&maps)[4]) {
  cudaError_t err;
  if ((err = make_map(&maps[0], a.q, a.batch, a.q_len, a.heads, head_dim,
                      q_rows)) != cudaSuccess ||
      (err = make_map(&maps[1], a.k, a.batch, a.kv_len, a.kv_heads, head_dim,
                      kv_rows)) != cudaSuccess ||
      (err = make_map(&maps[2], a.v, a.batch, a.kv_len, a.kv_heads, head_dim,
                      kv_rows)) != cudaSuccess ||
      (err = make_map(&maps[3], a.dout, a.batch, a.q_len, a.heads, head_dim,
                      q_rows)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int smem = DqSmem<D>::kBytes + kAlignSlack;
  CUtensorMap maps[4];
  cudaError_t err = make_maps(a, D, kTileRows, kRingRows, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, a.batch, (a.q_len + kTileRows - 1) / kTileRows);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreadsSm90, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
      a.q_len, a.kv_len, a.heads, a.kv_heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int smem = DkvSmem<D>::kBytes + kAlignSlack;
  CUtensorMap maps[4];
  cudaError_t err = make_maps(a, D, kRingRows, kTileRows, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kv_heads, a.batch,
                  (a.kv_len + kTileRows - 1) / kTileRows);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreadsSm90, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), a.q_len, a.kv_len, a.heads, a.kv_heads,
      a.scale, a.causal);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, D>) for bf16 (dtype 1) and
// head_dim 64 or 128; anything else is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(const Args& a, int head_dim, int dtype, F&& launch) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
      reinterpret_cast<uintptr_t>(a.lse) |
      reinterpret_cast<uintptr_t>(a.delta) |
      reinterpret_cast<uintptr_t>(a.out0) | reinterpret_cast<uintptr_t>(a.out1);
  if (dtype != 1 || (addr_bits & 15) != 0 || a.batch <= 0 || a.q_len <= 0 ||
      a.kv_len <= 0 || a.heads <= 0 || a.kv_heads <= 0 ||
      a.heads % a.kv_heads != 0 || a.q_len % kLengthMultiple != 0 ||
      a.kv_len % kLengthMultiple != 0)
    return cudaErrorInvalidValue;
  if (head_dim == 64) return launch(std::integral_constant<int, 64>{});
  if (head_dim == 128) return launch(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t (0 = success).  dtype: 1 = bfloat16 (the only one).
extern "C" int flash_attention_bwd_dq_sm90(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, int batch, int q_len,
                                           int kv_len, int heads,
                                           int kv_heads, int head_dim,
                                           int dtype, float scale, int causal,
                                           void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr,
               batch, q_len, kv_len, heads, kv_heads, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto d) {
    return launch_dq<decltype(d)::value>(a);
  }));
}

extern "C" int flash_attention_bwd_dkv_sm90(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int batch, int q_len,
                                            int kv_len, int heads,
                                            int kv_heads, int head_dim,
                                            int dtype, float scale,
                                            int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv,
               batch, q_len, kv_len, heads, kv_heads, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto d) {
    return launch_dkv<decltype(d)::value>(a);
  }));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
