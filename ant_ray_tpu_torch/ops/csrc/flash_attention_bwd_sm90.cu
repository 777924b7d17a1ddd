// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 with
// head_dim 64 or 128, bound to PyTorch through plain C entry points
// (ctypes).  Two kernels, launched one after the other by
// `flash_attention_backward` in ant_ray_tpu_torch/ops/flash_attention.py
// for the inputs that `_route` sends here (the PTX, tile and tensor-map
// helpers are in flash_attention_sm90.cuh, shared with the forward):
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
//     swizzled layout that wgmma descriptors read (see the header).  TMA
//     fills them: one thread
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

#include <cstddef>
#include <cstdint>

#include "flash_attention_sm90.cuh"

namespace {

using namespace flash_sm90;  // NOLINT(build/namespaces)

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

template <int D>
cudaError_t launch_dq(const BwdArgs& a) {
  constexpr int smem = DqSmem<D>::kBytes + kAlignSlack;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps(a, D, kTileRows, kRingRows, maps);
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
cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr int smem = DkvSmem<D>::kBytes + kAlignSlack;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps(a, D, kRingRows, kTileRows, maps);
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

// Calls launch(std::integral_constant<int, D>) for what the kernels take
// (shape_ok) at head_dim 64 or 128; anything else is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(const BwdArgs& a, int head_dim, int dtype, F&& launch) {
  if (!bwd_shape_ok(a, dtype)) return cudaErrorInvalidValue;
  return dispatch_head_dim(head_dim, launch);
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
  const BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr,
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
  const BwdArgs a{q, k, v, dout, lse, delta, dk, dv,
                  batch, q_len, kv_len, heads, kv_heads, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto d) {
    return launch_dkv<decltype(d)::value>(a);
  }));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
