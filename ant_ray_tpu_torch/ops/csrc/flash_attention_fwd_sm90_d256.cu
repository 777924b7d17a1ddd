// Flash-attention forward with logsumexp on Hopper's tensor cores
// (sm_90a), bf16 at head_dim 256, bound to PyTorch through a plain C
// entry point (ctypes).  Launched by `flash_attention_fwd_lse` in
// ant_ray_tpu_torch/ops/flash_attention.py for the inputs that `_route`
// sends here (route "sm90_d256", which also names the backward of
// flash_attention_bwd_sm90_d256.cu); fp32 at head_dim 256 goes to
// flash_attention_fwd.cu (CUDA cores).  The PTX, tile and tensor-map
// helpers are in flash_attention_sm90.cuh.
//
// Replaces the TPU kernel `_kernel` of
// ant_ray_tpu/ops/pallas/flash_attention.py (lines 56-111) and computes
// the same function, with the rounding points of
// flash_attention_fwd_sm90.cu:
//   q (B, Sq, H, D), k/v (B, Skv, KVH, D)  ->  out (B, Sq, H, D) bf16 and
//   lse (B, H, Sq) fp32; s = q.k^T * scale with bf16 operands and fp32
//   sums; KV head = h / (H / KVH) (GQA); top-left causal alignment (a
//   score is masked when k_pos > q_pos) with NEG_INF = -1e30 rather than
//   -inf; online softmax with fp32 m, l and output accumulator, l summing
//   the unrounded p and P.V taking p rounded to bf16 (the packing into
//   wgmma's bf16 A operand is that rounding); l == 0 -> 1, lse = m +
//   log(l).  The exponentials are exp2 of log2(e)-scaled scores.
//
// What bounds it.  At Gemma-7B's attention (B=4, S=2048, H=KVH=16,
// D=256, causal) the two products need 4*D FLOPs per (q, k) pair, ~137
// GFLOP: 0.139 ms at the H100's 989 TFLOP/s bf16 tensor-core peak,
// against ~0.27 GB of traffic (q, k, v read once, out and lse written
// once), 0.08 ms at 3.35 TB/s.  So it is bound by operations, and only
// `wgmma` reaches that rate.
//
// Why the head_dim 64/128 kernel does not simply take D=256.  Its
// __launch_bounds__(256, 2) allows 128 registers a thread, and a
// warpgroup's 64 x 256 fp32 O accumulator alone is 128 registers a
// thread.  Two blocks of its layout at D=256 would also need 2 x 192 KB
// of shared memory, over the SM's 228 KB.
//
// The design (every operand in the 128-byte swizzled layout that TMA
// writes and wgmma descriptors read; see the header):
//   * One block of two warpgroups (256 threads) per (128-row q tile,
//     head, batch), heaviest causal q tiles first; each warpgroup owns 64
//     q rows and all 256 columns of their O.  One block per SM
//     (__launch_bounds__(256, 1)), so a thread may hold up to 255
//     registers: O as two m64n128 halves (128), S (32), P packed to bf16
//     (16), m and l (4).
//   * Shared memory: Q (128 x 256, 64 KB) stays for the block's life;
//     64-row K and V tiles (32 KB each) stream through a two-stage ring
//     (128 KB), so the next tile loads while the tensor cores work on
//     this one: 192 KB, under the 227 KB a block may use.  Thread 0
//     issues every TMA copy; there is no producer warp.
//   * S = Q.K^T is a wgmma m64n64k16 over 16 k-steps with both operands
//     K-major.  The online softmax runs on the accumulator fragment: a
//     thread holds 16 scores of each of two rows, and the row max
//     reduces over the four threads of a quad (the row sum is reduced
//     once, after the loop).
//   * P never touches shared memory: packed to bf16x2 the accumulator
//     fragment is wgmma's register A operand, so O += P.V is two wgmma
//     m64n128k16 (columns 0-127 and 128-255) per k-step, with V read
//     MN-major through the descriptor's transpose bit.  O is rescaled by
//     exp(m_old - m_new) between the wait of one P.V and the issue of
//     the next.
//   * Causal: the block's KV loop ends at min(Skv, end of its q tile); a
//     warpgroup whose 64 rows all lie before a KV tile skips it (but still
//     meets every barrier), and only tiles that cross its diagonal pay for
//     the per-element mask.
//   * Ragged q tiles.  Lengths are multiples of 64, so a 128-row q tile
//     that runs past q_len leaves its second warpgroup wholly past the
//     end.  TMA fills those Q rows with zeros; that warpgroup computes and
//     stores nothing.  KV tiles are 64 rows and never ragged.
//   * Epilogue: out = O / l in bf16 and lse from registers.
//
// Takes bf16, D = 256, Sq and Skv multiples of 64, base addresses on
// 16-byte boundaries; the Python wrapper checks all of these and the
// entry point returns cudaErrorInvalidValue for anything else.

#include <cstddef>
#include <cstdint>

#include "flash_attention_sm90.cuh"

namespace {

using namespace flash_sm90;  // NOLINT(build/namespaces)

constexpr int kD = 256;
constexpr int kMaxSmem = 232448;   // what a block may use on sm_90
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF, not -inf
constexpr float kLn2 = 0.6931471805599453f;

struct FwdSmem {
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kStage = tile_bytes<kD, kRingRows>();
  static constexpr uint32_t kK = kQ + tile_bytes<kD, kTileRows>();
  static constexpr uint32_t kV = kK + 2 * kStage;
  static constexpr uint32_t kBar = kV + 2 * kStage;  // Q, 2 stages
  static constexpr uint32_t kBytes = kBar + 3 * 8;
};
static_assert(FwdSmem::kBytes + kAlignSlack <= kMaxSmem,
              "forward layout over the shared memory a block may use");

__global__ void __launch_bounds__(kThreadsSm90, 1)
    flash_fwd_sm90_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               bf16* __restrict__ out,
                               float* __restrict__ lse, int q_len,
                               int kv_len, int heads, int kv_heads,
                               float scale, int causal) {
  using L = FwdSmem;
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

  // Causal: KV tiles wholly after the q tile's last row contribute nothing.
  const int kv_end = causal ? min(kv_len, q0 + q_rows) : kv_len;
  const int n_kt = kv_end / kRingRows;

  // Thread 0 issues every copy: K and V of one KV tile.
  auto issue_stage = [&](int it, int stage) {
    const uint32_t bar = bar_q + 8 * (1 + stage);
    mbar_expect_tx(bar, 2 * L::kStage);
    tma_tile<kD, kRingRows>(base + L::kK + stage * L::kStage, &tm_k, bar, kvh,
                            it * kRingRows, b);
    tma_tile<kD, kRingRows>(base + L::kV + stage * L::kStage, &tm_v, bar, kvh,
                            it * kRingRows, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar_q + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Q stays (rows past q_len arrive as zeros; their warpgroup computes
    // nothing).  n_kt >= 1: every length is at least 64.
    mbar_expect_tx(bar_q, tile_bytes<kD, kTileRows>());
    tma_tile<kD, kTileRows>(base + L::kQ, &tm_q, bar_q, h, q0, b);
    issue_stage(0, 0);
  }

  // This thread's rows: row0 and row0 + 8 of its warpgroup's 64.  m is
  // the running max of the log2(e)-scaled scores; l is this thread's
  // share of the row sum (its 16 columns of every tile), reduced over the
  // quad after the loop.
  const int row0 = qw0 + 16 * warp + lane / 4;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // O's 64 x 256 as two 64 x 128 halves (columns 0-127, 128-255).
  float o_lo[64], o_hi[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o_lo[i] = o_hi[i] = 0.f;

  const uint32_t sQ = base + L::kQ + wg * kWgRows * 128;
  const float scale_log2 = scale * kLog2e;
  for (int it = 0; it < n_kt; ++it) {
    const int stage = it & 1;
    // The other stage was freed by the last iteration's closing barrier.
    if (threadIdx.x == 0 && it + 1 < n_kt) issue_stage(it + 1, stage ^ 1);
    if (it == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_q + 8 * (1 + stage), (it >> 1) & 1);

    const int k0 = it * kRingRows;
    if (wg_active && !(causal && k0 > qw0 + kWgRows - 1)) {
      const uint32_t sK = base + L::kK + stage * L::kStage;
      const uint32_t sV = base + L::kV + stage * L::kStage;

      // S = Q.K^T: 64 q rows x 64 KV columns, over 256.
      float s[32];
      wgmma_fence();
      wgmma_ss_first(s, kmajor<kTileRows>(sQ, 0), kmajor<kRingRows>(sK, 0));
#pragma unroll
      for (int kk = 1; kk < kD / 16; ++kk)
        wgmma_ss(s, kmajor<kTileRows>(sQ, kk), kmajor<kRingRows>(sK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Scaled scores and the new row max.  Element 4j + e: q row
      // row0 + 8 * (e / 2), KV column k0 + 8j + 2 * (lane % 4) + e % 2.
      const bool diag = causal && k0 + kRingRows - 1 > qw0;
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float x = s[i] * scale_log2;
          if (diag && col + (e & 1) > row0 + 8 * (e >> 1)) x = kNegInf;
          s[i] = x;
          m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
        corr[r] = exp2f(m[r] - m_new[r]);
        m[r] = m_new[r];
        l[r] *= corr[r];
      }
      // p, unrounded into l and rounded to bf16 into P's A operand.  Pair
      // i (elements 2i, 2i + 1) lies in row i % 2 of the thread's two.
      uint32_t pa[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p0 = exp2f(s[2 * i] - m[i & 1]);
        const float p1 = exp2f(s[2 * i + 1] - m[i & 1]);
        l[i & 1] += p0 + p1;
        pa[i] = pack_bf16(p0, p1);
      }
      // O's earlier product was waited on; rescale before the next one.
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        o_lo[i] *= corr[(i >> 1) & 1];
        o_hi[i] *= corr[(i >> 1) & 1];
      }

      // O += P.V: 64 q rows x 256, over 64 KV rows (V read MN-major;
      // columns 128-255 start at its third 64-column block).
      fence_regs(pa);
      fence_regs(o_lo);
      fence_regs(o_hi);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRingRows / 16; ++kk) {
        wgmma_rs(o_lo, pa + 4 * kk, mnmajor(sV, kk));
        wgmma_rs(o_hi, pa + 4 * kk,
                 mnmajor(sV + 2 * tile_bytes<64, kRingRows>(), kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_lo);
      fence_regs(o_hi);
      fence_regs(pa);
    }
    __syncthreads();  // both warpgroups are done with this stage
  }

  if (wg_active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.f) l[r] = 1.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o_lo[i] /= l[(i >> 1) & 1];
      o_hi[i] /= l[(i >> 1) & 1];
    }
    bf16* o = out + (static_cast<size_t>(b) * q_len + qw0) * q_stride +
              static_cast<size_t>(h) * kD;
    store_rows<128>(o, q_stride, o_lo);
    store_rows<128>(o + 128, q_stride, o_hi);
    if (lane % 4 == 0) {
      float* lse_row = lse + (static_cast<size_t>(b) * heads + h) * q_len;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lse_row[row0 + 8 * r] = m[r] * kLn2 + logf(l[r]);
    }
  }
}

cudaError_t launch(const FwdArgs& a) {
  constexpr int smem = FwdSmem::kBytes + kAlignSlack;
  CUtensorMap maps[3];
  cudaError_t err = make_fwd_maps(a, kD, maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_sm90_d256_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads, a.batch, (a.q_len + kTileRows - 1) / kTileRows);
  flash_fwd_sm90_d256_kernel<<<grid, kThreadsSm90, smem, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse), a.q_len, a.kv_len, a.heads, a.kv_heads,
      a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success).  dtype: 1 = bfloat16 (the only
// one); head_dim: 256 (the only one).
extern "C" int flash_attention_fwd_sm90_d256(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int q_len, int kv_len, int heads, int kv_heads, int head_dim,
    int dtype, float scale, int causal, void* stream) {
  const FwdArgs a{q, k, v, out, lse, batch, q_len, kv_len, heads, kv_heads,
                  scale, causal, static_cast<cudaStream_t>(stream)};
  if (head_dim != kD || !fwd_shape_ok(a, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(a));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
