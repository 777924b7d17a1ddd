// Flash-attention forward with logsumexp in fp32 on Hopper's tensor cores
// (sm_90a), at head_dim 64 or 128, bound to PyTorch through a plain C
// entry point (ctypes), launched by `flash_attention_fwd_lse` in
// ant_ray_tpu_torch/ops/flash_attention.py for the inputs that `_route`
// sends to its "tf32x3" route.
//
// Replaces the TPU kernel `_kernel` of
// ant_ray_tpu/ops/pallas/flash_attention.py (lines 56-111) for fp32.  It
// computes the same function as flash_attention_fwd.cu (the CUDA-core
// kernel, which keeps head_dim 256):
//   q (B, Sq, H, D), k/v (B, Skv, KVH, D)  ->  out (B, Sq, H, D) and
//   lse (B, H, Sq), both fp32; online softmax over KV tiles with fp32
//   accumulators, KV head = h / (H / KVH) (GQA), top-left causal alignment
//   (a score is masked when k_pos > q_pos), NEG_INF = -1e30 rather than
//   -inf, l == 0 -> 1, lse = m + log(l), p rounded to the input type
//   before P.V (the reference's `p.astype(v.dtype)`, a no-op in fp32 kept
//   for the reader).  Every tensor fp32 and 16-byte aligned (the wrapper
//   checks); lengths multiples of 64 (the wrapper rejects anything else).
//
// What bounds it.  At GPT-2's fp32 shape (B=8, S=1024, H=KVH=12, D=64,
// causal) it does 4*D FLOPs per unmasked (q, k) pair (S = Q.K^T and P.V),
// 12.9 GFLOP, against ~0.1 GB of traffic: bound by operations.  fp32 FMAs
// on the CUDA cores peak at 67 TFLOP/s (0.19 ms); the tensor cores in
// 3xTF32 (flash_attention_tf32x3.cuh: three TF32 products per fp32 one)
// at 495 / 3 = 165 TFLOP/s (0.078 ms).
//
// What the design does about the bound:
//   * Both products are mma.sync.m16n8k8 (tf32 in, fp32 accumulators),
//     issued three times (mma_3xtf32).  wgmma's tf32 form reads only
//     K-major operands from shared memory, and P.V reads V MN-major.
//   * One block of 4 warps per (q tile, head, batch), heaviest (last) q
//     tiles first.  At D = 64 each warp owns 32 q rows (two m16 tiles, a
//     128-row q tile), so each K or V fragment, loaded and split once,
//     feeds two products, halving the loads and splits per product; this
//     took GPT-2's shape from 0.52 to 0.42 ms on an H100 80GB HBM3 at
//     700 W (chip_smoke.py; PERF.md).  At D = 128 a warp owns 16 rows (a
//     64-row q tile): O alone takes 64 accumulators a thread there, and
//     a second tile would double them and S's.  Lengths are multiples of
//     64, so a 128-row q tile may be half empty; its idle warps copy but
//     compute nothing.  Q stays in shared memory; K and V tiles up to
//     the causal diagonal stream through two cp.async stages, the next
//     loading while this one is used.  KV tiles are 64 rows at D = 64
//     and 32 at D = 128, which keeps two blocks an SM at either: shared
//     memory (Q + 2 x (K + V), rows padded to D + 4 floats) is 102 KB at
//     D = 64 and 99 KB at D = 128.
//   * S = Q.K^T reads K K-major (load_b_kmajor).  The mask and the online
//     softmax run on the accumulator fragment: a thread holds rows g and
//     g + 8 of each m16 tile, columns 2t and 2t + 1 of each n8 tile; the
//     row max is reduced over the quad (shuffles 1 and 2), the row sum is
//     kept per thread and reduced once at the end.
//   * O is rescaled by corr, then O += P.V takes P straight from the
//     accumulators (a_from_acc, permuted k) and reads V's rows in the same
//     permuted order (load_b_mnmajor_permuted): no shuffle and no trip
//     through shared memory for P.
//   * KV tiles are walked from key 0 upward, so every row's first tile
//     holds key 0, which no causal mask hides: m is a real score after the
//     first tile, and a later tile's masked scores give p = 0.
//   * At the end a thread writes its rows' out as 8-byte pairs (the quad
//     of a row fills whole 32-byte sectors) and one thread per row its
//     lse.

#include <cstddef>
#include <cstdint>

#include "flash_attention_common.cuh"
#include "flash_attention_tf32x3.cuh"

namespace {

using flash::kNegInf;
using flash::round_to;
using namespace tf32x3;

constexpr int kLengthMultiple = 64;

// m16 tiles of q rows per warp: each K or V fragment, split once, then
// feeds this many products.
template <int D>
__host__ __device__ constexpr int m_tiles() {
  return D == 64 ? 2 : 1;
}

// The block's q tile: 4 warps of m_tiles() x 16 rows.
template <int D>
__host__ __device__ constexpr int q_rows() {
  return 4 * 16 * m_tiles<D>();
}

// Rows of the K and V tiles that stream through the block.
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ (q_rows x D+4) and two stages of sK, sV (kv_rows x D+4 each).
  return sizeof(float) * (q_rows<D>() + 4 * kv_rows<D>()) * (D + kPad);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, float* __restrict__ lse,
                            int q_len, int kv_len, int heads, int kv_heads,
                            float scale, int causal) {
  constexpr int P = D + kPad;
  constexpr int kM = m_tiles<D>();
  constexpr int kBQ = q_rows<D>();
  constexpr int kBK = kv_rows<D>();
  constexpr int kSN = kBK / 8;   // n8 tiles of S (a warp's 16 x kBK, each)
  constexpr int kDN = D / 8;     // n8 tiles of O (16 x D, each)
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * P;     // stage s: K at s * 2 kBK P, V after it

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int m0 = 16 * kM * warp;   // this warp's first row of the q tile
  // Heaviest tiles first: under a causal mask the last q tiles see most.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  // Lengths are multiples of 64, so the last q tile may hold 64 rows of
  // kBQ = 128; a warp whose rows all lie past q_len computes nothing.
  const int rows = q_len - q0 < kBQ ? q_len - q0 : kBQ;
  const bool active = m0 < rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * D;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                       static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * kv_len * kv_stride +
                    static_cast<size_t>(kvh) * D;
  const float* vb = v + static_cast<size_t>(b) * kv_len * kv_stride +
                    static_cast<size_t>(kvh) * D;

  // Causal: KV tiles wholly above the diagonal contribute nothing.
  const int kv_end =
      causal ? (kv_len < q0 + rows ? kv_len : q0 + rows) : kv_len;
  const int n_tiles = kv_end / kBK;

  auto load_kv = [&](int tile) {
    float* sK = sKV + (tile & 1) * 2 * kBK * P;
    const size_t off = static_cast<size_t>(tile) * kBK * kv_stride;
    copy_tile<kBK, D>(sK, kb + off, kv_stride);
    copy_tile<kBK, D>(sK + kBK * P, vb + off, kv_stride);
  };
  for (int r0 = 0; r0 < rows; r0 += 64)
    copy_tile<64, D>(sQ + r0 * P, q + q_off + r0 * q_stride, q_stride);
  load_kv(0);
  cp_async_commit();

  // This thread's rows of the q tile: m0 + 16 i + g (r = 0) and
  // m0 + 16 i + g + 8 (r = 1) of m16 tile i, indexed 2 i + r below.  m is
  // the same across a row's quad; l is this thread's share of the row
  // sum.
  const int q_pos0 = q0 + m0 + g;
  float m[2 * kM], l[2 * kM];
  float acc[kM][kDN][4];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    m[2 * i] = m[2 * i + 1] = kNegInf;
    l[2 * i] = l[2 * i + 1] = 0.f;
#pragma unroll
    for (int n = 0; n < kDN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and Q) landed for every thread
    if (active) {
      const float* sK = sKV + (it & 1) * 2 * kBK * P;
      const float* sV = sK + kBK * P;
      const int k0 = it * kBK;

      // S = Q.K^T for this warp's rows.
      float s[kM][kSN][4];
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kSN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        Split<4> qa[kM];
#pragma unroll
        for (int i = 0; i < kM; ++i)
          qa[i] = load_a<P>(sQ, m0 + 16 * i, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < kSN; ++n) {
          const Split<2> kf = load_b_kmajor<P>(sK, 8 * n, 8 * kk, g, t);
#pragma unroll
          for (int i = 0; i < kM; ++i) mma_3xtf32(s[i][n], qa[i], kf);
        }
      }

      // Scale, mask and the row max of this tile.
      float row_max[2 * kM];
#pragma unroll
      for (int j = 0; j < 2 * kM; ++j) row_max[j] = kNegInf;
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kSN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * i + (e >> 1);
            float x = s[i][n][e] * scale;
            if (causal && k0 + 8 * n + 2 * t + (e & 1) > q_pos0 + 8 * j)
              x = kNegInf;
            s[i][n][e] = x;
            row_max[j] = fmaxf(row_max[j], x);
          }
      float corr[2 * kM];
#pragma unroll
      for (int j = 0; j < 2 * kM; ++j) {
        row_max[j] = fmaxf(row_max[j],
                           __shfl_xor_sync(0xffffffffu, row_max[j], 1));
        row_max[j] = fmaxf(row_max[j],
                           __shfl_xor_sync(0xffffffffu, row_max[j], 2));
        const float m_new = fmaxf(m[j], row_max[j]);
        corr[j] = expf(m[j] - m_new);
        m[j] = m_new;
        l[j] *= corr[j];
      }

      // p = exp(s - m), rounded to the input type before P.V; it
      // replaces S in place.
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kSN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * i + (e >> 1);
            const float p = expf(s[i][n][e] - m[j]);
            l[j] += p;
            s[i][n][e] = round_to<float>(p);
          }

      // O = O * corr + P.V: k runs over this tile's KV rows, permuted.
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kDN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] *= corr[2 * i + (e >> 1)];
#pragma unroll
      for (int kk = 0; kk < kSN; ++kk) {
        Split<4> pa[kM];
#pragma unroll
        for (int i = 0; i < kM; ++i) pa[i] = a_from_acc(s[i][kk]);
#pragma unroll
        for (int n = 0; n < kDN; ++n) {
          const Split<2> vf =
              load_b_mnmajor_permuted<P>(sV, 8 * kk, 8 * n, g, t);
#pragma unroll
          for (int i = 0; i < kM; ++i) mma_3xtf32(acc[i][n], pa[i], vf);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < 2 * kM; ++j) {
    const int i = j >> 1, r = j & 1;
    float row_sum = l[j];
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    const float li = row_sum == 0.f ? 1.f : row_sum;
    const int row = m0 + g + 8 * j;
    float* o = out + q_off + row * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kDN; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[i][n][2 * r] / li, acc[i][n][2 * r + 1] / li);
    if (t == 0)
      lse[(static_cast<size_t>(b) * heads + h) * q_len + q0 + row] =
          m[j] + logf(li);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, int batch, int q_len, int kv_len,
                   int heads, int kv_heads, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB, dynamic shared memory has to be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kBQ = q_rows<D>();
  const dim3 grid((q_len + kBQ - 1) / kBQ, heads, batch);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, q_len, kv_len, heads, kv_heads, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype must be 0 (float32): the same signature as flash_attention_fwd.
// Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd_tf32x3(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          int batch, int q_len, int kv_len,
                                          int heads, int kv_heads,
                                          int head_dim, int dtype,
                                          float scale, int causal,
                                          void* stream) {
  if (dtype != 0 || batch <= 0 || q_len <= 0 || kv_len <= 0 || heads <= 0 ||
      kv_heads <= 0 || heads % kv_heads != 0 ||
      q_len % kLengthMultiple != 0 || kv_len % kLengthMultiple != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 64:
      err = launch<64>(qf, kf, vf, of, lf, batch, q_len, kv_len, heads,
                       kv_heads, scale, causal, s);
      break;
    case 128:
      err = launch<128>(qf, kf, vf, of, lf, batch, q_len, kv_len, heads,
                        kv_heads, scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
