// Flash-attention backward in fp32 on Hopper's tensor cores (sm_90a), at
// head_dim 64 or 128, bound to PyTorch through plain C entry points
// (ctypes).  Two kernels, launched one after the other by
// `flash_attention_backward` in ant_ray_tpu_torch/ops/flash_attention.py
// for the inputs that `_route` sends to its "tf32x3" route:
//
//   flash_attention_bwd_dq_tf32x3   replaces `_dq_kernel` of
//       ant_ray_tpu/ops/pallas/flash_attention.py (lines 196-236);
//   flash_attention_bwd_dkv_tf32x3  replaces `_dkv` of the same file
//       (lines 301-348).
//
// They compute what flash_attention_bwd.cu (the CUDA-core pair, which
// keeps head_dim 256 and bf16 there) computes, with the same rounding
// points:
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
// What bounds them.  At GPT-2's fp32 shape (B=8, S=1024, H=KVH=12, D=64,
// causal) the pair does 14*D FLOPs per (q, k) pair (6*D in dQ, 8*D in
// dK/dV: both recompute S and dP), 45 GFLOP, against ~0.1 GB of traffic:
// bound by operations.  fp32 FMAs on the CUDA cores peak at 67 TFLOP/s;
// the tensor cores in 3xTF32 (flash_attention_tf32x3.cuh) at 165.
//
// What the design does about the bound:
//   * Every product is mma.sync.m16n8k8 (tf32 in, fp32 accumulators),
//     issued three times (mma_3xtf32).  Each warp owns 16 rows of its
//     block's tile; fragments are loaded from shared memory by hand, so
//     operands can be read in either orientation (wgmma's tf32 form takes
//     only K-major operands in shared memory, and three of the five
//     products read their B operand MN-major).
//   * P and dS stay in registers: the following product takes them
//     straight from the accumulators in a permuted k order (a_from_acc,
//     load_b_mnmajor_permuted).  No shuffle.
//   * Tiles are copied with cp.async, 16 bytes at a time, into fp32 rows
//     padded to D + 4 floats: no bank conflicts in either orientation.
//   * dQ: one block of 4 warps per (64-row q tile, head, batch); Q and dO
//     stay in shared memory, 64-row K and V tiles up to the causal
//     diagonal stream through two stages, the next loading while this one
//     is used.  Heaviest q tiles first.
//   * dK/dV: one block of 4 warps per (64-row KV tile, KV head, batch); K
//     and V stay, the Q and dO tiles (64 rows at D = 64, 32 at D = 128,
//     which keeps S^T, dP^T and both accumulators in registers) of every
//     query head of the group stream through two stages: the TPU kernel's
//     GQA design, with no atomics.  It computes S^T = K.Q^T and
//     dP^T = V.dO^T, so P^T and dS^T are the A operands of dV += P^T.dO
//     and dK += dS^T.Q.  Heaviest KV tiles (the first) first.
//   * Shared memory: dQ 104 KB at D = 64 (two blocks an SM), 198 KB at
//     D = 128; dK/dV 103 KB and 133 KB.
// Lengths must be multiples of 64; the wrapper rejects anything else.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "flash_attention_common.cuh"
#include "flash_attention_tf32x3.cuh"

namespace {

using flash::round_to;
using namespace tf32x3;

constexpr int kRows = 64;       // the block's own tile (q in dQ, KV in dK/dV)
constexpr int kLengthMultiple = 64;
constexpr int kKvRows = 64;     // the KV tiles that stream through dQ

// Rows of the q tiles that stream through dK/dV.
template <int D>
__host__ __device__ constexpr int dkv_stream_rows() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO (kRows x D+4) and two stages of sK, sV.
  return sizeof(float) * (2 * kRows + 4 * kKvRows) * (D + kPad);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV (kRows x D+4) and two stages of sQ, sdO, lse and delta.
  constexpr int R = dkv_stream_rows<D>();
  return sizeof(float) * (2 * kRows * (D + kPad) + 2 * (2 * R * (D + kPad) +
                                                        2 * R));
}

// --------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int q_len, int kv_len,
                               int heads, int kv_heads, float scale,
                               int causal) {
  constexpr int P = D + kPad;
  constexpr int kBK = kKvRows;
  constexpr int kSN = kBK / 8;   // n8 tiles of S (a warp's 16 x kBK)
  constexpr int kDN = D / 8;     // n8 tiles of dq (16 x D)
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kRows * P;
  float* sKV = sdO + kRows * P;  // stage s: K at s * 2 kBK P, V after it

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int m0 = 16 * warp;
  // Heaviest tiles first: under a causal mask the last q tiles see most.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
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
  const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;

  // Causal: KV tiles wholly above the diagonal contribute nothing.
  const int kv_end =
      causal ? (kv_len < q0 + kRows ? kv_len : q0 + kRows) : kv_len;
  const int n_tiles = kv_end / kBK;

  auto load_kv = [&](int tile) {
    float* sK = sKV + (tile & 1) * 2 * kBK * P;
    const size_t off = static_cast<size_t>(tile) * kBK * kv_stride;
    copy_tile<kBK, D>(sK, kb + off, kv_stride);
    copy_tile<kBK, D>(sK + kBK * P, vb + off, kv_stride);
  };
  copy_tile<kRows, D>(sQ, q + q_off, q_stride);
  copy_tile<kRows, D>(sdO, dout + q_off, q_stride);
  load_kv(0);
  cp_async_commit();

  // This thread's rows of the q tile: m0 + g and m0 + g + 8.
  const float lse_r[2] = {lse[row_off + m0 + g], lse[row_off + m0 + g + 8]};
  const float delta_r[2] = {delta[row_off + m0 + g],
                            delta[row_off + m0 + g + 8]};
  const int q_pos0 = q0 + m0 + g;
  float acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and Q, dO) landed for every thread
    const float* sK = sKV + (it & 1) * 2 * kBK * P;
    const float* sV = sK + kBK * P;
    const int k0 = it * kBK;

    // S = Q.K^T and dP = dO.V^T for this warp's 16 rows.
    float s[kSN][4], dp[kSN][4];
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const Split<4> qa = load_a<P>(sQ, m0, 8 * kk, g, t);
      const Split<4> oa = load_a<P>(sdO, m0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        mma_3xtf32(s[n], qa, load_b_kmajor<P>(sK, 8 * n, 8 * kk, g, t));
        mma_3xtf32(dp[n], oa, load_b_kmajor<P>(sV, 8 * n, 8 * kk, g, t));
      }
    }

    // dS, rounded to the input type before dS.K as the reference does;
    // it replaces S in place.
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = expf(s[n][e] * scale - lse_r[r]);
        if (causal && k0 + 8 * n + 2 * t + (e & 1) > q_pos0 + 8 * r) p = 0.f;
        s[n][e] = round_to<float>(p * (dp[n][e] - delta_r[r]) * scale);
      }

    // dq += dS.K: k runs over this tile's KV rows, permuted.
#pragma unroll
    for (int kk = 0; kk < kSN; ++kk) {
      const Split<4> da = a_from_acc(s[kk]);
#pragma unroll
      for (int n = 0; n < kDN; ++n)
        mma_3xtf32(acc[n],
                   da, load_b_mnmajor_permuted<P>(sK, 8 * kk, 8 * n, g, t));
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = dq + q_off + (m0 + g + 8 * r) * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kDN; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------- dK/dV

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int q_len, int kv_len, int heads,
                                int kv_heads, float scale, int causal) {
  constexpr int P = D + kPad;
  constexpr int kBQ = dkv_stream_rows<D>();
  constexpr int kSN = kBQ / 8;   // n8 tiles of S^T (a warp's 16 x kBQ)
  constexpr int kDN = D / 8;     // n8 tiles of dk, dv (16 x D)
  constexpr int kStage = 2 * kBQ * P + 2 * kBQ;   // floats
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kRows * P;
  float* sStages = sV + kRows * P;   // stage s: Q, dO, lse, delta

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int m0 = 16 * warp;
  const int k0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = heads / kv_heads;
  const size_t q_stride = static_cast<size_t>(heads) * D;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const size_t kv_off = (static_cast<size_t>(b) * kv_len + k0) * kv_stride +
                        static_cast<size_t>(kvh) * D;

  // Causal: q tiles wholly before row k0 see none of this KV tile, so the
  // walk starts at q = k0 (a KV tile with k0 >= Sq sees no query).
  const int q_begin = causal ? k0 : 0;
  const int n_q = q_begin < q_len ? (q_len - q_begin) / kBQ : 0;
  const int n_tiles = groups * n_q;   // (head of the group, q tile) pairs

  auto load_q = [&](int tile) {
    float* st = sStages + (tile & 1) * kStage;
    const int h = kvh * groups + tile / n_q;
    const int q0 = q_begin + (tile % n_q) * kBQ;
    const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                         static_cast<size_t>(h) * D;
    const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;
    copy_tile<kBQ, D>(st, q + q_off, q_stride);
    copy_tile<kBQ, D>(st + kBQ * P, dout + q_off, q_stride);
    copy_row(st + 2 * kBQ * P, lse + row_off, kBQ);
    copy_row(st + 2 * kBQ * P + kBQ, delta + row_off, kBQ);
  };
  if (n_tiles > 0) {
    copy_tile<kRows, D>(sK, k + kv_off, kv_stride);
    copy_tile<kRows, D>(sV, v + kv_off, kv_stride);
    load_q(0);
    cp_async_commit();
  }

  const int k_pos0 = k0 + m0 + g;   // this thread's KV rows: +0 and +8
  float dk_acc[kDN][4], dv_acc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_q(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and K, V) landed for every thread
    const float* sQ = sStages + (it & 1) * kStage;
    const float* sdO = sQ + kBQ * P;
    const float* sL = sdO + kBQ * P;
    const float* sDelta = sL + kBQ;
    const int q0 = q_begin + (it % n_q) * kBQ;

    // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 KV rows.
    float st[kSN][4], dpt[kSN][4];
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const Split<4> ka = load_a<P>(sK, m0, 8 * kk, g, t);
      const Split<4> va = load_a<P>(sV, m0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < kSN; ++n) {
        mma_3xtf32(st[n], ka, load_b_kmajor<P>(sQ, 8 * n, 8 * kk, g, t));
        mma_3xtf32(dpt[n], va, load_b_kmajor<P>(sdO, 8 * n, 8 * kk, g, t));
      }
    }

    // P^T and dS^T, rounded to the input type before the products as the
    // reference does; they replace S^T and dP^T in place.
#pragma unroll
    for (int n = 0; n < kSN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);
        float p = expf(st[n][e] * scale - sL[qc]);
        if (causal && k_pos0 + 8 * (e >> 1) > q0 + qc) p = 0.f;
        const float ds = p * (dpt[n][e] - sDelta[qc]) * scale;
        st[n][e] = round_to<float>(p);
        dpt[n][e] = round_to<float>(ds);
      }

    // dv += P^T.dO and dk += dS^T.Q: k runs over the q tile's rows,
    // permuted.
#pragma unroll
    for (int kk = 0; kk < kSN; ++kk) {
      const Split<4> pa = a_from_acc(st[kk]);
      const Split<4> dsa = a_from_acc(dpt[kk]);
#pragma unroll
      for (int n = 0; n < kDN; ++n) {
        mma_3xtf32(dv_acc[n], pa,
                   load_b_mnmajor_permuted<P>(sdO, 8 * kk, 8 * n, g, t));
        mma_3xtf32(dk_acc[n], dsa,
                   load_b_mnmajor_permuted<P>(sQ, 8 * kk, 8 * n, g, t));
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  // A KV tile that no query reaches (causal, k0 >= Sq) writes zeros.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t off = kv_off + (m0 + g + 8 * r) * kv_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
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

template <int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // Above 48 KB, dynamic shared memory has to be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.q_len / kRows, a.heads, a.batch);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.out0, a.q_len, a.kv_len,
      a.heads, a.kv_heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kv_len / kRows, a.kv_heads, a.batch);
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.out0, a.out1, a.q_len,
      a.kv_len, a.heads, a.kv_heads, a.scale, a.causal);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, D>) for head_dim 64 or 128;
// anything but fp32 (dtype 0) at those head dims is refused.
template <typename F>
cudaError_t dispatch(const Args& a, int head_dim, int dtype, F&& launch) {
  if (dtype != 0 || a.batch <= 0 || a.q_len <= 0 || a.kv_len <= 0 ||
      a.heads <= 0 || a.kv_heads <= 0 || a.heads % a.kv_heads != 0 ||
      a.q_len % kLengthMultiple != 0 || a.kv_len % kLengthMultiple != 0)
    return cudaErrorInvalidValue;
  switch (head_dim) {
    case 64:
      return launch(std::integral_constant<int, 64>{});
    case 128:
      return launch(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 = success).  dtype must be 0 (float32).
extern "C" int flash_attention_bwd_dq_tf32x3(
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
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto d) {
    return launch_dq<decltype(d)::value>(a);
  }));
}

extern "C" int flash_attention_bwd_dkv_tf32x3(
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
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto d) {
    return launch_dkv<decltype(d)::value>(a);
  }));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
