// Flash-attention backward, written by hand for Hopper (sm_90a), bound to
// PyTorch through plain C entry points (ctypes).  Two kernels, launched
// one after the other by `flash_attention_backward` in
// ant_ray_tpu_torch/ops/flash_attention.py:
//
//   flash_attention_bwd_dq   replaces `_dq_kernel` of
//       ant_ray_tpu/ops/pallas/flash_attention.py (lines 196-236);
//   flash_attention_bwd_dkv  replaces `_dkv` of the same file
//       (lines 301-348).
//
// Both compute the functions of the TPU kernels, with the same rounding
// points:
//   s  = q.k^T * scale (fp32),  p = exp(s - lse), 0 where k_pos > q_pos
//        (top-left causal alignment, as the forward),
//   dp = dO.v^T (fp32),  ds = p * (dp - delta) * scale,
//   dq = sum_k round(ds) . k,
//   dv = sum_{heads of the group, q} round(p)^T . dO,
//   dk = sum_{heads of the group, q} round(ds)^T . q,
// where round() is the cast to the input type (`.astype(q.dtype)` there)
// and every sum is taken in fp32.  delta = rowsum(dO * O) (fp32) and lse
// (B, H, Sq) come from the wrapper, as the JAX package computes delta
// outside its kernels.  dq is written in q's type, dk and dv in k's and v's.
//
// Layouts: q, dO (B, Sq, H, D); k, v (B, Skv, KVH, D); lse, delta
// (B, H, Sq) fp32 (the TPU kernels read (B, H, Sq, 1): the same memory).
//
// What bounds them.  At the training slice's shapes (Llama-400M: B=8,
// H=8, KVH=4, D=128, S=2048, bf16, causal) they are compute-bound: the
// least work of the whole backward is five matmuls, 10*D FLOPs per
// (q, k) pair, ~172 GFLOP per layer, ~0.17 ms at the H100's 989 TFLOP/s
// bf16 tensor-core peak, against ~0.2 GB of traffic (~0.06 ms at
// 3.35 TB/s).
//
// What this first design does about that bound: little.  It is the simple
// design that is right first, built like the forward kernel:
//   * dq: one block of 256 threads per (q tile, head, batch) loops over
//     the KV tiles up to the causal diagonal, with the dq accumulator in
//     registers; S, dP and dS.K as fp32 FMAs on the CUDA cores.  It does
//     6*D FLOPs per pair (S and dP are recomputed here and in dkv).
//   * dkv: one block per (KV tile, KV head, batch) loops over every query
//     head of its group and every q tile from the causal diagonal on, with
//     the dk and dv accumulators in registers: the TPU kernel's GQA design
//     (no atomics, no head repeat, no reduction across blocks).  8*D FLOPs
//     per pair.
//   * Q, dO, K and V tiles are staged through shared memory as fp32, rows
//     padded by one float against bank conflicts.  Tiles are 64 rows for
//     D = 64 and 128 and 32 rows for D = 256, which keeps the dkv block
//     (K, V, Q, dO tiles plus P and dS) under the 227 KB a block may use.
//   * dq blocks run heaviest first (the last q tiles under a causal mask),
//     dkv blocks are numbered that way already (the first KV tiles).
// No tensor cores, no TMA, no cp.async pipelining: the ceiling is the fp32
// CUDA-core rate (67 TFLOP/s).  The times beside the bound are in PERF.md.
//
// Takes fp32 and bf16, D in {64, 128, 256}, Sq and Skv multiples of 64;
// the Python wrapper rejects anything else before launching.

#include <cstddef>
#include <type_traits>

#include "flash_attention_common.cuh"

namespace {

using flash::from_float;
using flash::kThreads;
using flash::round_to;
using flash::to_float;

constexpr int kLengthMultiple = 64;

// Rows of a q tile and of a KV tile (both kernels).
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D == 256 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO (BQ x D+1), sK, sV (BK x D+1), sdS (BQ x BK+1), all fp32.
  constexpr int B = tile_rows<D>();
  return sizeof(float) * (4 * B * (D + 1) + B * (B + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sdO (B x D+1), sP, sdS (BK x BQ+1), lse and delta (BQ).
  constexpr int B = tile_rows<D>();
  return sizeof(float) * (4 * B * (D + 1) + 2 * B * (B + 1) + 2 * B);
}

// rows x D elements of a (.., row_stride)-strided tensor into a padded
// fp32 shared-memory tile.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows,
                                          size_t row_stride) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = to_float(src[r * row_stride + d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int q_len, int kv_len, int heads, int kv_heads,
                        float scale, int causal) {
  constexpr int kB = tile_rows<D>();
  constexpr int kR = kB / 16;        // S rows and columns per thread
  constexpr int kCols = D / 16;      // dq columns per thread
  constexpr int kDP = D + 1;
  constexpr int kSP = kB + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kB * kDP;
  float* sK = sdO + kB * kDP;
  float* sV = sK + kB * kDP;
  float* sdS = sV + kB * kDP;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // Heaviest tiles first: under a causal mask the last q tiles see most.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * D;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                       static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * kv_len * kv_stride +
                static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * kv_len * kv_stride +
                static_cast<size_t>(kvh) * D;
  const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;

  load_tile<T, D>(sQ, q + q_off, kB, q_stride);
  load_tile<T, D>(sdO, dout + q_off, kB, q_stride);
  float lse_r[kR], delta_r[kR], acc[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    lse_r[i] = lse[row_off + ty + 16 * i];
    delta_r[i] = delta[row_off + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // Causal: KV tiles wholly above the diagonal contribute nothing.
  const int kv_end =
      causal ? (kv_len < q0 + kB ? kv_len : q0 + kB) : kv_len;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done (and sQ set)
    load_tile<T, D>(sK, kb + static_cast<size_t>(k0) * kv_stride, kB,
                    kv_stride);
    load_tile<T, D>(sV, vb + static_cast<size_t>(k0) * kv_stride, kB,
                    kv_stride);
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: rows ty + 16*i, columns tx + 16*j.
    float s[kR][kR], dp[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kR], g[kR], c[kR], e[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        a[i] = sQ[(ty + 16 * i) * kDP + d];
        g[i] = sdO[(ty + 16 * i) * kDP + d];
        c[i] = sK[(tx + 16 * i) * kDP + d];
        e[i] = sV[(tx + 16 * i) * kDP + d];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }

    // dS, rounded to the input type before dS.K as the reference does.
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int q_pos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        float p = expf(s[i][j] * scale - lse_r[i]);
        if (causal && k0 + tx + 16 * j > q_pos) p = 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        sdS[(ty + 16 * i) * kSP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dq += dS.K: rows ty + 16*i, columns tx + 16*j.
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float w[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) w[i] = sdS[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = sK[kk * kDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][j] = fmaf(w[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    T* row = dq + q_off + (ty + 16 * i) * q_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) row[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int q_len, int kv_len, int heads,
                         int kv_heads, float scale, int causal) {
  constexpr int kB = tile_rows<D>();
  constexpr int kR = kB / 16;        // S^T rows and columns per thread
  constexpr int kCols = D / 16;      // dk, dv columns per thread
  constexpr int kDP = D + 1;
  constexpr int kPP = kB + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * kDP;
  float* sQ = sV + kB * kDP;
  float* sdO = sQ + kB * kDP;
  float* sP = sdO + kB * kDP;        // round(p)^T: (KV row, q column)
  float* sdS = sP + kB * kPP;        // round(ds)^T
  float* sL = sdS + kB * kPP;        // lse of the q tile's rows
  float* sDelta = sL + kB;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = heads / kv_heads;
  const size_t q_stride = static_cast<size_t>(heads) * D;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const size_t kv_off = (static_cast<size_t>(b) * kv_len + k0) * kv_stride +
                        static_cast<size_t>(kvh) * D;

  load_tile<T, D>(sK, k + kv_off, kB, kv_stride);
  load_tile<T, D>(sV, v + kv_off, kB, kv_stride);
  float dk_acc[kR][kCols], dv_acc[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // Causal: q tiles wholly before row k0 see none of this KV tile (q and
  // KV tiles have one size, so the first one that does starts at k0).
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    for (int q0 = q_begin; q0 < q_len; q0 += kB) {
      const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                           static_cast<size_t>(h) * D;
      const size_t row_off = (static_cast<size_t>(b) * heads + h) * q_len + q0;
      __syncthreads();  // the previous tile's readers are done (and sK set)
      load_tile<T, D>(sQ, q + q_off, kB, q_stride);
      load_tile<T, D>(sdO, dout + q_off, kB, q_stride);
      if (threadIdx.x < kB) {
        sL[threadIdx.x] = lse[row_off + threadIdx.x];
        sDelta[threadIdx.x] = delta[row_off + threadIdx.x];
      }
      __syncthreads();

      // S^T = K.Q^T and dP^T = V.dO^T: KV rows ty + 16*i, q columns
      // tx + 16*j.
      float s[kR][kR], dp[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[kR], e[kR], c[kR], o[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          a[i] = sK[(ty + 16 * i) * kDP + d];
          e[i] = sV[(ty + 16 * i) * kDP + d];
          c[i] = sQ[(tx + 16 * i) * kDP + d];
          o[i] = sdO[(tx + 16 * i) * kDP + d];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            s[i][j] = fmaf(a[i], c[j], s[i][j]);
            dp[i][j] = fmaf(e[i], o[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int k_pos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int qc = tx + 16 * j;
          float p = expf(s[i][j] * scale - sL[qc]);
          if (causal && k_pos > q0 + qc) p = 0.f;
          const float ds = p * (dp[i][j] - sDelta[qc]) * scale;
          sP[(ty + 16 * i) * kPP + qc] = round_to<T>(p);
          sdS[(ty + 16 * i) * kPP + qc] = round_to<T>(ds);
        }
      }
      __syncthreads();

      // dv += P^T.dO and dk += dS^T.Q: KV rows ty + 16*i, columns
      // tx + 16*j.
#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float pw[kR], sw[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pw[i] = sP[(ty + 16 * i) * kPP + qq];
          sw[i] = sdS[(ty + 16 * i) * kPP + qq];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float o = sdO[qq * kDP + tx + 16 * j];
          const float x = sQ[qq * kDP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            dv_acc[i][j] = fmaf(pw[i], o, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sw[i], x, dk_acc[i][j]);
          }
        }
      }
    }
  }

  // A KV tile that no query reaches (causal, k0 >= Sq) writes zeros.
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const size_t off = kv_off + (ty + 16 * i) * kv_stride;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int batch, q_len, kv_len, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // Above 48 KB, dynamic shared memory has to be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.q_len / tile_rows<D>(), a.heads, a.batch);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.q_len, a.kv_len, a.heads, a.kv_heads,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.kv_len / tile_rows<D>(), a.kv_heads, a.batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.q_len, a.kv_len,
      a.heads, a.kv_heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls launch(TypeTag<T>, std::integral_constant<int, D>) for the
// runtime dtype (0 = float32, 1 = bfloat16) and head_dim.
template <typename F>
cudaError_t dispatch(const Args& a, int head_dim, int dtype, F&& launch) {
  if (a.batch <= 0 || a.q_len <= 0 || a.kv_len <= 0 || a.heads <= 0 ||
      a.kv_heads <= 0 || a.heads % a.kv_heads != 0 ||
      a.q_len % kLengthMultiple != 0 || a.kv_len % kLengthMultiple != 0)
    return cudaErrorInvalidValue;
  auto by_dim = [&](auto type) -> cudaError_t {
    switch (head_dim) {
      case 64:
        return launch(type, std::integral_constant<int, 64>{});
      case 128:
        return launch(type, std::integral_constant<int, 128>{});
      case 256:
        return launch(type, std::integral_constant<int, 256>{});
      default:
        return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_dim(TypeTag<float>{});
  if (dtype == 1) return by_dim(TypeTag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t (0 = success).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int batch, int q_len,
                                      int kv_len, int heads, int kv_heads,
                                      int head_dim, int dtype, float scale,
                                      int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr,
               batch, q_len, kv_len, heads, kv_heads, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto t, auto d) {
    return launch_dq<typename decltype(t)::type, decltype(d)::value>(a);
  }));
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int batch,
                                       int q_len, int kv_len, int heads,
                                       int kv_heads, int head_dim, int dtype,
                                       float scale, int causal,
                                       void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv,
               batch, q_len, kv_len, heads, kv_heads, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, head_dim, dtype, [&](auto t, auto d) {
    return launch_dkv<typename decltype(t)::type, decltype(d)::value>(a);
  }));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
