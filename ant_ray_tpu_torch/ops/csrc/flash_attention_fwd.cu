// Flash-attention forward with logsumexp, written by hand for Hopper
// (sm_90a), bound to PyTorch through a plain C entry point (ctypes).
//
// Replaces the TPU kernel `_kernel` of
// ant_ray_tpu/ops/pallas/flash_attention.py (lines 56-111), launched by
// `flash_attention_fwd_lse` there.  It computes the same function:
//   q (B, Sq, H, D), k/v (B, Skv, KVH, D)  ->  out (B, Sq, H, D) in q's
//   dtype and lse (B, H, Sq) fp32, online softmax over KV tiles with fp32
//   accumulators, KV head = h / (H / KVH) (GQA), top-left causal alignment
//   (a score is masked when k_pos > q_pos), NEG_INF = -1e30 rather than
//   -inf, l == 0 -> 1, lse = m + log(l), p rounded to the input type
//   before P.V exactly as the reference's `p.astype(v.dtype)`.
//
// What bounds it.  At the serving slice's shapes (Llama-3-8B prefill:
// B=1, H=32, KVH=8, D=128, bf16, causal) it is compute-bound: at S=2048 a
// layer needs 4*S*S*D*H/2 ~ 34 GFLOP, ~35 us at the H100's 989 TFLOP/s
// bf16 tensor-core peak, against ~42 MB of traffic (q, k, v read once,
// out and lse written once), ~13 us at 3.35 TB/s.
//
// What this first design does about that bound: little.  It is the simple
// design that is right first:
//   * one thread block of 256 threads per (q tile of 64 rows, head, batch);
//   * the TPU's sequential KV grid axis and its VMEM scratch become a loop
//     inside the block, with m, l and the output accumulator in registers;
//   * Q, then each 64-row K and V tile, staged through shared memory as
//     fp32 (rows padded by one float against bank conflicts);
//   * S = Q.K^T and O += P.V as fp32 FMAs on the CUDA cores, each thread
//     owning a 4 x 4 tile of S and 4 rows x D/16 columns of O;
//   * the KV loop stops at the causal diagonal, the tile-level skip of the
//     reference.
// No tensor cores (wgmma / mma.sync), no TMA, no cp.async pipelining: its
// ceiling is the fp32 CUDA-core rate (67 TFLOP/s), far below the bf16
// bound.  Those are later work; the times beside the bound are in PERF.md.
//
// Takes fp32 and bf16, D in {64, 128, 256}, Sq and Skv multiples of 64;
// the Python wrapper rejects anything else before launching.  `_route`
// sends it fp32 at head_dim 256 only: the tensor-core kernels take the
// rest (flash_attention_fwd_sm90.cu in bf16 and
// flash_attention_fwd_tf32x3.cu in fp32 at D 64 and 128,
// flash_attention_fwd_sm90_d256.cu in bf16 at D 256), and chip_smoke.py
// launches this one there directly, to time it beside them on the same
// inputs.

#include <cstddef>

#include "flash_attention_common.cuh"

namespace {

using flash::from_float;
using flash::kNegInf;
using flash::kThreads;
using flash::to_float;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

template <int D>
constexpr size_t smem_bytes() {
  // sQ (BQ x D+1), sK (BK x D+1), sV (BK x D), sP (BQ x BK+1), all fp32.
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int q_len, int kv_len,
                     int heads, int kv_heads, float scale, int causal) {
  constexpr int kDP = D + 1;        // padded row stride of sQ and sK
  constexpr int kPP = kBlockK + 1;  // padded row stride of sP
  constexpr int kCols = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * kDP;
  float* sV = sK + kBlockK * kDP;
  float* sP = sV + kBlockK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * D;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * D;
  const T* qb = q + (static_cast<size_t>(b) * q_len + q0) * q_stride +
                static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * kv_len * kv_stride +
                static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * kv_len * kv_stride +
                static_cast<size_t>(kvh) * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sQ[r * kDP + d] = to_float(qb[r * q_stride + d]);
  }

  // Rows ty + 16*i (i < 4) of the q tile belong to this thread; their
  // softmax statistics are replicated over the 16 threads of a row group.
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  // Causal: KV tiles wholly above the diagonal contribute nothing.
  const int kv_end =
      causal ? (kv_len < q0 + kBlockQ ? kv_len : q0 + kBlockQ) : kv_len;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done (and sQ set)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const size_t g = static_cast<size_t>(k0 + r) * kv_stride + d;
      sK[r * kDP + d] = to_float(kb[g]);
      sV[r * D + d] = to_float(vb[g]);
    }
    __syncthreads();

    // S tile: this thread's rows ty + 16*i, columns tx + 16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * kDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * kDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // Online softmax, row by row; reductions over the 16 lanes that
    // share a row (a half warp: lanes differ only in tx).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx + 16 * j > q_pos) x = kNegInf;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        sP[(ty + 16 * i) * kPP + tx + 16 * j] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // O += P.V: this thread's rows ty + 16*i, columns tx + 16*j.
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = sV[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* ob = out + (static_cast<size_t>(b) * q_len + q0 + r) * q_stride +
            static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      ob[tx + 16 * j] = from_float<T>(acc[i][j] / li);
    if (tx == 0)
      lse[(static_cast<size_t>(b) * heads + h) * q_len + q0 + r] =
          m[i] + logf(li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int q_len, int kv_len, int heads,
                   int kv_heads, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB, dynamic shared memory has to be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(q_len / kBlockQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), q_len, kv_len, heads, kv_heads, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k,
                       const void* v, void* out, void* lse, int batch,
                       int q_len, int kv_len, int heads, int kv_heads,
                       float scale, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, q_len, kv_len, heads,
                           kv_heads, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, q_len, kv_len, heads,
                            kv_heads, scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, batch, q_len, kv_len, heads,
                            kv_heads, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int batch, int q_len, int kv_len,
                                   int heads, int kv_heads, int head_dim,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  if (batch <= 0 || q_len <= 0 || kv_len <= 0 || heads <= 0 ||
      kv_heads <= 0 || heads % kv_heads != 0 || q_len % kBlockQ != 0 ||
      kv_len % kBlockK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dim<float>(head_dim, q, k, v, out, lse, batch, q_len,
                            kv_len, heads, kv_heads, scale, causal, s);
  else if (dtype == 1)
    err = launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, lse, batch,
                                    q_len, kv_len, heads, kv_heads, scale,
                                    causal, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
