// Flash-attention forward with logsumexp in fp32 on Hopper's tensor cores
// (sm_90a), at head_dim 256, bound to PyTorch through a plain C entry
// point (ctypes), launched by `flash_attention_fwd_lse` in
// ant_ray_tpu_torch/ops/flash_attention.py for the inputs that `_route`
// sends to its "tf32x3_d256" route (the 3xTF32 product, cp.async and the
// fragment loads are in flash_attention_tf32x3.cuh).
//
// Replaces the TPU kernel `_kernel` of
// ant_ray_tpu/ops/pallas/flash_attention.py (lines 56-111) for fp32 at
// head_dim 256.  It computes the same function as
// flash_attention_fwd_tf32x3.cu does at head_dim 64 and 128 (and the
// CUDA-core kernel of flash_attention_fwd.cu, on no route):
//   q (B, Sq, H, D), k/v (B, Skv, KVH, D)  ->  out (B, Sq, H, D) and
//   lse (B, H, Sq), both fp32; online softmax over KV tiles with fp32
//   accumulators, KV head = h / (H / KVH) (GQA), top-left causal alignment
//   (a score is masked when k_pos > q_pos), NEG_INF = -1e30 rather than
//   -inf, l == 0 -> 1, lse = m + log(l), p rounded to the input type
//   before P.V (the reference's `p.astype(v.dtype)`, a no-op in fp32 kept
//   for the reader).  Every tensor fp32 and 16-byte aligned (the wrapper
//   checks); lengths multiples of 64 (the wrapper rejects anything else
//   and the entry point returns cudaErrorInvalidValue for it).
//
// What bounds it.  At the fp32 head_dim-256 Llama's attention (B=2,
// S=2048, H=8, KVH=1, causal) it does 4*D FLOPs per (q, k) pair (S =
// Q.K^T and P.V), 34.4 GFLOP, against ~0.07 GB of traffic: bound by
// operations, 0.208 ms at 3xTF32's 494.7 / 3 = 165 TFLOP/s (0.513 ms at
// the CUDA cores' 67 TFLOP/s of fp32 FMAs, the ceiling of
// flash_attention_fwd.cu).
//
// Why the head_dim 64/128 design does not simply take D = 256.  There a
// warp owns 16 rows of O at every column: at D = 256 that is a 16 x 256
// fp32 accumulator, 128 registers a thread before S.  And a padded fp32
// row is 1040 bytes, so a 64-row Q tile and two stages of 32-row K and V
// take 199,680 bytes of the 232,448 a block may use.
//
// The design (the one flash_attention_bwd_tf32x3_d256.cu proved at this
// width, shaped for the forward):
//   * 8 warps.  Warp w owns row slice r = w % 2 of the block's q tile
//     and column quarter c = w / 2: columns [64c, 64c + 64) of O, 32
//     accumulator registers a thread per m16 tile of rows.
//   * Partial scores.  Per 32-row K/V stage, warp (r, c) computes S =
//     Q.K^T for its rows and all 32 of the stage's keys, but over its
//     quarter of D only.  The four warps of a row slice add their
//     partials through shared memory in quarter order, so all four hold
//     bit-identical S, and so identical m, l, corr and P, with no
//     broadcast.  Each then does O[:, its 64] = O * corr + P.V[:, its 64],
//     with P taken straight from the accumulators (a_from_acc, permuted
//     k) and V read in the same permuted order (load_b_mnmajor_permuted).
//   * Every product is mma.sync.m16n8k8 issued three times (mma_3xtf32):
//     wgmma's tf32 form takes only K-major operands from shared memory,
//     and P.V reads V MN-major.  A single TF32 product is never used.
//     Operands split into TF32 hi and lo on the integer pipe (the
//     header's split: cvt.rna's products, a NaN kept).
//   * Q stays in shared memory; K and V stream in 32-row stages through
//     two cp.async buffers, the next loading while this one is used.
//     KV tiles are walked from key 0 upward and stop at the causal
//     diagonal, so every row's first tile holds key 0, which no causal
//     mask hides: m is a real score after the first tile.
//   * Two barriers a stage: the top one (the stage landed; every warp is
//     done with the previous stage and its partials) comes before the
//     next stage's copies are issued into the buffer the previous stage
//     used, and the second lets the partials be read.
//   * Two tile heights, one template (kM m16 tiles of rows a warp):
//     kM = 1, a 32-row q tile (Q 33,280 bytes, two K+V stages 133,120,
//     partials 16,384: 182,784 bytes); kM = 2, a 64-row q tile (66,560 +
//     133,120 + 32,768 = 232,448 bytes, all a block may use), where each
//     K or V fragment, loaded and split once, feeds two products, as the
//     head_dim-64 forward's two m16 tiles a warp do.  Either way one
//     block an SM.  The launch takes kM = 2 where its grid fills at least
//     two waves of the card's SMs, else kM = 1: at the d256 fp32 path's
//     attention (B=2 S=2048 H=8) 512 blocks of 64 rows; at B=1 S=512 H=8
//     64 blocks of 64 rows would leave half of 132 SMs idle, and kM = 1
//     gives 128.  Each height alone, on an H100 80GB HBM3 at 700 W
//     (tools/kernel_ab.py, A B B A): at the path's attention kM = 2
//     0.885-0.889 ms, kM = 1 1.136-1.139; at B=1 S=512 kM = 1
//     0.099-0.102 ms, kM = 2 0.128.  ptxas: 121 registers a thread at
//     kM = 1, 182 at kM = 2, no spill.
//   * One block per (q tile, head, batch), the q tile the slowest grid
//     index, heaviest (last) q tiles first.
//   * Shared-memory rows are padded to 260 floats: fragment loads in
//     either orientation hit 32 distinct banks (see the header).
//   * At the end a thread writes its rows' out as 8-byte pairs (the quad
//     of a row fills whole 32-byte sectors), and one thread per row of
//     quarter 0 its lse.
//
// Measured (chip_smoke.py, an H100 80GB HBM3 at 700 W): at the d256 fp32
// path's attention 0.885 ms, 23.6 % of its 3xTF32 bound and 58.0 % of
// the fp32-FMA one, against the CUDA-core kernel's 2.132 ms and SDPA's
// fp32 forward 1.105 ms on the same inputs; at B=1 S=512 H=8 KVH=2 0.093
// ms (7.0 % / 17.3 %) against 0.213 and 0.094.

#include <cstddef>
#include <cstdint>

#include "flash_attention_common.cuh"
#include "flash_attention_tf32x3.cuh"

namespace {

using flash::kNegInf;
using flash::round_to;
using namespace tf32x3;  // NOLINT(build/namespaces)

constexpr int kD = 256;
constexpr int kP = kD + kPad;        // floats a padded shared-memory row
constexpr int kBlock = 256;          // threads: 8 warps
constexpr int kKV = 32;              // rows of a K or V stage
constexpr int kTile = kKV * kP;      // floats of one 32-row tile
constexpr int kLengthMultiple = 64;
constexpr size_t kMaxSmem = 232448;  // what a block may use on sm_90

// Rows of the block's q tile: two row slices of kM m16 tiles.
template <int kM>
__host__ __device__ constexpr int q_rows() {
  return 32 * kM;
}

// Q, two stages of K and V, and each warp's partial scores (kM x 4
// float4 a thread).
template <int kM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (q_rows<kM>() * kP + 4 * kTile) +
         sizeof(float4) * kM * 4 * kBlock;
}
static_assert(smem_bytes<1>() == 182784, "32-row layout");
static_assert(smem_bytes<2>() <= kMaxSmem,
              "64-row layout over the shared memory a block may use");

template <int kM>
__global__ void __launch_bounds__(kBlock, 1)
    flash_fwd_tf32x3_d256_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out,
                                 float* __restrict__ lse, int q_len,
                                 int kv_len, int heads, int kv_heads,
                                 float scale, int causal) {
  constexpr int kBQ = q_rows<kM>();
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * kP;  // stage s: K at 2 s kTile, V after it
  float4* part = reinterpret_cast<float4*>(sKV + 4 * kTile);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp & 1, c = warp >> 1;  // row slice, column quarter
  const int m0 = 16 * kM * r;             // the slice's first q-tile row
  const int d0 = 64 * c;                  // the warp's first column
  const int h = blockIdx.x, b = blockIdx.y;
  // Heaviest first: under a causal mask the last q tiles see most.
  const int q0 = (q_len / kBQ - 1 - static_cast<int>(blockIdx.z)) * kBQ;
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * kD;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * kD;
  const size_t q_off = (static_cast<size_t>(b) * q_len + q0) * q_stride +
                       static_cast<size_t>(h) * kD;
  const float* kb = k + static_cast<size_t>(b) * kv_len * kv_stride +
                    static_cast<size_t>(kvh) * kD;
  const float* vb = v + static_cast<size_t>(b) * kv_len * kv_stride +
                    static_cast<size_t>(kvh) * kD;

  // Causal: K/V stages wholly after the q tile's last row contribute
  // nothing (the first stage always counts: q0 >= 0, kv_len >= 64).
  const int kv_end =
      causal ? (kv_len < q0 + kBQ ? kv_len : q0 + kBQ) : kv_len;
  const int n_tiles = kv_end / kKV;

  auto load_kv = [&](int tile) {
    float* sK = sKV + (tile & 1) * 2 * kTile;
    const size_t off = static_cast<size_t>(tile) * kKV * kv_stride;
    copy_tile<kKV, kD, kBlock>(sK, kb + off, kv_stride);
    copy_tile<kKV, kD, kBlock>(sK + kTile, vb + off, kv_stride);
  };
  copy_tile<kBQ, kD, kBlock>(sQ, q + q_off, q_stride);
  load_kv(0);
  cp_async_commit();

  // This thread's rows: m0 + 16 i + g (rr = 0) and m0 + 16 i + g + 8
  // (rr = 1) of m16 tile i, indexed j = 2 i + rr below.  m is the same
  // across a row's quad (and across the slice's four warps); l is this
  // thread's share of the row sum.
  const int q_pos0 = q0 + m0 + g;
  float m[2 * kM], l[2 * kM];
  float acc[kM][8][4];  // O: rows of tile i, columns d0 + 8 n ..
#pragma unroll
  for (int j = 0; j < 2 * kM; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    // Stage it (and Q) landed for every thread; every warp is done with
    // stage it - 1, whose buffer the next copies fill, and its partials.
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_async_commit();
    }
    const float* sK = sKV + (it & 1) * 2 * kTile;
    const float* sV = sK + kTile;
    const int k0 = it * kKV;

    // S = Q.K^T over this warp's quarter of D: partial sums.
    float s[kM][4][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < 8; ++kk) {
      const int kc = d0 + 8 * kk;
      Split<4> qa[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i)
        qa[i] = load_a<kP>(sQ, m0 + 16 * i, kc, g, t);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const Split<2> kf = load_b_kmajor<kP>(sK, 8 * n, kc, g, t);
#pragma unroll
        for (int i = 0; i < kM; ++i) mma_3xtf32(s[i][n], qa[i], kf);
      }
    }

    // The slice's whole S: every warp of it adds the four quarters in
    // quarter order, its own among them, so all four get the same sums.
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        part[((warp * kM + i) * 4 + n) * 32 + lane] =
            make_float4(s[i][n][0], s[i][n][1], s[i][n][2], s[i][n][3]);
    __syncthreads();  // the slice's four quarters are in
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
    for (int quarter = 0; quarter < 4; ++quarter) {
      const int from = (quarter << 1) | r;
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float4 x = part[((from * kM + i) * 4 + n) * 32 + lane];
          s[i][n][0] += x.x, s[i][n][1] += x.y, s[i][n][2] += x.z,
              s[i][n][3] += x.w;
        }
    }

    // Scale, mask and the row max of this stage.
    float row_max[2 * kM];
#pragma unroll
    for (int j = 0; j < 2 * kM; ++j) row_max[j] = kNegInf;
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
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
      row_max[j] =
          fmaxf(row_max[j], __shfl_xor_sync(0xffffffffu, row_max[j], 1));
      row_max[j] =
          fmaxf(row_max[j], __shfl_xor_sync(0xffffffffu, row_max[j], 2));
      const float m_new = fmaxf(m[j], row_max[j]);
      corr[j] = expf(m[j] - m_new);
      m[j] = m_new;
      l[j] *= corr[j];
    }

    // p = exp(s - m), rounded to the input type before P.V; it replaces
    // S in place.
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * i + (e >> 1);
          const float p = expf(s[i][n][e] - m[j]);
          l[j] += p;
          s[i][n][e] = round_to<float>(p);
        }

    // O = O * corr + P.V: k runs over the stage's 32 KV rows, permuted;
    // n over this warp's 64 columns.
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= corr[2 * i + (e >> 1)];
#pragma unroll
    for (int kk = 0; kk < kKV / 8; ++kk) {
      Split<4> pa[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) pa[i] = a_from_acc(s[i][kk]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const Split<2> vf =
            load_b_mnmajor_permuted<kP>(sV, 8 * kk, d0 + 8 * n, g, t);
#pragma unroll
        for (int i = 0; i < kM; ++i) mma_3xtf32(acc[i][n], pa[i], vf);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2 * kM; ++j) {
    const int i = j >> 1, rr = j & 1;
    float row_sum = l[j];
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    const float li = row_sum == 0.f ? 1.f : row_sum;
    const int row = m0 + g + 8 * j;
    float* o = out + q_off + row * q_stride + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[i][n][2 * rr] / li, acc[i][n][2 * rr + 1] / li);
    if (c == 0 && t == 0)
      lse[(static_cast<size_t>(b) * heads + h) * q_len + q0 + row] =
          m[j] + logf(li);
  }
}

template <int kM>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, int batch, int q_len, int kv_len,
                   int heads, int kv_heads, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kM>();
  // Above 48 KB, dynamic shared memory has to be asked for explicitly.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_d256_kernel<kM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch, q_len / q_rows<kM>());
  flash_fwd_tf32x3_d256_kernel<kM><<<grid, kBlock, smem, stream>>>(
      q, k, v, out, lse, q_len, kv_len, heads, kv_heads, scale, causal);
  return cudaGetLastError();
}

// m16 tiles of rows a warp: 2 (64-row q tiles) where that grid fills at
// least two waves of the current device's SMs, else 1 (32-row tiles).
cudaError_t m_tiles(int batch, int q_len, int heads, int* km) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long blocks = static_cast<long>(batch) * heads * (q_len / 64);
  *km = blocks >= 2L * sms ? 2 : 1;
  return cudaSuccess;
}

}  // namespace

// dtype must be 0 (float32) and head_dim 256: the same signature as
// flash_attention_fwd.  Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd_tf32x3_d256(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int q_len, int kv_len, int heads, int kv_heads, int head_dim,
    int dtype, float scale, int causal, void* stream) {
  if (dtype != 0 || head_dim != kD || batch <= 0 || q_len <= 0 ||
      kv_len <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      q_len % kLengthMultiple != 0 || kv_len % kLengthMultiple != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int km;
  cudaError_t err = m_tiles(batch, q_len, heads, &km);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = km == 2 ? launch<2>(qf, kf, vf, of, lf, batch, q_len, kv_len, heads,
                            kv_heads, scale, causal, s)
                : launch<1>(qf, kf, vf, of, lf, batch, q_len, kv_len, heads,
                            kv_heads, scale, causal, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
