// Building blocks of the flash-attention kernels on Hopper's tensor cores
// (sm_90a), shared by flash_attention_{fwd,bwd}_sm90.cu and
// flash_attention_{fwd,bwd}_sm90_d256.cu: PTX wrappers for mbarriers,
// TMA and warpgroup MMA (wgmma), the descriptors of 128-byte-swizzled
// tiles in shared memory, and the 4-D TMA tensor maps of a (B, S, NH, D)
// bf16 tensor.
//
// Tile layout.  A tile of R rows and D columns is stored as D/64 blocks of
// R rows of 128 bytes, 16-byte chunk c of row r at chunk c ^ (r % 8): the
// 128-byte swizzle that TMA writes and wgmma descriptors read.  A block
// aligns its shared memory to 1024 bytes (one swizzle atom of 8 rows).
//
// Accumulator layout of a 64 x N wgmma (fp32, N/2 registers a thread):
// element 4j + e of thread t lies at row 16 * (t % 128 / 32) + (t % 32) / 4
// + 8 * (e / 2) and column 8j + 2 * (t % 4) + e % 2.  Rounded to bf16 and
// packed in pairs (pack_bf16(d[2i], d[2i + 1])), registers 4kk .. 4kk + 3
// are the register A operand of k-step kk of a following wgmma: a product
// P.B or dS.B takes P or dS straight from the registers that computed it.
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace flash_sm90 {

using bf16 = __nv_bfloat16;

constexpr int kLengthMultiple = 64;
constexpr int kThreadsSm90 = 256;  // two warpgroups
constexpr int kWgRows = 64;        // rows a warpgroup owns (wgmma's M)
constexpr int kTileRows = 128;     // a block's own tile: two warpgroups
constexpr int kRingRows = 64;      // the tiles that stream through a ring
constexpr int kAlignSlack = 1024;  // kernels align their base to 1024
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

// Descriptor of k-step kk (16 rows) of an R-row tile read MN-major: its
// rows are the k dimension, its D columns the N dimension (64-column
// blocks R * 128 bytes apart).
template <int R = kRingRows>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, R * 128, 1024);
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

// ------------------------------------------------------------ tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; it is fetched through the
// runtime, so the library links no libcuda and stays a plain C library.
inline cudaError_t encode_tiled(EncodeTiled* fn) {
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
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch,
                            int len, int nheads, int head_dim, int rows) {
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

// True when every address lies on a 16-byte boundary and the shape is one
// the sm90 kernels take: bf16 (dtype 1), positive sizes, heads a multiple
// of kv_heads, lengths multiples of kLengthMultiple.  head_dim is checked
// by each entry point's dispatch.
inline bool shape_ok(uintptr_t addr_bits, int dtype, int batch, int q_len,
                     int kv_len, int heads, int kv_heads) {
  return dtype == 1 && (addr_bits & 15) == 0 && batch > 0 && q_len > 0 &&
         kv_len > 0 && heads > 0 && kv_heads > 0 && heads % kv_heads == 0 &&
         q_len % kLengthMultiple == 0 && kv_len % kLengthMultiple == 0;
}

// One forward launch (flash_attention_fwd_sm90.cu and
// flash_attention_fwd_sm90_d256.cu): its pointers and sizes.
struct FwdArgs {
  const void *q, *k, *v;
  void *out, *lse;
  int batch, q_len, kv_len, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

// shape_ok for a forward launch, over all five of its pointers.
inline bool fwd_shape_ok(const FwdArgs& a, int dtype) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out) |
      reinterpret_cast<uintptr_t>(a.lse);
  return shape_ok(addr_bits, dtype, a.batch, a.q_len, a.kv_len, a.heads,
                  a.kv_heads);
}

// Maps of a forward launch's q (kTileRows-row boxes), k and v
// (kRingRows-row boxes).
inline cudaError_t make_fwd_maps(const FwdArgs& a, int head_dim,
                                 CUtensorMap (&maps)[3]) {
  cudaError_t err;
  if ((err = make_map(&maps[0], a.q, a.batch, a.q_len, a.heads, head_dim,
                      kTileRows)) != cudaSuccess ||
      (err = make_map(&maps[1], a.k, a.batch, a.kv_len, a.kv_heads, head_dim,
                      kRingRows)) != cudaSuccess ||
      (err = make_map(&maps[2], a.v, a.batch, a.kv_len, a.kv_heads, head_dim,
                      kRingRows)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

// One backward launch (flash_attention_bwd_sm90.cu and
// flash_attention_bwd_sm90_d256.cu): its pointers and sizes.
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int batch, q_len, kv_len, heads, kv_heads;
  float scale;
  int causal;
  cudaStream_t stream;
};

// shape_ok for a backward launch, over all eight of its pointers.
inline bool bwd_shape_ok(const BwdArgs& a, int dtype) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
      reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
      reinterpret_cast<uintptr_t>(a.lse) |
      reinterpret_cast<uintptr_t>(a.delta) |
      reinterpret_cast<uintptr_t>(a.out0) | reinterpret_cast<uintptr_t>(a.out1);
  return shape_ok(addr_bits, dtype, a.batch, a.q_len, a.kv_len, a.heads,
                  a.kv_heads);
}

// Maps of a backward launch's q, k, v and dO with `q_rows`-row boxes for q
// and dO and `kv_rows`-row boxes for k and v.
inline cudaError_t make_bwd_maps(const BwdArgs& a, int head_dim, int q_rows,
                                 int kv_rows, CUtensorMap (&maps)[4]) {
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

// Calls launch(std::integral_constant<int, D>{}) for head_dim 64 or 128;
// anything else is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch_head_dim(int head_dim, F&& launch) {
  if (head_dim == 64) return launch(std::integral_constant<int, 64>{});
  if (head_dim == 128) return launch(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

}  // namespace flash_sm90
