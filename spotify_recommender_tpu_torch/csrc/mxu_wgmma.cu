// TPU kernel 10, `mxu_only`, on the H100's tensor cores.
//
// Replaces `_mxu_kernel` / `mxu_only` (experiments/kernel_r3.py:53, :78),
// the round-3 compute floor probe: for q (B, qw) bf16 and the catalog
// planes ft (>= qw rows, Np columns, Np a multiple of 128) bf16, out (B, 128)
// f32 holds, per query b and lane l, the max over the columns c with
// c mod 128 == l of sum_r q[b, r] * ft[r, c].  The TPU ran one bf16
// `dot_general` into fp32 on the MXU per (query tile, catalog tile), then a
// max per lane; this runs the same dot on `wgmma`.
//
// What bounds it on an H100, at 1024 x 1M and qw = 48: the MMA, 2 * B * Np
// * qw = 0.10 T operations, 0.102 ms at 989 TFLOP/s bf16; the epilogue, one
// fmax per (query, column), 1.07e9 on the CUDA cores, ~0.07 ms at 64 a clock
// per SM; the bytes, the 100 MB catalog read once, 0.03 ms.  Design:
//
// - a block takes 128 queries, two consumer warpgroups of 64, and walks one
//   slice of the catalog in tiles of 128 columns.  Its producer warp keeps
//   a ring of kStages tiles in flight with TMA: a 2-D tensor map over ft (qw
//   rows, Np columns, the row stride of ft), boxes of 64 columns (128 bytes,
//   the swizzle's span) by K rows, 128-byte swizzle; each stage has a full
//   mbarrier (the producer's expected bytes) and an empty one (every
//   consumer thread arrives once it is done with the stage);
// - each consumer warpgroup runs wgmma m64n128k16, bf16 x bf16 into fp32, K
//   = qw rounded up to 16 (3 steps at qw = 48).  A, the warpgroup's 64
//   queries, stays in registers for the whole walk (4 per k step, zero past
//   qw and past B): every tile meets the same A, so it costs no shared
//   memory reads.  B, the tile, is read from shared memory as an MN-major
//   operand (ft's columns are contiguous: the transpose bit), so the
//   catalog is never transposed or padded in memory; the rows past qw are
//   TMA's out-of-bounds zeros, and a zero product changes no sum;
// - a tile is exactly the 128 lanes, so each accumulator register holds one
//   fixed (query, lane) in every tile and folds into that lane's running max
//   with one fmax; the maxima are written once, at the end.  While one
//   warpgroup folds, the other's wgmma runs: the epilogue overlaps the MMA;
// - the grid is (query blocks x catalog slices), the query blocks of a
//   slice adjacent in launch order, so that they read its tiles from L2 at
//   about the same time (the wrapper sizes the slices to fill the card,
//   ops/cuda/proto_scans.py).  `max_merge` then takes the max over the
//   slices: exact, so the result does not depend on the split.  Np is a
//   multiple of 128 and a slice a multiple of 128, so no tile is partial.
//
// The sum is the tensor cores' own, not the plain version's sequential
// round-to-nearest fp32 sum, so the two are held within a bound derived
// for any fp32 accumulation that rounds each addition once, qw * 2^-22 * S
// (S the lane's largest sum of |products|; ops/cuda/proto_scans.
// mxu_only_tolerance), not bitwise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#if CUDART_VERSION < 12050
#error "mxu_wgmma.cu needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif

namespace {

constexpr int kLanes = 128;         // output lanes, column mod 128: a tile
constexpr int kBoxCols = 64;        // columns of one TMA box
constexpr int kRowBytes = kBoxCols * 2;   // 128: one swizzled row
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kConsumerThreads = kConsumers * kWarpgroup;
constexpr int kThreads = kConsumerThreads + 32;   // + one producer warp
constexpr int kBlockQueries = 64 * kConsumers;
constexpr int kMaxSteps = 4;        // k steps of 16: qw <= 64
constexpr int kStages = 8;
constexpr int kSwizzle = 1024;      // the 128-byte swizzle's period
constexpr int kMergeThreads = 256;
constexpr int64_t kMaxSlices = 65535;

int err_invalid() { return static_cast<int>(cudaErrorInvalidValue); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of the tensor map at (column, row) into shared memory; its bytes
// complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// The shared-memory descriptor of an MN-major operand in 128-byte swizzle:
// start address, leading byte offset (between 64-column boxes along N),
// stride byte offset (between 8-row groups along K: 8 rows of 128 bytes),
// layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(((8 * kRowBytes) >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

// Keeps the compiler from moving accumulator reads across the wgmma's
// asynchronous writes.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (+)= A * B: m64n128k16, A (64 x 16 bf16) in registers, B (16 x 128
// bf16) MN-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
#define SRT_D4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SRT_D4(0), SRT_D4(4), SRT_D4(8), SRT_D4(12), SRT_D4(16), SRT_D4(20),
        SRT_D4(24), SRT_D4(28), SRT_D4(32), SRT_D4(36), SRT_D4(40),
        SRT_D4(44), SRT_D4(48), SRT_D4(52), SRT_D4(56), SRT_D4(60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
#undef SRT_D4
}

// Two bf16 of row r of q at columns k, k+1 (zero past qw and past b), low
// half first: the A fragment's layout.
__device__ __forceinline__ uint32_t q_pair(const uint16_t* __restrict__ q,
                                           int64_t b, int qw, int64_t r,
                                           int k) {
  uint32_t lo = 0, hi = 0;
  if (r < b) {
    if (k < qw) lo = q[r * qw + k];
    if (k + 1 < qw) hi = q[r * qw + k + 1];
  }
  return lo | hi << 16;
}

// Per (query, lane) the max of the dots of the slice's columns in that
// lane, to part[(slice * b + query) * 128 + lane].  KS: k steps of 16.
template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
    mxu_wgmma_kernel(const __grid_constant__ CUtensorMap ft_map,
                     const __nv_bfloat16* __restrict__ q, int64_t b, int qw,
                     int64_t np, int64_t slice, float* __restrict__ part) {
  constexpr uint32_t kBoxBytes = KS * 16 * kRowBytes;
  constexpr uint32_t kStageBytes = 2 * kBoxBytes;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  extern __shared__ __align__(16) unsigned char smem[];
  // the ring, aligned to the swizzle's period (the wrapper adds the slack)
  const uint32_t ring = (smem_u32(smem) + kSwizzle - 1) & ~(kSwizzle - 1u);

  const int tid = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * slice;
  const int64_t c1 = np - c0 < slice ? np : c0 + slice;
  const int ntiles = static_cast<int>((c1 - c0) / kLanes);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // the producer warp: one lane issues every load
    if (tid != kConsumerThreads) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ntiles; ++t) {
      mbar_wait(&empty[stage], phase ^ 1);   // the first pass finds it free
      mbar_expect_tx(&full[stage], kStageBytes);
      const uint32_t dst = ring + stage * kStageBytes;
      const int col = static_cast<int>(c0 + static_cast<int64_t>(t) * kLanes);
      tma_load(dst, &ft_map, &full[stage], col, 0);
      tma_load(dst + kBoxBytes, &ft_map, &full[stage], col + kBoxCols, 0);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: rows r0 and r0 + 8 of its 64 queries
  const int g = tid / kWarpgroup;
  const int warp = (tid % kWarpgroup) / 32;
  const int lane = tid % 32;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBlockQueries +
                     g * 64 + warp * 16 + lane / 4;
  const int64_t r1 = r0 + 8;
  const int kc = 2 * (lane % 4);
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q);
  uint32_t a[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    a[s][0] = q_pair(qb, b, qw, r0, 16 * s + kc);
    a[s][1] = q_pair(qb, b, qw, r1, 16 * s + kc);
    a[s][2] = q_pair(qb, b, qw, r0, 16 * s + 8 + kc);
    a[s][3] = q_pair(qb, b, qw, r1, 16 * s + 8 + kc);
  }
  // d[4j + e]: row r0 (e < 2) or r1, column 8j + kc + (e & 1) of the tile
  float d[64], m[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d[i] = 0.0f;
    m[i] = -INFINITY;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&full[stage], phase);
    const uint32_t base = ring + stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(d[i]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_m64n128k16(d, a[s], mn_major_desc(base + s * 16 * kRowBytes,
                                              kBoxBytes),
                       s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(d[i]);
    mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < 64; ++i) m[i] = fmaxf(m[i], d[i]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  float* out = part + static_cast<int64_t>(blockIdx.y) * b * kLanes;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + kc;
    if (r0 < b)
      *reinterpret_cast<float2*>(out + r0 * kLanes + col) =
          make_float2(m[4 * j], m[4 * j + 1]);
    if (r1 < b)
      *reinterpret_cast<float2*>(out + r1 * kLanes + col) =
          make_float2(m[4 * j + 2], m[4 * j + 3]);
  }
}

// out[i] = the max over the slices of part[s * n + i].
__global__ void max_merge(const float* __restrict__ part, int64_t slices,
                          int64_t n, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kMergeThreads +
                    threadIdx.x;
  if (i >= n) return;
  float m = part[i];
  for (int64_t s = 1; s < slices; ++s) m = fmaxf(m, part[s * n + i]);
  out[i] = m;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// -lcuda); nullptr where libcuda has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(entry)
               : nullptr;
  }();
  return fn;
}

template <int KS>
int launch(const CUtensorMap& map, const void* q, int64_t b, int qw,
           int64_t np, int64_t slice, int64_t slices, float* dst,
           cudaStream_t s) {
  const int smem = kStages * 2 * KS * 16 * kRowBytes + kSwizzle;
  cudaError_t e = cudaFuncSetAttribute(
      mxu_wgmma_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((b + kBlockQueries - 1) / kBlockQueries),
                  static_cast<unsigned>(slices));
  mxu_wgmma_kernel<KS><<<grid, kThreads, smem, s>>>(
      map, static_cast<const __nv_bfloat16*>(q), b, qw, np, slice, dst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, qw) bf16 contiguous, 1 <= qw <= 64; ft (>= qw rows, row stride
// ft_stride elements, a multiple of 8; 16-byte aligned) bf16 with np
// columns (a multiple of 128); slice: columns per catalog slice (a multiple
// of 128); part (ceil(np / slice), b, 128) f32 scratch, unused (may be
// null) with one slice; out (b, 128) f32.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for inputs it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int srt_mxu_only(const void* q, int64_t b, int qw, const void* ft,
                            int64_t ft_stride, int64_t np, int64_t slice,
                            void* part, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (qw < 1 || qw > 16 * kMaxSteps || np < kLanes || np % kLanes ||
      np >= INT_MAX || slice < kLanes || slice % kLanes || ft_stride < np ||
      ft_stride % 8 || reinterpret_cast<uintptr_t>(ft) % 16)
    return err_invalid();
  const int64_t slices = (np + slice - 1) / slice;
  if (slices > kMaxSlices || (slices > 1 && part == nullptr))
    return err_invalid();
  const int steps = (qw + 15) / 16;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(np),
                              static_cast<cuuint64_t>(qw)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ft_stride) * 2};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(16 * steps)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ft),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return err_invalid();
  float* dst = static_cast<float*>(slices > 1 ? part : out);
  int err;
  switch (steps) {
    case 1: err = launch<1>(map, q, b, qw, np, slice, slices, dst, s); break;
    case 2: err = launch<2>(map, q, b, qw, np, slice, slices, dst, s); break;
    case 3: err = launch<3>(map, q, b, qw, np, slice, slices, dst, s); break;
    default: err = launch<4>(map, q, b, qw, np, slice, slices, dst, s); break;
  }
  if (err != 0 || slices == 1) return err;
  const int64_t n = b * kLanes;
  max_merge<<<static_cast<unsigned>((n + kMergeThreads - 1) / kMergeThreads),
              kMergeThreads, 0, s>>>(static_cast<const float*>(part), slices,
                                     n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
