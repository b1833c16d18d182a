// Epilogue-free bf16x2 bin scan (v3) of the certified exact tier.
//
// Replaces the TPU kernel `_scan_kernel_v3` / `_scan_call_v3`
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:1069, :1230).
//
// What it computes, for every query q of a batch of unit queries against a
// prenormalized split-plane catalog:
//
//   dot(q, col) = sum_f qh*hi + ql*lo + ql*hi + qh*lo      (4F fp32 FMAs of
//                 exact bf16 x bf16 products, in a fixed order)
//   bin(col)    = col mod 128                               (W = 128)
//   each bin keeps its top-DEPTH (value, column) with strict `>`, so the
//   lowest column wins ties, plus the largest value evicted past DEPTH (the
//   (DEPTH+1)-th best: the coverage bound);
//   out: the top-`topc` of the DEPTH*128 slots (slot = level*128 + bin) by
//   value descending, slot ascending, and the max bound over the bins.
//
// This reproduces the TPU kernel's candidate structure exactly: with W = 128
// the TPU's bin of a global column is `col mod 128` (fused_topk.py:1171-1174).
// The BF16X2_EPS derivation (48 rounded fp32 additions, Cauchy-Schwarz)
// holds for any order of the additions, and each FMA here rounds once after
// an exact product, so the certificate's bound carries over.
//
// Catalog layout: the TPU's transposed (rows, Np) bf16 planes, of which the
// kernel reads rows [0, 2F) = [hi; lo] (a 4-plane [hi; lo; hi; lo] layout
// works unchanged).  Queries: (B, 4F) bf16 [qh, ql, ql, qh], of which the
// kernel reads [qh, ql].  Pad columns are zero vectors and score 0, as on
// the TPU.
//
// What bounds it on an H100: fp32 FMA issue.  B x Np x 4F FMAs (1024 x 1M x
// 48 = 50 G FMAs at the benchmark shape) against 48 bytes per catalog column
// streamed once per block.  Design, right before fast:
//
// - one block of 128 threads takes a tile of TQ = 16 queries; thread t owns
//   bin t and walks its columns t, t+128, ... in ascending order, so the
//   strict-`>` insert keeps the lowest column, as the TPU's sequential grid
//   does;
// - per query, the thread keeps DEPTH (value, column) pairs and the bound in
//   registers (DEPTH is a template parameter: 2 for the main scan, 3 for the
//   escalation rescan);
// - catalog tiles of 2F x TC bf16 are staged once per block through shared
//   memory with 16-byte copies; the query tile sits in shared memory
//   transposed, so one feature's TQ values are read as float4 broadcasts;
// - at the end the block writes its bin structure to shared memory and each
//   warp extracts the top-topc of its queries by warp-wide argmax rounds
//   (value descending, slot ascending), as the TPU's masked-argmax rounds do.
//
// Known limit: B = 1024 gives 64 blocks for 132 SMs.  Splitting the catalog
// across blocks with a per-bin merge, and tensor cores (wgmma), are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBins = 128;       // W: one bin per thread
constexpr int kTileBytes = 24576;  // shared-memory budget of a catalog tile

template <int D>
__device__ __forceinline__ void bin_insert(float (&v)[D], int (&ix)[D],
                                           float& bnd, float s, int col) {
  // the value evicted past depth is min(s, v[D-1]): s when it lands below,
  // the old deepest when s inserts anywhere above (fused_topk.py:1178-1180)
  bnd = fmaxf(bnd, fminf(s, v[D - 1]));
  bool c[D];
#pragma unroll
  for (int l = 0; l < D; ++l) c[l] = s > v[l];
#pragma unroll
  for (int l = D - 1; l > 0; --l) {
    v[l] = c[l - 1] ? v[l - 1] : (c[l] ? s : v[l]);
    ix[l] = c[l - 1] ? ix[l - 1] : (c[l] ? col : ix[l]);
  }
  v[0] = c[0] ? s : v[0];
  ix[0] = c[0] ? col : ix[0];
}

// (a_val, a_slot) ranks before (b_val, b_slot): value descending, slot
// ascending
__device__ __forceinline__ bool ranks_before(float av, int as, float bv,
                                             int bs) {
  return av > bv || (av == bv && as < bs);
}

template <int TQ, int D>
__global__ void __launch_bounds__(kBins)
    scan_v3_kernel(const __nv_bfloat16* __restrict__ q2, int64_t b, int f,
                   const __nv_bfloat16* __restrict__ ft, int64_t ft_stride,
                   int64_t np, int tc, int topc, float* __restrict__ ov,
                   int32_t* __restrict__ oi, float* __restrict__ ob) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;

  // ---- scan phase: qs[2F][TQ] fp32 (qh rows, then ql rows), tile[2F][tc]
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(qs + 2 * f * TQ);
  for (int i = t; i < 2 * f * TQ; i += kBins) {
    const int j = i / TQ;
    const int q = i % TQ;
    qs[i] = (q0 + q < b) ? __bfloat162float(q2[(q0 + q) * 4 * f + j]) : 0.0f;
  }

  float v[TQ][D];
  int ix[TQ][D];
  float bnd[TQ];
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      v[q][l] = -INFINITY;
      ix[q][l] = -1;
    }
    bnd[q] = -INFINITY;
  }

  for (int64_t base = 0; base < np; base += tc) {
    const int w = static_cast<int>(np - base < tc ? np - base : tc);
    const int vec_per_row = w / 8;  // 8 bf16 per 16-byte copy
    __syncthreads();  // the previous tile is consumed; qs is written
    for (int i = t; i < 2 * f * vec_per_row; i += kBins) {
      const int r = i / vec_per_row;
      const int c = i % vec_per_row;
      reinterpret_cast<uint4*>(tile + static_cast<int64_t>(r) * tc)[c] =
          reinterpret_cast<const uint4*>(ft + r * ft_stride + base)[c];
    }
    __syncthreads();
    for (int cc = t; cc < w; cc += kBins) {
      float acc[TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) acc[q] = 0.0f;
      for (int j = 0; j < f; ++j) {
        const float h = __bfloat162float(tile[j * tc + cc]);
        const float l = __bfloat162float(tile[(f + j) * tc + cc]);
        const float4* qh4 = reinterpret_cast<const float4*>(qs + j * TQ);
        const float4* ql4 = reinterpret_cast<const float4*>(qs + (f + j) * TQ);
#pragma unroll
        for (int q4 = 0; q4 < TQ / 4; ++q4) {
          const float4 a = qh4[q4];
          const float4 e = ql4[q4];
          const float qh[4] = {a.x, a.y, a.z, a.w};
          const float ql[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float s = acc[4 * q4 + u];
            s = fmaf(qh[u], h, s);
            s = fmaf(ql[u], l, s);
            s = fmaf(ql[u], h, s);
            s = fmaf(qh[u], l, s);
            acc[4 * q4 + u] = s;
          }
        }
      }
      const int col = static_cast<int>(base + cc);
#pragma unroll
      for (int q = 0; q < TQ; ++q) bin_insert<D>(v[q], ix[q], bnd[q], acc[q], col);
    }
  }
  __syncthreads();  // the tile buffer is reused below

  // ---- extraction phase: sv[TQ][D*128], si[TQ][D*128], sb[TQ][128]
  constexpr int S = D * kBins;
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + TQ * S);
  float* sb = reinterpret_cast<float*>(si + TQ * S);
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      sv[q * S + l * kBins + t] = v[q][l];
      si[q * S + l * kBins + t] = ix[q][l];
    }
    sb[q * kBins + t] = bnd[q];
  }
  __syncthreads();

  const int warp = t / 32;
  const int lane = t % 32;
  constexpr int PER_LANE = S / 32;  // lane owns slots lane + 32*i
  for (int q = warp; q < TQ; q += kBins / 32) {
    const int64_t qg = q0 + q;
    if (qg >= b) break;
    float mine[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) mine[i] = sv[q * S + lane + 32 * i];
    unsigned taken = 0;
    for (int r = 0; r < topc; ++r) {
      float bv = -INFINITY;
      int bs = 0x7fffffff;  // "none": ranks after every real slot
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int slot = lane + 32 * i;
        if (!(taken >> i & 1u) && ranks_before(mine[i], slot, bv, bs)) {
          bv = mine[i];
          bs = slot;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov2 = __shfl_xor_sync(0xffffffffu, bv, off);
        const int os2 = __shfl_xor_sync(0xffffffffu, bs, off);
        if (ranks_before(ov2, os2, bv, bs)) {
          bv = ov2;
          bs = os2;
        }
      }
      if ((bs & 31) == lane) taken |= 1u << (bs >> 5);
      if (lane == 0) {
        ov[qg * topc + r] = bv;
        oi[qg * topc + r] = si[q * S + bs];
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) m = fmaxf(m, sb[q * kBins + lane + 32 * i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) ob[qg] = m;
  }
}

template <int TQ, int D>
int launch(const void* q2, int64_t b, int f, const void* ft, int64_t ft_stride,
           int64_t np, int topc, void* ov, void* oi, void* ob,
           cudaStream_t stream) {
  int cpt = kTileBytes / (2 * f * kBins * 2);  // 128-column groups per tile
  if (cpt < 1) cpt = 1;
  const int tc = cpt * kBins;
  const size_t scan_bytes = sizeof(float) * 2 * f * TQ + 2ull * 2 * f * tc;
  const size_t extract_bytes =
      sizeof(float) * TQ * D * kBins * 2 + sizeof(float) * TQ * kBins;
  const size_t smem = scan_bytes > extract_bytes ? scan_bytes : extract_bytes;
  auto kernel = scan_v3_kernel<TQ, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (b + TQ - 1) / TQ;
  kernel<<<static_cast<unsigned>(blocks), kBins, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q2), b, f,
      static_cast<const __nv_bfloat16*>(ft), ft_stride, np, tc, topc,
      static_cast<float*>(ov), static_cast<int32_t*>(oi),
      static_cast<float*>(ob));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q2 (b, 4f) bf16; ft (>= 2f rows, row stride ft_stride) bf16 with np
// columns (a multiple of 128); out ov (b, topc) f32, oi (b, topc) i32,
// ob (b,) f32.  Returns cudaGetLastError().
extern "C" int srt_scan_v3(const void* q2, int64_t b, int f, const void* ft,
                           int64_t ft_stride, int64_t np, int depth, int topc,
                           void* ov, void* oi, void* ob, void* stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int TQ = 16;
  switch (depth) {
    case 1: return launch<TQ, 1>(q2, b, f, ft, ft_stride, np, topc, ov, oi, ob, s);
    case 2: return launch<TQ, 2>(q2, b, f, ft, ft_stride, np, topc, ov, oi, ob, s);
    case 3: return launch<TQ, 3>(q2, b, f, ft, ft_stride, np, topc, ov, oi, ob, s);
    case 4: return launch<TQ, 4>(q2, b, f, ft, ft_stride, np, topc, ov, oi, ob, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
