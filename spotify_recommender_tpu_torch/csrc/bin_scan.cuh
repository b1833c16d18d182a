// The bin scan shared by kernel 1 (v3, csrc/scan_v3.cu), kernel 4 (v2,
// csrc/scan_v2.cu) and the prototype scans of csrc/proto_scans.cu.
//
// What it computes, for every query q of a batch against a transposed
// (rows, Np) bf16 catalog:
//
//   dot(q, col), by the contraction policy C:
//     SplitPlanes  sum_f qh*hi + ql*lo + ql*hi + qh*lo   (4F fp32 FMAs of
//                  exact bf16 x bf16 products, in a fixed order; kernels 1
//                  and 4)
//     Plain        sum_r q[r] * ft[r], r = 0 .. qw-1     (qw FMAs in
//                  ascending row order; the prototypes' `dot_general`)
//   score, by the epilogue kind E:
//     kNone          dot                                 (v3, scan_d1)
//     kGuardClipMask qn*cn > eps ? clamp(dot, -1, 1) : 0, then -inf where
//                    col >= valid or col == excl  (v2, proto_scan, scan3)
//   bin(col)    = col mod W
//   each bin keeps its top-D (value, column) with strict `>`, so the lowest
//   column wins ties, plus the largest value evicted past D (the (D+1)-th
//   best: the coverage bound);
//   out, compact (topc > 0): the top-`topc` of the D*W slots (slot =
//   level*W + bin) by value descending, slot ascending, and the max bound
//   over the bins;
//   out, full (topc = 0): the (D*W) slot values and columns and the (W)
//   per-bin bounds; with a catalog split (slice > 0) one such structure per
//   slice of `slice` columns, for a merge kernel to fold.
//
// This reproduces the TPU kernels' candidate structures exactly: their bin
// of a global column is `col mod W` because W divides the catalog tile
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:947-950, :1171-1174).
// The BF16X2_EPS derivation (48 rounded fp32 additions, Cauchy-Schwarz)
// holds for any order of the additions, and each FMA here rounds once after
// an exact product, so the certificate's bound carries over.
//
// Catalog layout: the TPU's transposed (rows, Np) bf16 planes.  SplitPlanes
// reads rows [0, 2F) = [hi; lo] (a 4-plane [hi; lo; hi; lo] layout works
// unchanged) against (B, 4F) queries [qh, ql, ql, qh], of which it reads
// [qh, ql].  Plain reads rows [0, qw) against (B, qw) queries.
//
// What bounds it on an H100: fp32 FMA issue.  B x Np x 4F FMAs (1024 x 1M x
// 48 = 50 G FMAs at the benchmark shape) against 48 bytes of catalog per
// column streamed once per block.  Design, right before fast:
//
// - a block has W threads; thread t owns bin t and walks its columns t,
//   t+W, ... in ascending order, so the strict-`>` insert keeps the lowest
//   column, as the TPU's sequential grid does.  W is a template parameter
//   (every multiple of 128 up to 1024): with W read from blockDim.x the
//   W = 128 scan took 22.1 ms instead of 15.4 ms at 1024 x 1M (NVIDIA H100
//   80GB HBM3, 700 W; PERF.md);
// - a block takes a tile of TQ queries, and per query the thread keeps D
//   (value, column) pairs and the bound in registers.  The register file
//   (65,536 per SM) bounds TQ * W: TQ = 16 up to W = 256, 8 up to 512, 4 up
//   to 1024;
// - catalog tiles of rows x tc bf16 (tc a multiple of W) are staged once per
//   block through shared memory with 16-byte copies; the query tile sits in
//   shared memory transposed, so one row's TQ values are read as float4
//   broadcasts;
// - at the end the block writes its bin structure to shared memory and each
//   warp extracts the top-topc of its queries by warp-wide argmax rounds
//   (value descending, slot ascending), as the TPU's masked-argmax rounds
//   do; a picked slot is knocked out as NaN, which never ranks.
//
// Known limit: without a split, one block per query tile walks the whole
// catalog, so B = 1 costs what B = TQ costs.  The split (blockIdx.y a
// catalog slice, full structures per slice) is merged so far only at depth
// 1 (proto_scans.cu, `d1_merge`); kernels 1 and 4 keep the single walk.
// Tensor cores (wgmma) are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace bin_scan {

constexpr int kMaxBins = 1024;       // W: one bin per thread
constexpr int kTileBytes = 24576;    // shared-memory budget of a catalog tile
// dynamic shared memory of a block on an H100 (232,448 bytes) less room
// for the kernel's static arrays
constexpr int kMaxSmem = 232448 - 1024;

// queries per block for W bins
__host__ __device__ constexpr int queries_per_block(int w) {
  return w <= 256 ? 16 : (w <= 512 ? 8 : 4);
}

// ---- contraction policies: which catalog rows a query meets, and how.
// `f` is the width argument of the call: F for SplitPlanes, qw for Plain.
// The staged query tile is qs[r * TQ + q], fp32, for r < rows(f).

struct SplitPlanes {
  __host__ __device__ static int rows(int f) { return 2 * f; }
  __host__ __device__ static int64_t q_stride(int f) { return 4 * f; }
  template <int TQ>
  __device__ static void dot(const float* qs, const __nv_bfloat16* tile,
                             int tc, int cc, int f, float (&acc)[TQ]) {
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
  }
};

struct Plain {
  __host__ __device__ static int rows(int f) { return f; }
  __host__ __device__ static int64_t q_stride(int f) { return f; }
  template <int TQ>
  __device__ static void dot(const float* qs, const __nv_bfloat16* tile,
                             int tc, int cc, int f, float (&acc)[TQ]) {
    for (int r = 0; r < f; ++r) {
      const float x = __bfloat162float(tile[r * tc + cc]);
      const float4* q4p = reinterpret_cast<const float4*>(qs + r * TQ);
#pragma unroll
      for (int q4 = 0; q4 < TQ / 4; ++q4) {
        const float4 a = q4p[q4];
        acc[4 * q4 + 0] = fmaf(a.x, x, acc[4 * q4 + 0]);
        acc[4 * q4 + 1] = fmaf(a.y, x, acc[4 * q4 + 1]);
        acc[4 * q4 + 2] = fmaf(a.z, x, acc[4 * q4 + 2]);
        acc[4 * q4 + 3] = fmaf(a.w, x, acc[4 * q4 + 3]);
      }
    }
  }
};

// The query tile of queries q0 .. q0+TQ-1 into qs, transposed; rows past b
// are zeros.
template <int NT, int TQ, class C>
__device__ __forceinline__ void load_queries(float* qs,
                                             const __nv_bfloat16* q,
                                             int64_t b, int64_t q0, int f,
                                             int t) {
  const int rows = C::rows(f);
  const int64_t stride = C::q_stride(f);
  for (int i = t; i < rows * TQ; i += NT) {
    const int j = i / TQ;
    const int qq = i % TQ;
    qs[i] = (q0 + qq < b) ? __bfloat162float(q[(q0 + qq) * stride + j])
                          : 0.0f;
  }
}

// Catalog columns [base, base + cols) of `rows` rows into tile[rows][tc]
// with 16-byte copies (cols a multiple of 8, rows 16-byte aligned).
template <int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* ft,
                                          int64_t ft_stride, int64_t base,
                                          int rows, int cols, int tc, int t) {
  const int vec_per_row = cols / 8;  // 8 bf16 per 16-byte copy
  for (int i = t; i < rows * vec_per_row; i += NT) {
    const int r = i / vec_per_row;
    const int c = i % vec_per_row;
    reinterpret_cast<uint4*>(tile + static_cast<int64_t>(r) * tc)[c] =
        reinterpret_cast<const uint4*>(ft + r * ft_stride + base)[c];
  }
}

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
// ascending.  NaN never ranks before anything.
__device__ __forceinline__ bool ranks_before(float av, int as, float bv,
                                             int bs) {
  return av > bv || (av == bv && as < bs);
}

enum class Epi { kNone, kGuardClipMask };

// The epilogue's inputs; kNone reads none.
struct Epilogue {
  const float* qn;      // (b,) raw query norms
  const float* cn;      // (np,) raw catalog norms, zero on pad columns
  const int64_t* excl;  // (b,) excluded column, -1 = none
  int64_t valid;        // columns >= valid are padding
  float eps;
};

// The arguments of one call, as the C entry points receive them.
struct Args {
  const void* q2;       // the queries (SplitPlanes: (b, 4f); Plain: (b, f))
  int64_t b;
  int f;                // the policy's width: F, or qw
  const void* ft;
  int64_t ft_stride, np;
  int topc;
  Epilogue epi;
  void* ov;
  void* oi;
  void* ob;
  int64_t slice = 0;    // > 0: columns per catalog slice (full output only)
};

template <int W, int D, Epi E, class C>
__global__ void __launch_bounds__(W)
    bin_scan_kernel(const __nv_bfloat16* __restrict__ q2, int64_t b, int f,
                    const __nv_bfloat16* __restrict__ ft, int64_t ft_stride,
                    int64_t np, int tc, int64_t slice, int topc,
                    Epilogue epi, float* __restrict__ ov,
                    int32_t* __restrict__ oi, float* __restrict__ ob) {
  constexpr int TQ = queries_per_block(W);
  constexpr int w = W;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sqn[TQ];
  __shared__ int64_t sex[TQ];
  const int t = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * TQ;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * slice;
  const int64_t c1 = np - c0 < slice ? np : c0 + slice;
  const int rows = C::rows(f);

  // ---- scan phase: qs[rows][TQ] fp32, tile[rows][tc]
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(qs + rows * TQ);
  load_queries<W, TQ, C>(qs, q2, b, q0, f, t);
  if (E != Epi::kNone && t < TQ) {
    const bool in = q0 + t < b;
    sqn[t] = in ? epi.qn[q0 + t] : 0.0f;
    sex[t] = in ? epi.excl[q0 + t] : -1;
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

  for (int64_t base = c0; base < c1; base += tc) {
    const int cols = static_cast<int>(c1 - base < tc ? c1 - base : tc);
    __syncthreads();  // the previous tile is consumed; qs is written
    load_tile<W>(tile, ft, ft_stride, base, rows, cols, tc, t);
    __syncthreads();
    for (int cc = t; cc < cols; cc += w) {
      float acc[TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) acc[q] = 0.0f;
      C::template dot<TQ>(qs, tile, tc, cc, f, acc);
      const int col = static_cast<int>(base + cc);
      if (E != Epi::kNone) {
        // the cosine epilogue on the raw norms, then the masks
        // (fused_topk.py:922-929)
        const float cnorm = epi.cn[col];
        const bool pad = col >= epi.valid;
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
          const float den = __fmul_rn(sqn[q], cnorm);
          const float s =
              den > epi.eps ? fminf(fmaxf(acc[q], -1.0f), 1.0f) : 0.0f;
          acc[q] = (pad || col == sex[q]) ? -INFINITY : s;
        }
      }
#pragma unroll
      for (int q = 0; q < TQ; ++q) bin_insert<D>(v[q], ix[q], bnd[q], acc[q], col);
    }
  }

  constexpr int S = D * w;
  if (topc == 0) {
    // full structures straight to global memory: slot = level*W + bin,
    // one structure per catalog slice
    const int64_t row0 = static_cast<int64_t>(blockIdx.y) * b + q0;
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      if (q0 + q >= b) break;
      const int64_t qg = row0 + q;
#pragma unroll
      for (int l = 0; l < D; ++l) {
        ov[qg * S + l * w + t] = v[q][l];
        oi[qg * S + l * w + t] = ix[q][l];
      }
      ob[qg * w + t] = bnd[q];
    }
    return;
  }
  __syncthreads();  // the tile buffer is reused below

  // ---- extraction phase: sv[TQ][D*W], si[TQ][D*W], sb[TQ][W]
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + TQ * S);
  float* sb = reinterpret_cast<float*>(si + TQ * S);
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
#pragma unroll
    for (int l = 0; l < D; ++l) {
      sv[q * S + l * w + t] = v[q][l];
      si[q * S + l * w + t] = ix[q][l];
    }
    sb[q * w + t] = bnd[q];
  }
  __syncthreads();

  const int warp = t / 32;
  const int lane = t % 32;
  for (int q = warp; q < TQ; q += w / 32) {
    const int64_t qg = q0 + q;
    if (qg >= b) break;
    float* row = sv + q * S;
    for (int r = 0; r < topc; ++r) {
      float bv = -INFINITY;
      int bs = INT_MAX;  // "none": ranks after every real slot
      for (int slot = lane; slot < S; slot += 32) {
        if (ranks_before(row[slot], slot, bv, bs)) {
          bv = row[slot];
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
      if (lane == 0) {
        ov[qg * topc + r] = bv;
        oi[qg * topc + r] = si[q * S + bs];
        row[bs] = NAN;  // taken: never ranks again
      }
      __syncwarp();
    }
    float m = -INFINITY;
    for (int i = lane; i < w; i += 32) m = fmaxf(m, sb[q * w + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) ob[qg] = m;
  }
}

// W-column groups per catalog tile: the tile budget, at least one group.
// The shared memory is sized from the real tile (at qw = 48 and W = 512 one
// group is 49,152 bytes, twice the budget).
inline int tile_cols(int rows, int w) {
  const int groups = kTileBytes / (rows * w * 2);
  return (groups < 1 ? 1 : groups) * w;
}

template <int W, int D, Epi E, class C>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int TQ = queries_per_block(W);
  const int rows = C::rows(a.f);
  const int tc = tile_cols(rows, W);
  const size_t scan_bytes = sizeof(float) * rows * TQ + 2ull * rows * tc;
  const size_t extract_bytes =
      a.topc ? sizeof(float) * TQ * D * W * 2 + sizeof(float) * TQ * W : 0;
  const size_t smem = scan_bytes > extract_bytes ? scan_bytes : extract_bytes;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bin_scan_kernel<W, D, E, C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t slice = a.slice > 0 ? a.slice : (a.np > 0 ? a.np : 1);
  const int64_t slices = a.np > slice ? (a.np + slice - 1) / slice : 1;
  const int64_t blocks = (a.b + TQ - 1) / TQ;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(slices));
  kernel<<<grid, W, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q2), a.b, a.f,
      static_cast<const __nv_bfloat16*>(a.ft), a.ft_stride, a.np, tc, slice,
      a.topc, a.epi, static_cast<float*>(a.ov), static_cast<int32_t*>(a.oi),
      static_cast<float*>(a.ob));
  return static_cast<int>(cudaGetLastError());
}

// W bins: a multiple of 128, at most kMaxBins, dividing np (and a slice).
inline bool args_ok(const Args& a, int w, int d) {
  return w >= 128 && w <= kMaxBins && w % 128 == 0 && a.np % w == 0 &&
         a.f >= 1 && a.topc >= 0 && a.topc <= d * w && a.np < INT_MAX &&
         a.slice >= 0 && a.slice % w == 0 &&
         (a.slice == 0 ||
          (a.topc == 0 && (a.np + a.slice - 1) / a.slice <= 65535));
}

template <int D, Epi E, class C>
int dispatch_w(const Args& a, int w, cudaStream_t s) {
  if (a.b == 0) return static_cast<int>(cudaGetLastError());
  if (!args_ok(a, w, D)) return static_cast<int>(cudaErrorInvalidValue);
  switch (w / 128) {
    case 1: return launch<128, D, E, C>(a, s);
    case 2: return launch<256, D, E, C>(a, s);
    case 3: return launch<384, D, E, C>(a, s);
    case 4: return launch<512, D, E, C>(a, s);
    case 5: return launch<640, D, E, C>(a, s);
    case 6: return launch<768, D, E, C>(a, s);
    case 7: return launch<896, D, E, C>(a, s);
    default: return launch<1024, D, E, C>(a, s);
  }
}

}  // namespace bin_scan
